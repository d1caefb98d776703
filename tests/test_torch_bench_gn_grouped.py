"""The K8 / G timing script (`scripts/bench_gn_grouped.py`): its site tables
are the model's (the launch plans `chip_smoke.py` holds the card to), its
cases cover every site with the launch counter it moves on the card, and
it refuses to time without a GPU. On the CPU the wrappers take
their plain versions, at tiny sizes here."""

import importlib.util
import os

import pytest
import torch

from magicdance_tpu_torch.ops import kernels as K
from magicdance_tpu_torch.scripts import bench_gn_grouped as B

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_bench",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_site_tables_are_the_models():
    from magicdance_tpu_torch.config import ModelConfig

    cs = _chip_smoke()
    # the 16-frame image request: 16 pose maps at 512x512 (a 64x64 latent)
    assert {**B.GN_SITES, **B.GN_SMALL_SITES} == cs.gn_plan_by_shape(ModelConfig(), 64, 16)
    assert sum(B.GN_SITES.values()) == 156 and sum(B.GN_SMALL_SITES.values()) == 54
    assert all(hw >= 256 for _, hw, _, _ in B.GN_SITES)
    assert all(hw == 64 for _, hw, _, _ in B.GN_SMALL_SITES)
    plan = cs.serving_launch_plan(ModelConfig(), 64, 16, 1)
    assert plan["groupnorm_silu"] == 2 * 210
    assert B.GROUPED_SITES == {(n, s, h, d): per_step
                               for n, s, h, d, per_step, _ in cs.grouped_shapes()}
    # the video request's K8 sites (its motion modules' norms included) have
    # the image request's shapes at B = 16
    video_gn = {site[1:] for site in cs.pass_sites(cs.temporal_model_config().unet, 64)
                if site[0] in ("gn", "norm") and site[1] >= 256}
    assert video_gn == {(hw, c) for b, hw, c, _ in B.GN_SITES if b == 16}


def test_backward_sites_are_the_stage3_steps():
    """G's backward sites: every motion shape at its launches per stage-3
    training step, which sum to the stage-3 launch plan's count."""
    from magicdance_tpu_torch import config as C

    cs = _chip_smoke()
    assert B.GROUPED_BWD_SITES == {(n, s, h, d): per_train
                                   for n, s, h, d, _, per_train in cs.grouped_shapes()}
    cfg = C.stage3_motion()
    plan = cs.stage3_launch_plan(cfg, cfg.image_size, cfg.batch_size_per_device)
    assert sum(B.GROUPED_BWD_SITES.values()) == plan["grouped_bwd"] == 40


def test_cases_cover_every_site(monkeypatch):
    monkeypatch.setattr(B, "GN_SITES", {(1, 16, 64, "silu"): 2, (2, 16, 32, None): 3})
    monkeypatch.setattr(B, "GN_SMALL_SITES", {(3, 4, 64, "silu"): 5})
    monkeypatch.setattr(B, "GROUPED_SITES", {(8, 16, 2, 8): 20, (32, 4, 2, 16): 20})
    monkeypatch.setattr(B, "GROUPED_BWD_SITES", {(8, 16, 2, 8): 10})
    seen = []
    K.reset_launches()
    with torch.no_grad():
        for label, group, counter, launches, per_step, fn in B.cases(torch.device("cpu")):
            assert counter is None or counter in K.LAUNCHES
            out = fn()
            for t in out if isinstance(out, tuple) else (out,):
                assert t.dtype == torch.bfloat16 and torch.isfinite(t.float()).all()
            seen.append((label.split(" (")[0], label.split("= ")[1], group, counter, launches,
                         per_step))
    k8, big, small = "groupnorm_silu", "H*W >= 256", "8x8"
    assert seen == [("K8", "(1, 16, 64) silu", big, k8, 2, 2),
                    ("plain", "(1, 16, 64) silu", big, None, 0, 2),
                    ("K8", "(2, 16, 32) None", big, k8, 2, 3),
                    ("plain", "(2, 16, 32) None", big, None, 0, 3),
                    ("K8", "(3, 4, 64) silu", small, k8, 2, 5),
                    ("plain", "(3, 4, 64) silu", small, None, 0, 5),
                    ("K8 + conv", "(3, 4, 64) silu", small, k8, 2, 5),
                    ("plain + conv", "(3, 4, 64) silu", small, None, 0, 5),
                    ("G forward", "(8, 16, 8)", "video step", "grouped", 1, 20),
                    ("G forward", "(32, 4, 16)", "video step", "grouped", 1, 20),
                    ("G backward", "(8, 16, 8)", "stage-3 step", "grouped_bwd", 1, 10)]
    # the CPU takes the plain versions: no kernel launched
    assert not any(K.LAUNCHES.values())


def test_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        B.main([])

