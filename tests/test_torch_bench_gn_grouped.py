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
    # the fused-GN image request: 2 pose maps at 512x512 (a 64x64 latent)
    assert B.GN_SITES == cs.gn_plan_by_shape(ModelConfig(), 64, 2)
    assert sum(B.GN_SITES.values()) == 105
    assert B.GROUPED_SITES == {(n, s, h, d): per_step
                               for n, s, h, d, per_step, _ in cs.grouped_shapes()}
    video_gn = {site[1:] for site in cs.pass_sites(cs.temporal_model_config().unet, 64)
                if site[0] == "gn"}
    for b, hw, c in B.GN_VIDEO_SITES:
        assert b == 16 and (hw, c) in video_gn


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
    monkeypatch.setattr(B, "GN_SITES", {(1, 16, 64): 2, (2, 8, 32): 3})
    monkeypatch.setattr(B, "GN_VIDEO_SITES", ((3, 16, 64),))
    monkeypatch.setattr(B, "GROUPED_SITES", {(8, 16, 2, 8): 20, (32, 4, 2, 16): 20})
    monkeypatch.setattr(B, "GROUPED_BWD_SITES", {(8, 16, 2, 8): 10})
    seen = []
    K.reset_launches()
    for label, counter, per_step, fn in B.cases(torch.device("cpu")):
        assert counter in K.LAUNCHES
        out = fn()
        for t in out if isinstance(out, tuple) else (out,):
            assert t.dtype == torch.bfloat16 and torch.isfinite(t.float()).all()
        seen.append((label.split(" (")[0], label.split("= ")[1], counter, per_step))
    assert seen == [("K8", "(1, 16, 64)", "groupnorm_silu", 2),
                    ("K8", "(2, 8, 32)", "groupnorm_silu", 3),
                    ("K8", "(3, 16, 64)", "groupnorm_silu", 0),
                    ("G forward", "(8, 16, 8)", "grouped", 20),
                    ("G forward", "(32, 4, 16)", "grouped", 20),
                    ("G backward", "(8, 16, 8)", "grouped_bwd", 10)]
    # the CPU takes the plain versions: no kernel launched
    assert not any(K.LAUNCHES.values())


def test_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        B.main([])

