"""PyTorch port of the video metrics against the JAX package, on the CPU.

The FVD backbone (I3D at width 0.25, 10 classes) and the FID-VID backbone
(3D-ResNet50 with one block per stage at width 0.25), as tests/test_i3d.py
sizes them: state dicts from the torch oracles of tests/torch_ref.py (a
second oracle here), each loaded into the port through its `convert_*` and
through `convert.from_jax` from the JAX converter's Flax tree; then FVD and
FID-VID through both packages' score drivers on a seeded frame tree, with
the same narrow backbones substituted in both packages.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from magicdance_tpu.metrics import center as jcenter
from magicdance_tpu.metrics import fvd as jfvd
from magicdance_tpu.metrics import i3d_flax as ji3d
from magicdance_tpu.metrics import resnet3d_flax as jr3d
from magicdance_tpu_torch.convert.from_jax import load_flax_params
from magicdance_tpu_torch.metrics import center as tcenter
from magicdance_tpu_torch.metrics import fvd as tfvd
from magicdance_tpu_torch.metrics.i3d import I3D, convert_i3d, same_pads
from magicdance_tpu_torch.metrics.resnet3d import KINETICS_PIXEL_MEAN, ResNet3D, convert_resnet3d
from torch_port_util import (  # noqa: F401
    assert_net_close,
    np_rand,
    save_state,
    to_t,
    torch_single_thread,
    write_frame_tree,
)
from torch_ref import TorchI3D, TorchResNet3D

I3D_TINY = dict(num_classes=10, width=0.25)
R3D_TINY = dict(layers=(1, 1, 1, 1), width=0.25)


def _seeded(m: torch.nn.Module, seed: int) -> torch.nn.Module:
    """He-scaled conv weights (torch's default init lets the activations
    fade through the deep nets, and every video then gets the same
    features) and BatchNorm running stats away from the identity."""
    gen = torch.Generator().manual_seed(seed)
    for mod in m.modules():
        if isinstance(mod, torch.nn.Conv3d):
            fan_in = mod.weight[0].numel()
            mod.weight.data.copy_(torch.randn(mod.weight.shape, generator=gen)
                                  * (2.0 / fan_in) ** 0.5)
        if isinstance(mod, torch.nn.BatchNorm3d):
            mod.running_mean.copy_(torch.randn(mod.running_mean.shape, generator=gen) * 0.5)
            mod.running_var.copy_(torch.rand(mod.running_var.shape, generator=gen) + 0.5)
            mod.weight.data.copy_(1 + 0.1 * torch.randn(mod.weight.shape, generator=gen))
            mod.bias.data.copy_(0.1 * torch.randn(mod.bias.shape, generator=gen))
    return m.eval()


def i3d_oracle(seed: int = 0) -> TorchI3D:
    torch.manual_seed(seed)
    return _seeded(TorchI3D(**I3D_TINY), seed)


def r3d_oracle(seed: int = 0) -> TorchResNet3D:
    torch.manual_seed(seed)
    return _seeded(TorchResNet3D(**R3D_TINY), seed)


def _numpy_state(m: torch.nn.Module, prefix: str = "") -> dict:
    return {prefix + k: v.detach().numpy().copy() for k, v in m.state_dict().items()}


def _i3d_case():
    oracle = i3d_oracle(0)
    sd = _numpy_state(oracle)
    tree = ji3d.convert_i3d(sd)
    # H = 57 and T = 9 make XLA's SAME padding asymmetric at the strided layers
    x = np_rand((2, 9, 57, 56, 3), 1, -1.0, 1.0)
    want = np.asarray(jax.jit(ji3d.I3D(**I3D_TINY).apply)({"params": tree}, x))
    with torch.no_grad():
        oracle_out = oracle(to_t(x).permute(0, 4, 1, 2, 3)).numpy()
    return dict(sd=sd, tree=tree, make=functools.partial(I3D, **I3D_TINY), convert=convert_i3d,
                x=x, want=want, oracle=oracle_out)


def _r3d_case():
    oracle = r3d_oracle(1)
    sd = _numpy_state(oracle, prefix="module.")  # the checkpoint's DataParallel prefix
    tree = jr3d.convert_resnet3d(sd, layers=R3D_TINY["layers"])
    x = (np_rand((2, 16, 64, 64, 3), 2, 0.0, 255.0)
         - np.asarray(KINETICS_PIXEL_MEAN, np.float32))
    want = np.asarray(jax.jit(jr3d.ResNet3D(**R3D_TINY).apply)({"params": tree}, x))
    with torch.no_grad():
        oracle_out = oracle(to_t(x).permute(0, 4, 1, 2, 3)).numpy()
    return dict(sd=sd, tree=tree, make=functools.partial(ResNet3D, **R3D_TINY),
                convert=functools.partial(convert_resnet3d, layers=R3D_TINY["layers"]),
                x=x, want=want, oracle=oracle_out)


CASES = {"i3d": _i3d_case, "resnet3d": _r3d_case}


@pytest.fixture(scope="module")
def net_cases():
    return {}


def _case(net_cases, net):
    if net not in net_cases:
        net_cases[net] = CASES[net]()
    return net_cases[net]


@pytest.mark.parametrize("route", ["convert", "from_jax"])
@pytest.mark.parametrize("net", sorted(CASES))
def test_net_matches_jax(net_cases, net, route):
    """fp32 outputs within 2e-4 x max(1, max|JAX|) of the JAX net, loaded
    through `convert_*` from the reference state dict or through
    `from_jax` (Conv3d DHWIO -> OIDHW, BatchNorm mean/var -> running stats)
    from the JAX converter's tree; strict loads."""
    case = _case(net_cases, net)
    m = case["make"]()
    if route == "convert":
        m.load_state_dict(case["convert"](case["sd"]), strict=True)
    else:
        load_flax_params(m, {"params": case["tree"]})
    with torch.no_grad():
        got = m.eval()(to_t(case["x"]))
    assert_net_close(got, case["want"])


@pytest.mark.parametrize("net", sorted(CASES))
def test_net_matches_torch_oracle(net_cases, net):
    """The port against the reference-layout torch oracle on the same input,
    within 2e-4 x max(1, max|oracle|)."""
    case = _case(net_cases, net)
    m = case["make"]()
    m.load_state_dict(case["convert"](case["sd"]), strict=True)
    with torch.no_grad():
        got = m.eval()(to_t(case["x"]))
    assert_net_close(got, case["oracle"])


@pytest.mark.parametrize("n,k,s", [(56, 7, 2), (57, 7, 2), (9, 7, 2), (28, 3, 2), (7, 2, 2),
                                   (14, 3, 1), (5, 1, 1)])
def test_same_pads_are_xla_same(n, k, s):
    """The explicit padding reproduces XLA's SAME output length and its
    low = total // 2 split, checked against jax.lax's own padding."""
    from jax import lax

    (lo, hi), = lax.padtype_to_pads((n,), (k,), (s,), "SAME")
    assert same_pads((n,), (k,), (s,)) == (lo, hi)
    assert (n + lo + hi - k) // s + 1 == -(-n // s)


def test_segment_clips_and_frames_match_jax(tmp_path):
    from PIL import Image

    v = np.arange(18)[:, None, None, None] * np.ones((1, 4, 4, 3), np.uint8)
    for a, b in zip(tfvd.segment_clips(v, 16), jfvd.segment_clips(v, 16)):
        np.testing.assert_array_equal(a, b)
    rs = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray(rs.randint(0, 255, (20, 30, 3)).astype(np.uint8)).save(
            tmp_path / f"{i:02d}.png")
    np.testing.assert_array_equal(tfvd.load_video_frames(str(tmp_path), 16),
                                  jfvd.load_video_frames(str(tmp_path), 16))


def test_unreadable_backbone_names_both_causes(tmp_path):
    bad = tmp_path / "bad.pt"
    bad.write_bytes(b"not a checkpoint")
    with pytest.raises(ValueError, match="state-dict path failed.*TorchScript path failed"):
        tfvd.VideoFeatureExtractor(str(bad), device="cpu")


# --------------------------------------------------------------------------
# FVD and FID-VID through the score drivers
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def video_scores(tmp_path_factory):
    """Two 4-frame sequences at 32x32 (resized to 224 for I3D, 112 for the
    3D-ResNet), oracle weight files (the 3D-ResNet's in a {"state_dict":
    {"module.*"}} container), and both packages' FVD and FID-VID with the
    narrow backbones in place of the Kinetics-width ones."""
    root = tmp_path_factory.mktemp("tree")
    write_frame_tree(root, seqs=2, frames=4, size=32, seed=11, shift_from=2)
    wdir = tmp_path_factory.mktemp("weights")
    i3d_path = save_state(_numpy_state(i3d_oracle(3)), wdir / "i3d.pt")
    r3d_path = str(wdir / "r3d.pth")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in
                               _numpy_state(r3d_oracle(4), "module.").items()}}, r3d_path)
    weights = dict(i3d_weights=i3d_path, resnet3d_weights=r3d_path)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(ji3d, "I3D", functools.partial(ji3d.I3D, **I3D_TINY))
        mp.setattr(jr3d, "ResNet3D", functools.partial(jr3d.ResNet3D, **R3D_TINY))
        mp.setattr(jr3d, "convert_resnet3d",
                   functools.partial(jr3d.convert_resnet3d, layers=R3D_TINY["layers"]))
        mp.setattr(tfvd, "I3D", functools.partial(I3D, **I3D_TINY))
        mp.setattr(tfvd, "ResNet3D", functools.partial(ResNet3D, **R3D_TINY))
        mp.setattr(tfvd, "convert_resnet3d",
                   functools.partial(convert_resnet3d, layers=R3D_TINY["layers"]))
        want = jcenter.get_all_eval_scores(str(root), ["fvd", "fid-vid"], **weights)
        got = tcenter.get_all_eval_scores(str(root), ["fvd", "fid-vid"], device="cpu",
                                          **weights)
        feats = {b: tfvd.VideoFeatureExtractor(weights[w], device="cpu")(
                     [tfvd.load_video_frames(str(root / f"seq{s}" / "gen_images"),
                                             112 if b == "r3d" else 224) for s in range(2)])
                 for b, w in (("i3d", "i3d_weights"), ("r3d", "resnet3d_weights"))}
    finally:
        mp.undo()
    return want, got, feats


def test_video_scores_match_jax(video_scores):
    """FVD and FID-VID within 1e-3 relative of JAX, from features that differ
    from video to video."""
    want, got, feats = video_scores
    assert sorted(got) == sorted(want) == ["fid-vid", "fvd", "num_images"]
    for k in ("fvd", "fid-vid"):
        assert np.isfinite(got[k]) and got[k] > 0
        assert got[k] == pytest.approx(want[k], rel=1e-3), k
    assert feats["i3d"].shape == (2, 10) and feats["r3d"].shape == (2, 512)
    for f in feats.values():
        assert float(f.std(axis=0).mean()) > 1e-3


def test_video_extractor_asks_for_the_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tfvd.VideoFeatureExtractor(str(tmp_path / "any.pt"))
