"""PyTorch port of the image metrics against the JAX package, on the CPU.

core (L1/MAE, PSNR, SSIM, Frechet distance, inception score), the metric nets
(LPIPS at 64x64, InceptionV3 at 75x75 -- the smallest input it takes --,
the CLIP vision tower at hidden 32), each loaded twice: through its
`convert_*` from one seeded reference-layout state dict, and through
`convert.from_jax` from the Flax tree the JAX converter makes of it; then
the score drivers (`metrics.center.get_all_eval_scores`, FID at 299 through
both packages' Inception once; the scores through a TorchScript extractor)
and the CLIP scorer on a seeded frame tree.
"""

from __future__ import annotations

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicdance_tpu.metrics import center as jcenter
from magicdance_tpu.metrics import clip_score as jclip
from magicdance_tpu.metrics import core as jcore
from magicdance_tpu.metrics.inception_flax import InceptionV3 as JInception
from magicdance_tpu.metrics.inception_flax import convert_inception_torchvision as jconv_inc
from magicdance_tpu.metrics.lpips import LPIPS as JLPIPS
from magicdance_tpu.metrics.lpips import convert_lpips_torch_state as jconv_lpips
from magicdance_tpu_torch.convert.from_jax import load_flax_params
from magicdance_tpu_torch.metrics import center as tcenter
from magicdance_tpu_torch.metrics import clip_score as tclip
from magicdance_tpu_torch.metrics import core as tcore
from magicdance_tpu_torch.metrics.inception import InceptionV3, convert_inception_torchvision
from magicdance_tpu_torch.metrics.lpips import LPIPS, convert_lpips_torch_state
from torch_port_util import (  # noqa: F401
    assert_net_close,
    clip_vision_state,
    inception_state,
    lpips_state,
    np_rand,
    save_state,
    to_t,
    torch_single_thread,
    write_frame_tree,
)

# --------------------------------------------------------------------------
# core
# --------------------------------------------------------------------------

A = np_rand((2, 32, 32, 3), 0, 0.0, 1.0)
B = np.clip(A + np_rand((2, 32, 32, 3), 1) * 0.05, 0, 1).astype(np.float32)


@pytest.mark.parametrize("name,channels,atol", [
    ("l1_error", 3, 1e-6), ("psnr", 3, 1e-4), ("ssim", 3, 1e-6), ("ssim", 1, 1e-6),
])
def test_core_matches_jax(name, channels, atol):
    """l1_error and ssim within 1e-6 abs of JAX, psnr within 1e-4 dB."""
    a, b = A[..., :channels], B[..., :channels]
    want = float(getattr(jcore, name)(jnp.asarray(a), jnp.asarray(b)))
    got = float(getattr(tcore, name)(to_t(a), to_t(b)))
    assert got == pytest.approx(want, abs=atol)


def test_frechet_and_inception_score_bit_equal():
    """The numpy/scipy statistics are copies (the port's sqrtm call drops
    JAX's `disp=False`, which SciPy 1.18 removed): bit-equal results."""
    rs = np.random.RandomState(3)
    f1, f2 = rs.randn(40, 6), rs.randn(40, 6) + 0.5
    stats = [tcore.gaussian_frechet_stats(f) for f in (f1, f2)]
    assert all(np.array_equal(x, y) for s, js in zip(
        stats, [jcore.gaussian_frechet_stats(f) for f in (f1, f2)]) for x, y in zip(s, js))
    assert tcore.frechet_distance(*stats[0], *stats[1]) == jcore.frechet_distance(
        *stats[0], *stats[1])
    logits = rs.randn(30, 12) * 3
    assert (tcore.inception_score_from_logits(logits, splits=3)
            == jcore.inception_score_from_logits(logits, splits=3))


def test_ssim_near_constant_stays_bounded():
    """Near-constant generated frames against structured ones (the case whose
    window statistics cancel): SSIM stays within [-1, 1], as in JAX."""
    rs = np.random.RandomState(0)
    gen = (0.5 + rs.rand(1, 64, 64, 1) * 0.02).astype(np.float32)
    gt = rs.rand(1, 64, 64, 1).astype(np.float32)
    v = float(tcore.ssim(to_t(gen), to_t(gt)))
    assert -1.0 <= v <= 1.0, v
    assert v == pytest.approx(float(jcore.ssim(jnp.asarray(gen), jnp.asarray(gt))), abs=1e-6)
    flat = np.full((1, 32, 32, 1), 0.3, np.float32)
    assert float(tcore.ssim(to_t(flat), to_t(flat + 1e-3))) <= 1.0


# --------------------------------------------------------------------------
# the nets: JAX output once per net, the port through both loaders
# --------------------------------------------------------------------------


def _lpips_case():
    sd = lpips_state(1)
    tree = jconv_lpips(sd)
    a, b = np_rand((2, 64, 64, 3), 2, -1.0, 1.0), np_rand((2, 64, 64, 3), 3, -1.0, 1.0)
    want = np.asarray(jax.jit(JLPIPS().apply)({"params": tree}, a, b))
    return dict(sd=sd, tree=tree, make=LPIPS, convert=convert_lpips_torch_state,
                run=lambda m: m(to_t(a), to_t(b)), want=want)


def _inception_case():
    sd = inception_state(2)
    tree = jconv_inc(sd)
    x = np_rand((2, 75, 75, 3), 4, -1.0, 1.0)
    pool, logits = jax.jit(JInception().apply)({"params": tree}, x)
    return dict(sd=sd, tree=tree, make=InceptionV3, convert=convert_inception_torchvision,
                run=lambda m: torch.cat(m(to_t(x)), dim=1),
                want=np.concatenate([np.asarray(pool), np.asarray(logits)], axis=1))


CLIP_TINY = dict(hidden_size=32, num_layers=2, num_heads=2, patch_size=14, projection_dim=16)


def _clip_case():
    sd = clip_vision_state(3, hidden=32, layers=2, patch=14, proj=16, image_size=28)
    tree = jclip.convert_clip_vision(sd)
    x = np_rand((3, 28, 28, 3), 5)
    want = np.asarray(jax.jit(jclip.CLIPVisionEncoder(**CLIP_TINY).apply)({"params": tree}, x))
    return dict(sd=sd, tree=tree,
                make=functools.partial(tclip.CLIPVisionEncoder, image_size=28, **CLIP_TINY),
                convert=tclip.convert_clip_vision, run=lambda m: m(to_t(x)), want=want)


CASES = {"lpips": _lpips_case, "inception": _inception_case, "clip_vision": _clip_case}


@pytest.fixture(scope="module")
def net_cases():
    return {}


@pytest.mark.parametrize("route", ["convert", "from_jax"])
@pytest.mark.parametrize("net", sorted(CASES))
def test_net_matches_jax(net_cases, net, route):
    """fp32 outputs within 2e-4 x max(1, max|JAX|) of the JAX net: loaded
    through the port's `convert_*` from the reference-layout state dict, or
    through `from_jax` from the JAX converter's Flax tree (strict loads)."""
    if net not in net_cases:
        net_cases[net] = CASES[net]()
    case = net_cases[net]
    m = case["make"]()
    if route == "convert":
        m.load_state_dict(case["convert"](case["sd"]), strict=True)
    else:
        load_flax_params(m, {"params": case["tree"]})
    with torch.no_grad():
        got = case["run"](m.eval())
    assert_net_close(got, case["want"])


def test_inception_features_are_not_degenerate(net_cases):
    """He-scaled weights keep the pooled features apart from image to image
    (a FID between near-equal features proves nothing)."""
    if "inception" not in net_cases:
        net_cases["inception"] = _inception_case()
    pool = net_cases["inception"]["want"][:, :2048]
    assert float(pool.std(axis=0).mean()) > 1e-3


def test_from_jax_2d_rules_unchanged():
    """The Conv3d and BatchNorm rules leave the 2-D ones as they were."""
    from magicdance_tpu_torch.convert.from_jax import convert_leaf

    rs = np.random.RandomState(0)
    k4, k2, k5 = rs.randn(3, 3, 4, 5), rs.randn(4, 6), rs.randn(2, 3, 3, 4, 5)
    assert convert_leaf(("c", "kernel"), k4)[0] == "c.weight"
    np.testing.assert_array_equal(convert_leaf(("c", "kernel"), k4)[1].numpy(),
                                  k4.transpose(3, 2, 0, 1).astype(np.float32))
    np.testing.assert_array_equal(convert_leaf(("d", "kernel"), k2)[1].numpy(),
                                  k2.T.astype(np.float32))
    np.testing.assert_array_equal(convert_leaf(("e", "kernel"), k5)[1].numpy(),
                                  k5.transpose(4, 3, 0, 1, 2).astype(np.float32))
    assert [convert_leaf(("n", leaf), np.ones(2))[0]
            for leaf in ("scale", "bias", "embedding", "mean", "var", "position_embedding")] == [
        "n.weight", "n.bias", "n.weight", "n.running_mean", "n.running_var",
        "n.position_embedding"]


# --------------------------------------------------------------------------
# the drivers on a seeded tree
#
# A Frechet distance over Inception's 2048-wide features costs one scipy
# sqrtm of a 2048 x 2048 matrix, 14-23 s on this CPU, per score: the score
# drivers are compared here through the other backend both packages take, a
# clean-fid-style TorchScript extractor (32-wide features, 10 logits); the
# port's InceptionV3 path through the same drivers is compared on its
# features and logits at 299 (one JAX compile, at (3, 299, 299, 3)).
# --------------------------------------------------------------------------

TYPES = ["l1", "mae", "ssim", "psnr", "lpips", "fid", "fid-img", "is"]


class ScriptedFeatures(torch.nn.Module):
    """A TorchScript feature net with the clean-fid call convention: 0-255
    NCHW input, `return_features=True` -> pooled features, else logits."""

    def __init__(self):
        super().__init__()
        self.c1 = torch.nn.Conv2d(3, 16, 8, stride=8)
        self.c2 = torch.nn.Conv2d(16, 32, 4, stride=4)
        self.fc = torch.nn.Linear(32, 10)

    def forward(self, x, return_features: bool = False):
        h = torch.relu(self.c2(torch.relu(self.c1(x)))).mean(dim=(2, 3))
        return h if return_features else self.fc(h)


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """Two sequences of 6 frames at 32x32 (generated frames 2-5 brighter;
    each ground truth a noisy copy of its generated frame's base; 12
    generated frames, so the inception score's 10 splits are not all single
    images), LPIPS,
    Inception and TorchScript weight files, and both packages' scores of
    every image type through the TorchScript extractor."""
    root = tmp_path_factory.mktemp("tree")
    write_frame_tree(root, seqs=2, frames=6, size=32, seed=5, shift_from=2)
    wdir = tmp_path_factory.mktemp("weights")
    torch.manual_seed(0)
    script = str(wdir / "features.pt")
    torch.jit.save(torch.jit.script(ScriptedFeatures().eval()), script)
    weights = dict(lpips_weights=save_state(lpips_state(6), wdir / "lpips.pth"),
                   inception_weights=script)
    want = jcenter.get_all_eval_scores(str(root), TYPES, **weights)
    got = tcenter.get_all_eval_scores(str(root), TYPES, device="cpu", **weights)
    inception = save_state(inception_state(7), wdir / "inception.pth")
    return root, weights, want, got, inception


def test_scores_match_jax(scored):
    """Same keys as JAX; FID and FID-Img within 1e-3 relative, every other
    value within 1e-5 relative."""
    _, _, want, got, _ = scored
    assert sorted(got) == sorted(want)
    assert got["num_images"] == want["num_images"] == 12
    assert want["is_mean"] > 1.0 and want["fid"] > 1.0
    for k, v in want.items():
        rel = 1e-3 if k.startswith("fid") else 1e-5
        assert got[k] == pytest.approx(v, rel=rel), k


def test_fid_img_sampling_on_the_port(scored):
    """What tests/test_inception.py::test_fid_img_sampling asserts, on the
    port with non-degenerate features: fid-img equals fid with all frames,
    and moves by more than 1e-3 when only the first 2 frames count."""
    from magicdance_tpu_torch.metrics.fid import folder_features

    root, weights, _, full, _ = scored
    feats = folder_features(str(root / "seq0" / "gen_images"), weights["inception_weights"],
                            device="cpu")
    assert float(feats.std(axis=0).mean()) > 1e-3
    assert full["fid-img"] == full["fid"]
    sampled = tcenter.get_all_eval_scores(str(root), ["fid-img"], sample_frames=2,
                                          device="cpu", **weights)
    assert np.isfinite(sampled["fid-img"])
    assert abs(sampled["fid-img"] - full["fid-img"]) > 1e-3


def test_inception_backend_at_299_matches_jax(scored, tmp_path):
    """fid.py's first backend, a torchvision-layout state dict through each
    package's own InceptionV3: features and logits of a folder of 3 frames
    (bicubic to 299) within 2e-4 x max(1, max|JAX|), and apart from image to
    image."""
    import shutil

    from magicdance_tpu.metrics import fid as jfid
    from magicdance_tpu_torch.metrics import fid as tfid

    root, _, _, _, inception = scored
    for name in ("000.png", "001.png", "002.png"):
        shutil.copy(root / "seq1" / "gen_images" / name, tmp_path / name)
    folder = str(tmp_path)
    want = jfid.folder_features(folder, inception)
    got = tfid.folder_features(folder, inception, device="cpu")
    assert got.shape == (3, 2048)
    assert_net_close(got, want)
    assert float(got.std(axis=0).mean()) > 1e-3
    assert tfid._get_backend(inception, torch.device("cpu"))[0] == "inception"
    assert_net_close(tfid.folder_logits(folder, inception, device="cpu"),
                     jfid.folder_logits(folder, inception))


def test_metrics_cli_writes_results(scored, tmp_path):
    """`python -m magicdance_tpu_torch.metrics.center` with --device cpu."""
    root, _, _, got, _ = scored
    out = tmp_path / "results.json"
    tcenter.main(["--root", str(root), "--type", "l1", "ssim", "psnr", "--device", "cpu",
                  "--out", str(out)])
    res = json.load(open(out))
    assert sorted(res) == ["l1", "num_images", "psnr", "ssim"]
    for k in ("l1", "ssim", "psnr"):
        assert res[k] == pytest.approx(got[k], rel=1e-12)


def test_clip_image_similarity_matches_jax(scored, tmp_path, monkeypatch):
    """CLIPScorer end to end (weights file, preprocessing at 224, embeddings,
    cosine similarity over a folder pair) with a narrow ViT on both sides,
    within 1e-5 abs of JAX."""
    root = scored[0]
    sd = clip_vision_state(8, hidden=32, layers=2, patch=14, proj=16, image_size=224)
    path = save_state(sd, tmp_path / "clip.pth")
    monkeypatch.setattr(jclip, "CLIPVisionEncoder",
                        functools.partial(jclip.CLIPVisionEncoder, **CLIP_TINY))
    monkeypatch.setattr(tclip, "CLIPVisionEncoder",
                        functools.partial(tclip.CLIPVisionEncoder, **CLIP_TINY))
    a, b = str(root / "seq1" / "gen_images"), str(root / "seq1" / "gt_images")
    want = jclip.CLIPScorer(path).image_similarity(a, b)
    scorer = tclip.CLIPScorer(path, device="cpu")
    assert scorer.calibrated
    assert scorer.image_similarity(a, b) == pytest.approx(want, abs=1e-5)
    img = (np.random.RandomState(9).rand(10, 12, 3) * 255).astype(np.uint8)
    np.testing.assert_array_equal(tclip.preprocess_clip_image(img),
                                  jclip.preprocess_clip_image(img))


@pytest.mark.parametrize("entry", ["lpips", "inception", "clip", "center", "fid"])
def test_entry_points_ask_for_the_gpu(entry, scored, monkeypatch):
    """Without `device=` an entry point runs on the GPU: with none present
    it raises and does not carry on on the CPU."""
    from magicdance_tpu_torch.metrics import fid, inception, lpips

    root, _, _, _, inc_path = scored
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "lpips": lambda: lpips.LPIPSScorer(),
        "inception": lambda: inception.InceptionExtractor(inc_path),
        "clip": lambda: tclip.CLIPScorer(),
        "center": lambda: tcenter.get_all_eval_scores(str(root), ["l1"]),
        "fid": lambda: fid.folder_features(str(root / "seq0" / "gen_images"), inc_path),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()
