"""The port's temporal modules against the JAX package's Flax modules at the
tiny temporal config (tests/test_sampling.py's `tiny_cfg(motion=True)`,
motion_num_heads = 2): the motion module (`TemporalTransformer`), the temporal
UNet and the composite `MagicPoseModel` (bank read, uc=True; F = 4 and
F = 1), with the same numpy inputs and the same randomised weights (every
leaf, drawn with numpy on `jax.eval_shape` shapes) carried over by
`convert.from_jax`. fp32; tolerance 2e-4 abs/rel for the single module and
5e-4 for the networks (tests/test_torch_models.py's, deeper nets)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicdance_tpu.models.layers import TemporalTransformer as JTT
from magicdance_tpu.models.magicpose import MagicPoseModel as JModel
from magicdance_tpu.models.unet import UNet as JUNet
from magicdance_tpu_torch.convert.from_jax import flax_to_state_dict, load_flax_params
from magicdance_tpu_torch.models.layers import TemporalTransformer
from magicdance_tpu_torch.models.magicpose import MagicPoseModel
from torch_port_util import (
    assert_close,
    jit_apply,
    np_rand,
    port_cfg,
    shaped_random,
    tiny_temporal_cfg_jax,
    to_t,
)
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

F32 = jnp.float32
JCFG = tiny_temporal_cfg_jax()
TCFG = port_cfg(JCFG)
NET_TOL = dict(atol=5e-4, rtol=5e-4)


def frames_nchw(x: np.ndarray) -> torch.Tensor:
    """(B, F, H, W, C) numpy -> the port's (B*F, C, H, W) layout."""
    b, f, h, w, c = x.shape
    return to_t(x).reshape(b * f, h, w, c).permute(0, 3, 1, 2)


@pytest.mark.parametrize("b,f,hw,c,heads", [(2, 4, 4, 32, 2), (1, 16, 2, 64, 2),
                                            (3, 1, 4, 32, 2), (2, 8, 4, 48, 4)])
def test_temporal_transformer_matches_flax(b, f, hw, c, heads):
    """Layout (frames inner, clip major), PE over C channels and the
    residual; S = F = 1 included. The grouped sites (128 | b*hw*f) take
    kernel G's plain version, the others the plain attention."""
    x = np_rand((b, f, hw, hw, c), 0)
    jm = JTT(num_heads=heads, dtype=F32)
    params = shaped_random(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    want = jit_apply(jm)(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tm = TemporalTransformer(c, heads).eval()
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(frames_nchw(x), f)
    got = got.permute(0, 2, 3, 1).reshape(b, f, hw, hw, c)
    assert_close(got, want, atol=2e-4, rtol=2e-4)


def test_sinusoidal_pe_is_a_buffer_not_a_parameter():
    tm = TemporalTransformer(32, 2)
    assert not any("pe_" in k for k in tm.state_dict())
    x = torch.zeros(1, 3, 32)
    pe = tm.pe_0_0(x)[0].numpy()
    div = np.exp(np.arange(0, 32, 2) * (-np.log(10000.0) / 32))
    np.testing.assert_allclose(pe[:, 0::2], np.sin(np.arange(3)[:, None] * div), atol=1e-6)
    np.testing.assert_allclose(pe[:, 1::2], np.cos(np.arange(3)[:, None] * div), atol=1e-6)
    assert tm.to(torch.bfloat16).pe_0_0(x.bfloat16()).dtype == torch.bfloat16


@pytest.fixture(scope="module")
def unets(models):
    """The composite's main UNet on its own: the Flax `unet` subtree and the
    port's `model.unet` (one random tree serves both fixtures)."""
    _, params, tm = models
    return JUNet(JCFG.unet), {"params": params["params"]["unet"]}, tm.unet


def test_state_dict_keys_match_flax_tree(unets):
    _, params, tm = unets
    keys = set(tm.state_dict())
    assert set(flax_to_state_dict(params)) == keys
    # a motion module after every encoder res unit and every decoder unit
    assert {k.split(".")[0] for k in keys if "motion" in k} == {
        "enc_motion_0", "enc_motion_1", "dec_motion_0", "dec_motion_1",
        "dec_motion_2", "dec_motion_3"}


@pytest.mark.parametrize("clips,f", [(2, 4), (2, 1)])
def test_temporal_unet_matches_flax(unets, clips, f):
    jm, params, tm = unets
    b = clips * f
    x = np_rand((b, 8, 8, 4), 20)
    t = np.repeat(np.array([17, 640])[:clips], f)
    ctx = np_rand((b, 77, 16), 21)
    want, _ = jit_apply(jm, dtype=F32, num_frames=f)(params, jnp.asarray(x), jnp.asarray(t),
                                                      jnp.asarray(ctx))
    with torch.no_grad():
        got, _ = tm(to_t(x), torch.tensor(t), to_t(ctx), num_frames=f)
    assert_close(got, want, **NET_TOL)


@pytest.fixture(scope="module")
def models():
    jm = JModel(JCFG)
    x = jnp.zeros((4, 8, 8, 4))
    params = shaped_random(lambda: jm.init(
        jax.random.PRNGKey(0), x, jnp.zeros((4,), jnp.int32), jnp.zeros((4, 77, 16)),
        reference_noisy=x[:1], pose_hint=jnp.zeros((4, 64, 64, 3)), num_frames=4), 30)
    tm = MagicPoseModel(TCFG).eval()
    load_flax_params(tm, params)
    return jm, jax.tree.map(jnp.asarray, params), tm


@pytest.fixture(scope="module")
def jax_bank(models):
    """JAX's batch-1 bank of the read cases (one compile for both)."""
    jm, params, _ = models
    ref, ctx = np_rand((1, 8, 8, 4), 43), np_rand((8, 77, 16), 41)
    return jit_apply(jm, method=jm.compute_bank)(params, jnp.asarray(ref), jnp.full((1,), 321),
                                                  jnp.asarray(ctx[:1]))


@pytest.mark.parametrize("mode,f", [("read", 4), ("uc", 4), ("read", 1),
                                    ("inline_per_clip", 4)])
def test_magicpose_temporal_forward(models, jax_bank, mode, f):
    """A window of 8 frames (two clips of 4, or eight of 1): the bank read
    with a batch-1 bank, the uncond pass, and the training forward with one
    reference per clip (bank computed inline and repeated per frame)."""
    jm, params, tm = models
    b = 8
    x = np_rand((b, 8, 8, 4), 40)
    t = np.full((b,), 321) if mode != "inline_per_clip" else np.repeat([55, 801], 4)
    ctx = np_rand((b, 77, 16), 41)
    hint = np_rand((b, 64, 64, 3), 42, 0.0, 1.0)
    jx, jt, jc = jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)
    with torch.no_grad():
        if mode == "uc":
            want = jit_apply(jm, uc=True, num_frames=f)(params, jx, jt, jc)
            got = tm(to_t(x), torch.tensor(t), to_t(ctx), uc=True, num_frames=f)
        elif mode == "read":
            ref = np_rand((1, 8, 8, 4), 43)
            want = jit_apply(jm, num_frames=f)(params, jx, jt, jc, bank=jax_bank,
                                               pose_hint=jnp.asarray(hint))
            tbank = tm.compute_bank(to_t(ref), torch.tensor(t[:1]), to_t(ctx[:1]))
            assert all(e.shape[0] == 1 for e in tbank)
            got = tm(to_t(x), torch.tensor(t), to_t(ctx), bank=tbank, pose_hint=to_t(hint),
                     num_frames=f)
        else:
            ref = np_rand((2, 8, 8, 4), 44)
            want = jit_apply(jm, num_frames=f)(params, jx, jt, jc,
                                               reference_noisy=jnp.asarray(ref),
                                               pose_hint=jnp.asarray(hint))
            got = tm(to_t(x), torch.tensor(t), to_t(ctx), reference_noisy=to_t(ref),
                     pose_hint=to_t(hint), num_frames=f)
    assert_close(got, want, **NET_TOL)


def test_motion_modules_are_the_only_difference(models):
    """With every motion module's proj_out at zero (its initial state) the
    temporal model is the image model: each module is then the identity."""
    _, _, tm = models
    img = MagicPoseModel(dataclasses.replace(TCFG, variant=type(TCFG.variant)(
        "appearance_pose"), unet=dataclasses.replace(TCFG.unet, use_motion_modules=False)))
    sd = {k: v for k, v in tm.state_dict().items() if "motion" not in k}
    img.load_state_dict(sd, strict=True)
    tz = MagicPoseModel(TCFG).eval()
    tz.load_state_dict(tm.state_dict())
    with torch.no_grad():
        for name, m in tz.unet.named_children():
            if "motion" in name:
                m.proj_out.weight.zero_()
                m.proj_out.bias.zero_()
        x, ctx = to_t(np_rand((4, 8, 8, 4), 50)), to_t(np_rand((4, 77, 16), 51))
        t = torch.full((4,), 99)
        assert torch.equal(tz(x, t, ctx, uc=True, num_frames=4), img(x, t, ctx, uc=True))
