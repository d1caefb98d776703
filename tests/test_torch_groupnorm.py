"""Kernel K8's plain version (fused GroupNorm with a SiLU or identity
epilogue) against the JAX package's Pallas kernel
`ops/pallas/groupnorm.py::groupnorm_silu`, run in interpret mode on the CPU
(SiLU), and against numpy (identity); `GroupNorm32`'s dispatch to it (on by
default in a pass with grad mode off, `MAGICDANCE_FUSED_GN=0` the opt-out)
and its `GN_SITES` counter over one serving step and one training step.
Tolerance 2e-5 abs/rel in fp32: the Pallas kernel's one-pass E[x^2] - E[x]^2
statistics and PyTorch's group norm differ only in summation order at these
sizes.

On the CPU the dispatch never takes the kernel (it needs a tensor on the
card); the tests that exercise the dispatched path add "cpu" to
`layers.FUSED_GN_DEVICES`, so the wrapper runs and takes its plain version."""

import math

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from magicdance_tpu.ops.pallas.groupnorm import groupnorm_silu as j_groupnorm_silu
from magicdance_tpu_torch.models import layers
from magicdance_tpu_torch.models.layers import GroupNorm32
from magicdance_tpu_torch.ops import kernels as K
from magicdance_tpu_torch.ops.kernels import groupnorm as GN
from torch_port_util import assert_close, np_rand, to_t
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("b,hw,c,eps", [(2, 16, 64, 1e-5), (1, 16, 48, 1e-5),
                                        (2, 8, 96, 1e-6)])
def test_groupnorm_silu_ref_matches_pallas(b, hw, c, eps):
    groups = 32 if c % 32 == 0 else math.gcd(c, 32)
    x = np_rand((b, hw, hw, c), 0) * 2 + 0.5
    scale = 1 + 0.1 * np_rand((c,), 1)
    bias = 0.1 * np_rand((c,), 2)
    with pltpu.force_tpu_interpret_mode():
        want = j_groupnorm_silu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                groups=groups, eps=eps)
    rows = to_t(x).reshape(b, hw * hw, c)
    got = GN.groupnorm_silu_ref(rows, to_t(scale), to_t(bias), groups, eps)
    assert_close(got.reshape(b, hw, hw, c), want, **TOL)
    # the wrapper takes the plain version for a CPU tensor, without a launch
    K.reset_launches()
    assert_close(GN.groupnorm_act(rows, to_t(scale), to_t(bias), groups, eps, "silu").reshape(
        b, hw, hw, c), want, **TOL)
    assert not any(K.LAUNCHES.values())


@pytest.mark.parametrize("affine", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hw,c,eps", [(2, 256, 64, 1e-6), (1, 300, 48, 1e-6)])
def test_groupnorm_identity_ref_matches_numpy(b, hw, c, eps, affine):
    """The identity epilogue (the transformers' norms) of the plain version
    and of the wrapper on a CPU tensor: the group norm in float64 numpy,
    with the affine stored in fp32 or bf16 (the wrapper widens it)."""
    groups = 32 if c % 32 == 0 else math.gcd(c, 32)
    x = np_rand((b, hw, c), 3) * 2 + 0.5
    w = to_t(1 + 0.1 * np_rand((c,), 4)).to(affine)
    bias = to_t(0.1 * np_rand((c,), 5)).to(affine)
    xg = x.astype(np.float64).reshape(b, hw, groups, c // groups)
    mean = xg.mean(axis=(1, 3), keepdims=True)
    var = xg.var(axis=(1, 3), keepdims=True)
    want = (((xg - mean) / np.sqrt(var + eps)).reshape(b, hw, c)
            * w.double().numpy() + bias.double().numpy())
    assert_close(GN.groupnorm_silu_ref(to_t(x), w, bias, groups, eps, act=None), want, **TOL)
    K.reset_launches()
    got = GN.groupnorm_act(to_t(x), w, bias, groups, eps, None)
    assert got.is_contiguous() and got.dtype == torch.float32
    assert_close(got, want, **TOL)
    assert not any(K.LAUNCHES.values())
    with pytest.raises(ValueError, match="act"):
        GN.groupnorm_act(to_t(x), w, bias, groups, eps, "gelu")


def _norm(c, seed, act=True):
    gn = GroupNorm32(c, act=act)
    with torch.no_grad():
        gn.norm.weight.copy_(1 + 0.1 * to_t(np_rand((c,), seed)))
        gn.norm.bias.copy_(0.1 * to_t(np_rand((c,), seed + 1)))
    return gn


def _channels_last(shape, seed):
    return to_t(np_rand(shape, seed)).contiguous(memory_format=torch.channels_last)


def test_fused_dispatch_equals_the_plain_norm(monkeypatch):
    """The dispatched path (wrapper, plain version here; the default, no
    switch set) gives the unfused norm's result on channels_last
    activations, in that layout, with SiLU after a ResBlock's norm and none
    after a transformer's."""
    monkeypatch.setattr(layers, "FUSED_GN_DEVICES", ("cuda", "cpu"))
    monkeypatch.delenv("MAGICDANCE_FUSED_GN", raising=False)
    calls = []
    real = layers.groupnorm_act
    monkeypatch.setattr(layers, "groupnorm_act",
                        lambda *a: calls.append((a[0].shape, a[-1])) or real(*a))
    x = _channels_last((2, 64, 16, 16), 11)
    for act in (True, False):
        gn = _norm(64, 10, act=act)
        with torch.no_grad():
            fused = gn(x)
            monkeypatch.setenv("MAGICDANCE_FUSED_GN", "0")
            plain = gn(x)
        monkeypatch.delenv("MAGICDANCE_FUSED_GN")
        assert fused.is_contiguous(memory_format=torch.channels_last)
        assert_close(fused, plain.numpy(), atol=1e-6, rtol=1e-6)
    assert calls == [((2, 256, 64), "silu"), ((2, 256, 64), None)]


@pytest.mark.parametrize("case", ["switch_off", "small_grid", "no_act", "grad", "off_card"])
def test_fused_dispatch_conditions(monkeypatch, case):
    """On by default (the switch unset; "0" turns it off), grad mode off,
    H*W >= 64 (the port's threshold; JAX's is 256), and (for the port) a
    tensor on the card; a norm without
    SiLU qualifies as one with it. Grad mode on keeps the plain path even
    where nothing asks for a gradient (a frozen block of a training step)."""
    if case != "off_card":
        monkeypatch.setattr(layers, "FUSED_GN_DEVICES", ("cuda", "cpu"))
    if case == "switch_off":
        monkeypatch.setenv("MAGICDANCE_FUSED_GN", "0")
    else:
        monkeypatch.delenv("MAGICDANCE_FUSED_GN", raising=False)
    gn = _norm(32, 20, act=case != "no_act")
    x = _channels_last((1, 32, 7, 8) if case == "small_grid" else (1, 32, 16, 16), 21)
    with torch.set_grad_enabled(case == "grad"):
        assert gn.fused_site(x) == (case == "no_act")
        if case == "grad":  # nor where the input asks for a gradient
            assert not gn.fused_site(x.clone().requires_grad_())
    monkeypatch.setattr(layers, "FUSED_GN_DEVICES", ("cuda", "cpu"))
    monkeypatch.delenv("MAGICDANCE_FUSED_GN", raising=False)
    with torch.no_grad():
        assert gn.fused_site(_channels_last((1, 32, 16, 16), 22))


def test_fused_path_refuses_other_layouts(monkeypatch):
    """The kernel takes rows of channels (unit channel stride): an
    NCHW-contiguous input raises instead of being copied."""
    monkeypatch.setattr(layers, "FUSED_GN_DEVICES", ("cuda", "cpu"))
    monkeypatch.delenv("MAGICDANCE_FUSED_GN", raising=False)
    gn = _norm(32, 30)
    x = to_t(np_rand((2, 32, 16, 16), 31))  # NCHW-contiguous
    with torch.no_grad(), pytest.raises(ValueError, match="unit stride"):
        gn(x)
    with pytest.raises(ValueError):  # groups must divide the channels
        GN.groupnorm_act(torch.zeros(1, 4, 30), torch.ones(30), torch.zeros(30), 32, 1e-5,
                         "silu")
    np.testing.assert_array_equal(
        GN.groupnorm_silu_ref(torch.zeros(1, 4, 32), torch.ones(32), torch.zeros(32), 32,
                              1e-5).numpy(), np.zeros((1, 4, 32), np.float32))


def test_gn_sites_of_a_serving_step_and_a_training_step(monkeypatch):
    """`GN_SITES` over one DDIM step of the exact image recipe on the SD1.5
    UNet, ControlNet and appearance UNet (SD1.5's levels, blocks and
    transformers, the channels narrowed to 32 at the first level, which the
    dispatch does not read), as the launch plan counts them: at 512x512 (a
    64x64 latent) all 210 `GroupNorm32` calls take K8 (155 with SiLU, 55
    transformer norms; the smallest grid is 8x8, 64 positions); at 256x256
    the 54 calls at 4x4 stay plain and 156 take K8. One stage-2 training
    step takes none. The attention calls are stubbed (their output is their
    queries): the count reads only shapes and grad mode, and the plain
    attention over 4096 tokens would cost most of the test's time."""
    from magicdance_tpu_torch import config as T
    from magicdance_tpu_torch.ops.schedules import make_ddim_schedule
    from magicdance_tpu_torch.pipeline import MagicPosePipeline
    from magicdance_tpu_torch.sampling.ddim import ddim_sample
    from magicdance_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(layers, "FUSED_GN_DEVICES", ("cuda", "cpu"))
    monkeypatch.delenv("MAGICDANCE_FUSED_GN", raising=False)
    monkeypatch.setattr(layers, "attention_packed", lambda q, *a, **kw: q)
    monkeypatch.setattr(layers, "bank_read_attention_packed", lambda q, *a, **kw: q)
    narrow = dict(model_channels=32, num_heads=2, context_dim=16)
    cfg = T.ModelConfig(unet=T.UNetConfig(**narrow), pose_control=T.ControlNetConfig(**narrow),
                        vae=T.VAEConfig(base_channels=32, channel_mult=(1, 1, 2, 2),
                                        num_res_blocks=1),
                        clip=T.CLIPTextConfig(hidden_size=16, num_layers=1, num_heads=2),
                        latent_size=64, dtype="float32")
    pipe = MagicPosePipeline(cfg, device="cpu")
    pipe.init_params(seed=0, scale=0.1)
    g = torch.Generator().manual_seed(0)
    ctx = torch.randn(1, 77, 16, generator=g)
    scfg = T.SampleConfig(steps=1)
    for latent, want in ((64, {"k8": 210}), (32, {"k8": 156, "plain": 54})):
        layers.GN_SITES.clear()
        out = ddim_sample(pipe.model, pipe.sched, make_ddim_schedule(pipe.sched, 1), scfg,
                          torch.randn(1, latent, latent, 4, generator=g), ctx, ctx,
                          reference_latent=torch.randn(1, latent, latent, 4, generator=g),
                          pose_hint=torch.rand(1, 8 * latent, 8 * latent, 3, generator=g))
        assert torch.isfinite(out).all()
        assert dict(layers.GN_SITES) == want
        plan = chip_smoke.request_launch_plan(T.ModelConfig(), latent, 16, scfg)
        assert plan["groupnorm_silu"] == 2 * want["k8"]

    tr = Trainer(chip_smoke.narrow_train_config(), device="cpu")
    tr.init_random(seed=0, scale=0.1)
    batch = {"image": torch.rand(2, 128, 128, 3, generator=g) * 2 - 1,
             "reference": torch.rand(2, 128, 128, 3, generator=g) * 2 - 1,
             "pose": torch.rand(2, 128, 128, 3, generator=g),
             "input_ids": torch.zeros(2, 77, dtype=torch.long)}
    layers.GN_SITES.clear()
    assert torch.isfinite(tr.train_step(batch)["loss"])
    assert layers.GN_SITES["k8"] == 0 and layers.GN_SITES["plain"] > 0
