"""Kernel K8's plain version (fused GroupNorm + SiLU) against the JAX
package's Pallas kernel `ops/pallas/groupnorm.py::groupnorm_silu`, run in
interpret mode on the CPU, and `GroupNorm32`'s opt-in dispatch to it
(MAGICDANCE_FUSED_GN=1, the JAX package's conditions). Tolerance 2e-5
abs/rel in fp32: the Pallas kernel's one-pass E[x^2] - E[x]^2 statistics and
PyTorch's group norm differ only in summation order at these sizes.

On the CPU the dispatch never takes the kernel (it needs a tensor on the
card); the tests that exercise the dispatched path add "cpu" to
`layers.FUSED_GN_DEVICES`, so the wrapper runs and takes its plain version."""

import math

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
    assert_close(GN.groupnorm_silu(rows, to_t(scale), to_t(bias), groups, eps).reshape(
        b, hw, hw, c), want, **TOL)
    assert not any(K.LAUNCHES.values())


def _norm(c, seed, act=True):
    gn = GroupNorm32(c, act=act)
    with torch.no_grad():
        gn.norm.weight.copy_(1 + 0.1 * to_t(np_rand((c,), seed)))
        gn.norm.bias.copy_(0.1 * to_t(np_rand((c,), seed + 1)))
    return gn


def _channels_last(shape, seed):
    return to_t(np_rand(shape, seed)).contiguous(memory_format=torch.channels_last)


def test_fused_dispatch_equals_the_plain_norm(monkeypatch):
    """The dispatched path (wrapper, plain version here) gives the unfused
    norm's result on channels_last activations, in that layout."""
    monkeypatch.setattr(layers, "FUSED_GN_DEVICES", ("cuda", "cpu"))
    monkeypatch.setenv("MAGICDANCE_FUSED_GN", "1")
    calls = []
    real = layers.groupnorm_silu
    monkeypatch.setattr(layers, "groupnorm_silu",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    gn = _norm(64, 10)
    x = _channels_last((2, 64, 16, 16), 11)
    with torch.no_grad():
        fused = gn(x)
        monkeypatch.setenv("MAGICDANCE_FUSED_GN", "0")
        plain = gn(x)
    assert calls == [(2, 256, 64)]
    assert fused.is_contiguous(memory_format=torch.channels_last)
    assert_close(fused, plain.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("case", ["switch_off", "small_grid", "no_act", "grad", "off_card"])
def test_fused_dispatch_conditions(monkeypatch, case):
    """JAX's conditions (models/layers.py:88-100): the switch, act=True, no
    gradient, H*W >= 256, and (for the port) a tensor on the card."""
    if case != "off_card":
        monkeypatch.setattr(layers, "FUSED_GN_DEVICES", ("cuda", "cpu"))
    monkeypatch.setenv("MAGICDANCE_FUSED_GN", "0" if case == "switch_off" else "1")
    gn = _norm(32, 20, act=case != "no_act")
    x = _channels_last((1, 32, 8, 8) if case == "small_grid" else (1, 32, 16, 16), 21)
    with torch.set_grad_enabled(case == "grad"):
        assert not gn.fused_site(x.requires_grad_(case == "grad"))
    monkeypatch.setattr(layers, "FUSED_GN_DEVICES", ("cuda", "cpu"))
    monkeypatch.setenv("MAGICDANCE_FUSED_GN", "1")
    with torch.no_grad():
        assert gn.fused_site(_channels_last((1, 32, 16, 16), 22)) == (case != "no_act")


def test_fused_path_refuses_other_layouts(monkeypatch):
    """The kernel takes rows of channels (unit channel stride): an
    NCHW-contiguous input raises instead of being copied."""
    monkeypatch.setattr(layers, "FUSED_GN_DEVICES", ("cuda", "cpu"))
    monkeypatch.setenv("MAGICDANCE_FUSED_GN", "1")
    gn = _norm(32, 30)
    x = to_t(np_rand((2, 32, 16, 16), 31))  # NCHW-contiguous
    with torch.no_grad(), pytest.raises(ValueError, match="unit stride"):
        gn(x)
    with pytest.raises(ValueError):  # groups must divide the channels
        GN.groupnorm_silu(torch.zeros(1, 4, 30), torch.ones(30), torch.zeros(30), 32, 1e-5)
    np.testing.assert_array_equal(
        GN.groupnorm_silu_ref(torch.zeros(1, 4, 32), torch.ones(32), torch.zeros(32), 32,
                              1e-5).numpy(), np.zeros((1, 4, 32), np.float32))
