"""Kernel K9 (head-packed attention) and the head-packing probe's layout on
the CPU.

The port's plain `packed_attention_ref` is held against the JAX probe's
Pallas kernel (`scripts/bench_head_packing.py::packed_attention`), loaded
from its file and run in interpret mode as the JAX package's own tests run
Pallas kernels on the CPU; the packing helpers against the probe's packing
lines and per-head attention; the wrapper against the CPU rule (a CPU
tensor takes the plain version and counts no launch). The card's side of K9
is in tests/test_torch_kernels_cuda.py.

Inputs are drawn with numpy from a seed and handed to both frameworks. The
kbd/vbd of the parity tests are random, not block-diagonal: K9 computes its
function for any K/V.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from magicdance_tpu_torch.ops import kernels as K
from magicdance_tpu_torch.ops.kernels import packed as P
from magicdance_tpu_torch.scripts import bench_head_packing as probe
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BG, S, G, D = 2, 128, 3, 40
# fp32: the interpret-mode kernel and the plain version differ only in the
# order of fp32 sums (one product over G*S keys vs one per segment); a scratch
# run of the JAX kernel matched a numpy reference to 3.1e-6
FP32_TOL = 2e-5
BF16_TOL = 5e-2  # magicdance_tpu/ops/kernel_gate.py:52, and <= 0.1 x RMS below
BF16_REL_TOL = 0.1


@pytest.fixture(scope="module")
def jax_probe():
    """The JAX probe script as a module (it is a script, not a package
    module)."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench_head_packing", os.path.join(ROOT, "scripts", "bench_head_packing.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _draw(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _packed_inputs(seed=0):
    return (_draw(seed, BG, S, G * D), _draw(seed + 1, BG, G * S, G * D),
            _draw(seed + 2, BG, G * S, G * D))


def _jax_packed(jax_probe, qp, kbd, vbd, dtype):
    with pltpu.force_tpu_interpret_mode():
        out = jax_probe.packed_attention(*(jnp.asarray(x, dtype) for x in (qp, kbd, vbd)),
                                         scale=D ** -0.5, G=G, S=S)
    return np.asarray(out.astype(jnp.float32))


def test_plain_matches_jax_kernel_fp32(jax_probe):
    """Random (not block-diagonal) kbd/vbd, fp32: within FP32_TOL."""
    qp, kbd, vbd = _packed_inputs(0)
    want = _jax_packed(jax_probe, qp, kbd, vbd, jnp.float32)
    got = P.packed_attention_ref(*(torch.from_numpy(x) for x in (qp, kbd, vbd)), G,
                                 D ** -0.5)
    assert got.dtype == torch.float32 and got.shape == (BG, S, G * D)
    err = np.abs(got.numpy() - want).max()
    assert err <= FP32_TOL, err


def test_plain_matches_jax_kernel_bf16(jax_probe):
    """The same in bf16 (P cast to bf16 before PV on both sides): within
    min(5e-2, 0.1 x the RMS of the JAX output)."""
    qp, kbd, vbd = _packed_inputs(10)
    want = _jax_packed(jax_probe, qp, kbd, vbd, jnp.bfloat16)
    got = P.packed_attention_ref(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (qp, kbd, vbd)), G, D ** -0.5)
    assert got.dtype == torch.bfloat16
    rms = float(np.sqrt(np.mean(want ** 2)))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= min(BF16_TOL, BF16_REL_TOL * rms), (err, rms)


def test_packing_matches_the_probe_layout():
    """pack_heads and blockdiag lay heads out as the probe's lines :159-167
    (written here in numpy); unpack_heads inverts pack_heads exactly."""
    b, h = 2, 6
    x = _draw(20, b, S, h, D)
    ng = h // G
    qp = x.reshape(b, S, ng, G, D).transpose(0, 2, 1, 3, 4).reshape(b * ng, S, G * D)
    xg = x.reshape(b, S, ng, G, D).transpose(0, 2, 3, 1, 4)
    bd = np.zeros((b, ng, G, S, G, D), np.float32)
    for g in range(G):
        bd[:, :, g, :, g, :] = xg[:, :, g]
    bd = bd.reshape(b * ng, G * S, G * D)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(P.pack_heads(xt, G).numpy(), qp)
    np.testing.assert_array_equal(P.blockdiag(xt, G).numpy(), bd)
    np.testing.assert_array_equal(P.unpack_heads(P.pack_heads(xt, G), b, G).numpy(), x)


@pytest.mark.parametrize("b,h,g", [(2, 6, 3), (1, 4, 2)])
def test_packed_equals_per_head_attention(b, h, g):
    """On block-diagonal K/V, packed attention unpacked is per-head
    self-attention (fp32, within FP32_TOL)."""
    q, k, v = (torch.from_numpy(_draw(30 + i, b, S, h, D)) for i in range(3))
    got = P.unpack_heads(P.packed_attention(P.pack_heads(q, g), P.blockdiag(k, g),
                                            P.blockdiag(v, g), g), b, g)
    want = K.self_attention_ref(q, k, v)
    assert (got - want).abs().max().item() <= FP32_TOL


def test_wrapper_on_cpu_takes_the_plain_version():
    qp, kbd, vbd = (torch.from_numpy(x) for x in _packed_inputs(40))
    K.reset_launches()
    out = P.packed_attention(qp, kbd, vbd, G)
    assert torch.equal(out, P.packed_attention_ref(qp, kbd, vbd, G, D ** -0.5))
    assert not any(K.LAUNCHES.values())
    assert "packed_attention" in K.LAUNCHES
    with pytest.raises(ValueError):  # key rows not G segments
        P.packed_attention(qp, kbd[:, :100], vbd[:, :100], G)
    with pytest.raises(ValueError):  # width not G heads
        P.packed_attention(qp, kbd, vbd, 7)
    with pytest.raises(ValueError):  # mixed dtypes
        P.packed_attention(qp, kbd.double(), vbd, G)


def test_probe_needs_the_card(monkeypatch):
    """The probe measures the card: without one it raises before timing
    anything, and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        probe.main([])
