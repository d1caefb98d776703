"""The arithmetic of kernel K9's Hopper body (`csrc/attention_wgmma.cuh`)
and the routing of K9 between its bodies, on the CPU.

The CUDA body cannot run here, so its arithmetic is written out below as a
blocked emulation, step for step as the kernel takes it: 64-key tiles that
start at g*S + 64t (the last tile of a segment reads rows of the next
segment, or zeros past the last row, and masks them by key index), an
online softmax per segment in the log2 domain, unnormalised P rounded to the
input dtype before the PV product, fp32 accumulation, and each segment's
acc / l summed into the output in fp32. It is held against the JAX probe's
Pallas kernel (`scripts/bench_head_packing.py::packed_attention`, in
interpret mode as tests/test_torch_head_packing.py runs it) and against the
port's plain `packed_attention_ref`. The card's side (the body against the
plain version) is in tests/test_torch_kernels_cuda.py.

Inputs are drawn with numpy from a seed and handed to both frameworks;
kbd/vbd are random, not block-diagonal, so rows read past a segment's end
would change the result if they were not masked.
"""

import importlib.util
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from magicdance_tpu_torch.ops.kernels import packed as P
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE = 64  # keys per tile of the Hopper body (wg::BN)
# fp32: the emulation and the other two differ only in the order of fp32
# sums (tiles and online rescaling vs one product per segment)
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


def hopper_emulation(qp: torch.Tensor, kbd: torch.Tensor, vbd: torch.Tensor, G: int,
                     scale: float) -> torch.Tensor:
    """K9 as the Hopper body computes it, in the input dtype's rounding."""
    bg, sq, gd = qp.shape
    s = kbd.shape[1] // G
    # rows past G*S arrive as zeros (TMA's out-of-bounds fill)
    pad = (-(kbd.shape[1]) % TILE) + TILE
    kz = torch.cat([kbd.float(), kbd.new_zeros(bg, pad, gd).float()], 1)
    vz = torch.cat([vbd, vbd.new_zeros(bg, pad, gd)], 1)
    q = qp.float()
    c = scale * math.log2(math.e)
    out = torch.zeros(bg, sq, gd)
    for g in range(G):
        m = torch.full((bg, sq, 1), -math.inf)
        l = torch.zeros(bg, sq, 1)
        acc = torch.zeros(bg, sq, gd)
        for t0 in range(0, s, TILE):
            rows = slice(g * s + t0, g * s + t0 + TILE)
            logits = q @ kz[:, rows].transpose(1, 2)
            logits[..., min(TILE, s - t0):] = -math.inf  # keys past the segment
            m_new = torch.maximum(m, logits.amax(-1, keepdim=True) * c)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(logits * c - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p.to(vbd.dtype).float() @ vz[:, rows].float()
            m = m_new
        out = out + acc / l
    return out.to(qp.dtype)


def _draw(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_packed(jax_probe, qp, kbd, vbd, G, S, scale, dtype):
    with pltpu.force_tpu_interpret_mode():
        out = jax_probe.packed_attention(*(jnp.asarray(x, dtype) for x in (qp, kbd, vbd)),
                                         scale=scale, G=G, S=S)
    return np.asarray(out.astype(jnp.float32))


def _within(got: np.ndarray, want: np.ndarray, dtype) -> None:
    err = float(np.abs(got - want).max())
    if dtype == torch.float32:
        assert err <= FP32_TOL, err
    else:
        rms = float(np.sqrt(np.mean(want ** 2)))
        assert err <= min(BF16_TOL, BF16_REL_TOL * rms), (err, rms)


# (BG, Sq, S, G, D): S % 64 != 0 everywhere, so every segment's last tile
# reaches into the next segment (or past the last row); G*D = 120 is the
# probe's width, 8 and 256 the ends of the wrapper's range
SHAPES = [
    (2, 70, 100, 3, 40),   # G*D = 120, the probe's G and D
    (2, 70, 100, 1, 40),   # G = 1: per-head attention at D = 40
    (2, 50, 70, 1, 8),     # G*D = 8
    (1, 40, 90, 2, 128),   # G*D = 256
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("bg,sq,s,g,d", SHAPES)
def test_emulation_matches_jax_kernel_and_plain(jax_probe, dtype, bg, sq, s, g, d):
    """The blocked arithmetic of the Hopper body against the Pallas kernel
    and the plain version, within FP32_TOL (fp32) or min(5e-2, 0.1 x RMS)
    (bf16)."""
    qp, kbd, vbd = (_draw(60 + i, bg, n, g * d) for i, n in enumerate((sq, g * s, g * s)))
    scale = d ** -0.5
    ts = [torch.from_numpy(x).to(dtype) for x in (qp, kbd, vbd)]
    got = hopper_emulation(*ts, g, scale)
    assert got.dtype == dtype and got.shape == (bg, sq, g * d)
    got = got.float().numpy()
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    _within(got, _jax_packed(jax_probe, qp, kbd, vbd, g, s, scale, jdt), dtype)
    _within(got, P.packed_attention_ref(*ts, g, scale).float().numpy(), dtype)


def test_emulation_masks_the_next_segment():
    """A control: with the mask left out, the last tile's rows of the next
    segment enter the softmax and the emulation leaves the plain version."""
    bg, sq, s, g, d = 1, 30, 100, 3, 40
    ts = [torch.from_numpy(_draw(70 + i, bg, n, g * d)) for i, n in enumerate((sq, g * s, g * s))]
    want = P.packed_attention_ref(*ts, g, d ** -0.5)
    assert (hopper_emulation(*ts, g, d ** -0.5) - want).abs().max().item() <= FP32_TOL
    unmasked = hopper_emulation(ts[0], ts[1], ts[2], 1, d ** -0.5)  # one segment of G*S keys
    assert (unmasked - want).abs().max().item() > 10 * FP32_TOL


@pytest.mark.parametrize("dtype,width,body", [
    (torch.bfloat16, 8, "wgmma"), (torch.bfloat16, 120, "wgmma"),
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 136, "mma_sync"),
    (torch.bfloat16, 256, "mma_sync"), (torch.float32, 120, "cuda_core"),
    (torch.float32, 256, "cuda_core"),
])
def test_routing(dtype, width, body):
    """bf16 runs the Hopper body up to G*D = 128 and attention_tc above it;
    fp32 the CUDA cores."""
    assert P.packed_body(dtype, width) == body
    assert P.BODIES[body] in (0, 1, 2)


def test_named_bodies_are_checked():
    """A named body must take the dtype and width, on the CPU as on the
    card; the CPU still takes the plain version whichever body is named."""
    qp, kbd, vbd = (torch.from_numpy(_draw(80 + i, 1, n, 120)).to(torch.bfloat16)
                    for i, n in enumerate((16, 48, 48)))
    want = P.packed_attention_ref(qp, kbd, vbd, 3)
    for body in ("wgmma", "mma_sync"):
        assert torch.equal(P.packed_attention(qp, kbd, vbd, 3, body=body), want)
    with pytest.raises(ValueError):
        P.packed_attention(qp, kbd, vbd, 3, body="cuda_core")  # fp32 only
    with pytest.raises(ValueError):
        P.packed_attention(qp.float(), kbd.float(), vbd.float(), 3, body="wgmma")
    wide = [torch.zeros(1, 16, 256, dtype=torch.bfloat16), torch.zeros(1, 32, 256,
                                                                      dtype=torch.bfloat16)]
    with pytest.raises(ValueError):  # past the Hopper body's registers
        P.packed_attention(wide[0], wide[1], wide[1], 2, body="wgmma")
    with pytest.raises(ValueError):
        P.packed_body(torch.float16, 120)
