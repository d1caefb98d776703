"""The arithmetic of the Hopper body of kernels A and B
(`csrc/attention_wgmma.cuh`, modes SELF, TWO_SOURCE with and without the
LSE, GATED) and the choice of body, on the CPU.

The CUDA body cannot run here, so its arithmetic is written out below as a
blocked emulation, step for step as the kernel takes it: tiles of 64 keys
(128 up to the kernel's WIDE_TILE_KS, read from its source) per source (the
self keys, then the bank's; no tile straddles the two), each source's
ragged last tile masked by key index, fp32 logits and an online softmax in
the log2 domain (scale * log2(e) folded into one FMA), unnormalised P
rounded to the input dtype before the PV product, fp32 accumulation, the gate multiplied
after the exp inside the joint max and denominator (a row gated by 0 walks
no bank tile), and the natural-log LSE. It is held against the JAX
package's Pallas kernels (`flash.py::_attn_kernel_fused`,
`_attn2_kernel_fused`, `_attn2_kernel_nomask`, `_attn2_kernel` with gates
[1, 1, 0, 0], `flash_vjp.py::_fwd_lse_kernel`, `_fwd2_lse_kernel`), run in
interpret mode as tests/test_flash_attention.py runs them, and against the
port's plain versions. The card's side (each body against the plain version)
is in tests/test_torch_kernels_cuda.py.

Tolerances: fp32 2e-5 (the order of fp32 sums). bf16: max-abs <= min(5e-2,
0.1 x the RMS of the reference) (magicdance_tpu/ops/kernel_gate.py:52, the rule
of the card tests).
"""

import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from magicdance_tpu.ops.pallas import flash as JF
from magicdance_tpu.ops.pallas import flash_vjp as JV
from magicdance_tpu_torch.ops import kernels as K
from magicdance_tpu_torch.ops.kernels import attention as A
from magicdance_tpu_torch.ops.kernels import flash_vjp as V
from torch_port_util import np_rand
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "magicdance_tpu_torch", "ops", "kernels", "csrc")
FP32_TOL = 2e-5
BF16_TOL = 5e-2
BF16_REL_TOL = 0.1
H = 2


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


# the tile rule, read from the kernel's source
WIDE_TILE_KS = int(re.search(r"constexpr int WIDE_TILE_KS = (\d+);",
                             _source("attention_wgmma.cuh")).group(1))


def tile_keys(d: int) -> int:
    """Keys per K/V tile of the Hopper body at head width d
    (attention_wgmma.cuh::tile_keys)."""
    return 128 if (d + 15) // 16 <= WIDE_TILE_KS else 64


def hopper_emulation(q, k, v, kb=None, vb=None, scale=None, gate=None):
    """Kernels A and B (bank kb/vb, bank batch 1 or B; `gate` (B,)) as the
    Hopper body computes them, in the input dtype's rounding. Returns (out
    in q's dtype, lse (B, H, Sq) fp32)."""
    b, sq, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    tile = tile_keys(d)
    c = scale * math.log2(math.e)
    qf = q.float().permute(0, 2, 1, 3)  # (B, H, Sq, D)
    m = torch.full((b, h, sq, 1), -math.inf)
    l = torch.zeros(b, h, sq, 1)
    acc = torch.zeros(b, h, sq, d)
    sources = [(k, v, None)] + ([(kb, vb, gate)] if kb is not None else [])
    for si, (ks, vs, g) in enumerate(sources):
        kf = ks.float().permute(0, 2, 1, 3).expand(b, -1, -1, -1)
        vr = vs.permute(0, 2, 1, 3).expand(b, -1, -1, -1)
        gates = torch.ones(b) if g is None else g.float()
        rows = gates != 0 if si else torch.ones(b, dtype=torch.bool)  # gate 0: no bank tile
        for t0 in range(0, ks.shape[1], tile):
            nk = min(tile, ks.shape[1] - t0)
            s = torch.full((b, h, sq, tile), -math.inf)
            s[..., :nk] = qf @ kf[:, :, t0:t0 + nk].transpose(-1, -2)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True) * c)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s * c - m_new) * gates[:, None, None, None]
            v_tile = torch.zeros(b, h, tile, d, dtype=vs.dtype)
            v_tile[:, :, :nk] = vr[:, :, t0:t0 + nk]
            new_l = l * alpha + p.sum(-1, keepdim=True)
            new_acc = acc * alpha + p.to(vs.dtype).float() @ v_tile.float()
            sel = rows[:, None, None, None]
            m, l, acc = (torch.where(sel, new, old) for new, old in
                         ((m_new, m), (new_l, l), (new_acc, acc)))
    out = (acc / l).permute(0, 2, 1, 3).to(q.dtype)
    lse = (m * math.log(2) + torch.log(l))[..., 0]
    return out, lse


def _within(got, want, dtype, tol=FP32_TOL) -> None:
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    if dtype == torch.bfloat16:
        rms = float(np.sqrt(np.mean(want ** 2)))
        assert err <= min(BF16_TOL, BF16_REL_TOL * rms), (err, rms)
    else:
        assert err <= tol, err


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _jax(x: np.ndarray, dtype) -> jnp.ndarray:
    return jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


def _to_core(x):  # (B, S, H, D) -> (B*H, S, D), flash_vjp's layout
    b, s, h, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * h, s, d)


# (D, Sq, Sk, Sb): lengths not multiples of the 64-key tiles, Sk and Sb
# below and above Sq; D = 40 takes one partial 64-column TMA box, 80 a full
# and a partial one, 160 three
SHAPES = [(40, 96, 70, 150), (80, 80, 130, 50), (160, 96, 90, 70)]
KERNELS = ["attn_fused", "attn2_fused", "attn2_nomask", "attn2_gated", "fwd_lse", "fwd2_lse"]


def _inputs(d, sq, sk, sb, dtype, b=2, bank_batch=1, seed=0):
    q = np_rand((b, sq, H, d), seed)
    k, v = (np_rand((b, sk, H, d), seed + 1 + i) for i in range(2))
    kb, vb = (np_rand((bank_batch, sb, H, d), seed + 3 + i) for i in range(2))
    return [x for x in (q, k, v, kb, vb)], [torch.from_numpy(x).to(dtype)
                                          for x in (q, k, v, kb, vb)]


def _jax_kernel(name, arrs, dtype, scale, gates):
    """The Pallas kernel `name` in interpret mode on numpy inputs: (out (B,
    Sq, H, D), lse (B, H, Sq) or None) as numpy fp32."""
    q, k, v, kb, vb = (_jax(x, dtype) for x in arrs)
    b, sq, h, d = q.shape
    with pltpu.force_tpu_interpret_mode():
        if name == "attn_fused":
            o = JF._flash_attention_fused_impl(*(x.reshape(x.shape[0], x.shape[1], h * d)
                                                 for x in (q, k, v)), scale=scale, num_heads=h)
            return np.asarray(o.astype(jnp.float32)).reshape(b, sq, h, d), None
        if name == "attn2_fused":
            o = JF._flash_attention_two_source_fused_impl(
                *(x.reshape(x.shape[0], x.shape[1], h * d) for x in (q, k, v, kb, vb)),
                scale=scale, num_heads=h)
            return np.asarray(o.astype(jnp.float32)).reshape(b, sq, h, d), None
        if name in ("attn2_nomask", "attn2_gated"):
            mask = None if name == "attn2_nomask" else jnp.asarray(gates, jnp.float32)
            o = JF._flash_attention_two_source_impl(q, k, v, kb, vb, scale=scale,
                                                    bank_mask=mask)
            return np.asarray(o.astype(jnp.float32)), None
        if name == "fwd_lse":
            o, lse = JV._core_fwd_lse(*(_to_core(x) for x in (q, k, v)), scale=scale)
        else:
            o, lse = JV._core2_fwd_lse(*(_to_core(x) for x in (q, k, v, kb, vb)), scale=scale)
    o = np.asarray(o.astype(jnp.float32)).reshape(b, h, sq, d).transpose(0, 2, 1, 3)
    return o, np.asarray(lse).reshape(b, h, sq)


def _port_ref(name, ts, scale, gates):
    q, k, v, kb, vb = ts
    if name == "attn_fused":
        return K.self_attention_ref(q, k, v, scale), None
    if name == "fwd_lse":
        return V.self_attention_lse_ref(q, k, v, scale)
    if name == "fwd2_lse":
        return V.two_source_attention_lse_ref(q, k, v, kb, vb, scale)
    mask = torch.tensor(gates) if name == "attn2_gated" else None
    return K.two_source_attention_ref(q, k, v, kb, vb, scale, mask), None


def _emulate(name, ts, scale, gates):
    q, k, v, kb, vb = ts
    if name in ("attn_fused", "fwd_lse"):
        return hopper_emulation(q, k, v, scale=scale)
    gate = torch.tensor(gates) if name == "attn2_gated" else None
    return hopper_emulation(q, k, v, kb, vb, scale=scale, gate=gate)


def _case(name, d, sq, sk, sb):
    """Batch and bank batch of a kernel's case: the gated read at B = 4,
    gates [1, 1, 0, 0] and a batch-1 bank; the training forward with a bank
    per row (stage 2's bank batch B), the others with a batch-1 bank."""
    b = 4 if name == "attn2_gated" else 2
    return b, (b if name == "fwd2_lse" else 1), [1.0, 1.0, 0.0, 0.0][:b]


# every kernel at D = 40, each also at one of D = 80 and 160 (each Pallas
# call compiles in interpret mode: the file stays small)
BF16_CASES = ([(name, SHAPES[0]) for name in KERNELS]
              + [(name, SHAPES[1]) for name in ("attn_fused", "attn2_nomask", "fwd2_lse")]
              + [(name, SHAPES[2]) for name in ("attn2_fused", "attn2_gated", "fwd_lse")])


@pytest.mark.parametrize("name,shape", BF16_CASES, ids=[f"{n}-D{sh[0]}" for n, sh in BF16_CASES])
def test_emulation_matches_jax_kernels_bf16(name, shape):
    """bf16: the emulation against the Pallas kernel and the port's plain
    version, by the bf16 rule; the LSE against both within 2e-5."""
    d, sq, sk, sb = shape
    b, bb, gates = _case(name, d, sq, sk, sb)
    arrs, ts = _inputs(d, sq, sk, sb, torch.bfloat16, b, bb, seed=10 * d)
    scale = d ** -0.5
    got, got_lse = _emulate(name, ts, scale, gates)
    assert got.dtype == torch.bfloat16 and got.shape == ts[0].shape
    want, want_lse = _jax_kernel(name, arrs, torch.bfloat16, scale, gates)
    ref, ref_lse = _port_ref(name, ts, scale, gates)
    _within(_np(got), want, torch.bfloat16)
    _within(_np(got), _np(ref), torch.bfloat16)
    if want_lse is not None:
        _within(_np(got_lse), want_lse, torch.float32)
        _within(_np(got_lse), _np(ref_lse), torch.float32)


@pytest.mark.parametrize("name", KERNELS)
def test_emulation_matches_jax_kernels_fp32(name):
    """fp32 at D = 40, ragged lengths: the emulation's blocked arithmetic
    with the exact exponential against the Pallas kernel and the plain
    version within 2e-5 (the order of fp32 sums), output and LSE."""
    d, sq, sk, sb = SHAPES[0]
    b, bb, gates = _case(name, d, sq, sk, sb)
    arrs, ts = _inputs(d, sq, sk, sb, torch.float32, b, bb, seed=7)
    scale = d ** -0.5
    got, got_lse = _emulate(name, ts, scale, gates)
    want, want_lse = _jax_kernel(name, arrs, torch.float32, scale, gates)
    ref, ref_lse = _port_ref(name, ts, scale, gates)
    _within(_np(got), want, torch.float32)
    _within(_np(got), _np(ref), torch.float32)
    if want_lse is not None:
        _within(_np(got_lse), want_lse, torch.float32)
        _within(_np(got_lse), _np(ref_lse), torch.float32)


def test_emulation_masks_ragged_tiles_and_gates():
    """Controls: with the ragged tile's mask left out (its zero-filled keys
    entering the softmax) the emulation leaves the plain version; a row
    gated by 0 equals plain self-attention."""
    d, sq, sk, sb = SHAPES[0]
    _, ts = _inputs(d, sq, sk, sb, torch.float32, b=4, seed=12)
    q, k, v, kb, vb = ts
    want = K.two_source_attention_ref(q, k, v, kb, vb)
    pad = tile_keys(d) - sk % tile_keys(d)
    kz, vz = (torch.cat([t, t.new_zeros(t.shape[0], pad, H, d)], 1) for t in (k, v))
    unmasked, _ = hopper_emulation(q, kz, vz, kb, vb)
    assert (unmasked - want).abs().max().item() > 10 * FP32_TOL
    gate = torch.tensor([1.0, 0.0, 0.5, 0.0])
    got, _ = hopper_emulation(q, k, v, kb, vb, gate=gate)
    for row in (1, 3):
        plain = K.self_attention_ref(q[row:row + 1], k[row:row + 1], v[row:row + 1])
        assert (got[row:row + 1] - plain).abs().max().item() <= FP32_TOL


# --------------------------------------------------------------------------
# the body choice
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,width,packed,body", [
    (torch.bfloat16, 8, False, "wgmma"), (torch.bfloat16, 40, False, "wgmma"),
    (torch.bfloat16, 80, False, "wgmma"), (torch.bfloat16, 160, False, "wgmma"),
    (torch.bfloat16, 192, False, "wgmma"), (torch.bfloat16, 200, False, "mma_sync"),
    (torch.bfloat16, 256, False, "mma_sync"), (torch.bfloat16, 128, True, "wgmma"),
    (torch.bfloat16, 136, True, "mma_sync"), (torch.float32, 40, False, "cuda_core"),
    (torch.float32, 120, True, "cuda_core"),
])
def test_attention_body(dtype, width, packed, body):
    """bf16 A and B run the Hopper body up to D = 192, K9 up to G*D = 128,
    attention_tc above; fp32 the CUDA cores. One function decides."""
    assert A.attention_body(dtype, width, packed) == body
    A.check_body(body, dtype, width, packed)


# (width, Sq, key counts of the sources, body): the size rule on both sides
# of its edges (attention.py, WGMMA_MIN_KEYS / WGMMA_MIN_ROWS)
SIZE_CASES = [
    (40, 4096, (4096,), "wgmma"), (40, 4096, (77,), "mma_sync"), (40, 16, (16,), "mma_sync"),
    (40, 4096, (256,), "mma_sync"), (40, 4096, (256, 256), "wgmma"), (40, 16, (512,), "wgmma"),
    (40, 1024, (77, 77), "mma_sync"), (80, 16, (16,), "mma_sync"), (80, 64, (1024,), "mma_sync"),
    (80, 65, (16,), "wgmma"), (80, 16, (16, 16), "wgmma"), (160, 16, (16,), "wgmma"),
    (160, 256, (77,), "wgmma"), (256, 4096, (4096,), "mma_sync"),
]


@pytest.mark.parametrize("width,rows,keys,body", SIZE_CASES,
                         ids=[f"D{w}-Sq{r}-Sk{'+'.join(map(str, k))}" for w, r, k, _ in SIZE_CASES])
def test_attention_body_by_size(width, rows, keys, body):
    """bf16 A and B take the Hopper body only where it was measured the
    faster one: at D <= 48 over 512 keys or more in all, kernel A at 48 < D
    <= 80 over more than 64 query rows, always at wider heads up to 192;
    fp32 stays on the CUDA cores at any size."""
    assert A.attention_body(torch.bfloat16, width, rows=rows, keys=keys) == body
    assert A.attention_body(torch.float32, width, rows=rows, keys=keys) == "cuda_core"


def test_attention_body_refusals():
    with pytest.raises(ValueError):
        A.attention_body(torch.float16, 40)
    for body, dtype, width, packed in (("wgmma", torch.bfloat16, 200, False),
                                       ("wgmma", torch.bfloat16, 136, True),
                                       ("wgmma", torch.float32, 40, False),
                                       ("mma_sync", torch.float32, 40, False),
                                       ("cuda_core", torch.bfloat16, 40, False),
                                       ("tensor_cores", torch.bfloat16, 40, False)):
        with pytest.raises(ValueError):
            A.check_body(body, dtype, width, packed)


def test_named_bodies_on_the_cpu():
    """A named body must take the dtype and width, on the CPU as on the
    card; the CPU takes the plain version whichever body is named."""
    _, ts = _inputs(40, 70, 70, 70, torch.bfloat16, seed=13)
    q, k, v, kb, vb = ts
    for body in ("wgmma", "mma_sync"):
        assert torch.equal(K.self_attention(q, k, v, body=body), K.self_attention_ref(q, k, v))
        assert torch.equal(K.two_source_attention(q, k, v, kb, vb, body=body),
                           K.two_source_attention_ref(q, k, v, kb, vb))
        assert torch.equal(V.self_attention_lse(q, k, v, body=body)[1],
                           V.self_attention_lse_ref(q, k, v)[1])
    wide = torch.zeros(1, 16, 2, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        K.self_attention(wide, wide, wide, body="wgmma")
    with pytest.raises(ValueError):
        V.two_source_attention_lse(wide, wide, wide, wide, wide, body="wgmma")
    with pytest.raises(ValueError):
        K.self_attention(q.float(), k.float(), v.float(), body="mma_sync")


def test_launch_passes_the_chosen_body(monkeypatch):
    """The wrappers hand the C entries the body code: the Hopper body (2)
    at D <= 192 at the sizes where it is the faster body, attention_tc (1)
    above, below those sizes and for keys broadcast over rows (row stride
    0, which TMA cannot read), the CUDA cores (0) in fp32; operands
    broadcast over batch rows or heads stay on the Hopper body. The launch
    itself is replaced: the checks and the choice run on CPU tensors."""
    seen = []
    monkeypatch.setattr(A, "launch", lambda lib, counter, ref, lead, *rest: seen.append(
        (lib, lead[0])))
    bf = torch.bfloat16

    def qkv(d, b=2, s=70):
        return [torch.zeros(b, s, H, d, dtype=bf) for _ in range(3)]

    A.self_attention_cuda(*qkv(80), 0.1, False)
    A.self_attention_cuda(*qkv(256), 0.1, True)
    A.self_attention_cuda(*[t.float() for t in qkv(40)], 0.1, False)
    A.self_attention_cuda(*qkv(40), 0.1, False)  # 70 keys at D = 40
    q, k, v = qkv(40, s=520)
    A.two_source_attention_cuda(q, k, v, k[:1], v[:1], 0.1, False,
                                torch.ones(2))
    k_rows = torch.zeros(2, 1, H, 40, dtype=bf).expand(2, 520, H, 40)
    k_heads = torch.zeros(2, 520, 1, 40, dtype=bf).expand(2, 520, H, 40)
    k_batch = torch.zeros(1, 520, H, 40, dtype=bf).expand(2, 520, H, 40)
    assert not A.tma_readable(k_rows)
    assert A.tma_readable(k_heads) and A.tma_readable(k_batch)
    A.self_attention_cuda(q, k_rows, v, 0.1, False)
    A.self_attention_cuda(q, k_heads, k_batch, 0.1, False)
    assert seen == [("self_attention", 2), ("self_attention", 1), ("self_attention", 0),
                    ("self_attention", 1), ("two_source_attention", 2), ("self_attention", 1),
                    ("self_attention", 2)]
    with pytest.raises(ValueError):  # named, the Hopper body refuses what TMA cannot read
        A.self_attention_cuda(q, k_rows, v, 0.1, False, body="wgmma")
