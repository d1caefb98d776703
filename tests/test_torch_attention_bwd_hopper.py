"""The arithmetic of the Hopper body of the backward kernels C (dQ) and D
(dK/dV) (`csrc/attention_bwd_wgmma.cuh`), D's query split, and the choice of
body, on the CPU.

The CUDA body cannot run here, so its arithmetic is written out below as a
blocked emulation, step for step as the kernels take it. C: tiles of 128
keys up to the kernel's DQ_WIDE_TILE_KS and 64 above (read from its source),
the self source's tiles and then the bank's (a batch-1 bank read by every
query batch), each source's ragged last tile zero-filled and its keys masked;
P from the forward's LSE in the log2 domain (scale * log2(e) and lse *
log2(e) in one FMA), dS = P o (dP - delta) * scale in fp32 rounded to the
input dtype, dQ accumulated in fp32. D: tiles of 64 queries up to the
kernel's DKV_WIDE_TILE_KS and 32 above (read from its source), walked
over the key batch's queries, or over every batch's for a batch-1 source
(the sum over the frames in the accumulators), ragged tiles masked; P^T and
dS^T rounded to the input dtype before their products; the walk cut into
`nsplit` ranges of tiles as the kernel cuts it, each range's fp32 partial
sums added in split order. Both are held against the JAX package's Pallas
kernels (`flash_vjp.py::_dq_kernel` through `_core_dq`, `_dq2_kernel`
through `_core2_dq`, `_dkv_kernel` through `_core_dkv`), run in interpret
mode as tests/test_torch_flash_vjp.py runs them, and against the port's
plain versions. The card's side (each body against the plain version) is in
tests/test_torch_kernels_cuda.py.

Tolerances: fp32 2e-5 (the order of fp32 sums). bf16: max-abs <= min(1e-1,
0.1 x the RMS of the reference) (magicdance_tpu/ops/kernel_gate.py:52, the
rule of the card tests for gradients).
"""

import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from magicdance_tpu.ops.pallas import flash_vjp as JV
from magicdance_tpu_torch.ops.kernels import attention as A
from magicdance_tpu_torch.ops.kernels import flash_vjp as V
from torch_port_util import np_rand
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "magicdance_tpu_torch", "ops", "kernels", "csrc")
FP32_TOL = 2e-5
BF16_TOL = 1e-1
BF16_REL_TOL = 0.1
LOG2E = math.log2(math.e)
H = 2


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _constant(text: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


# the tile rules, read from the kernels' source
_BWD = _source("attention_bwd_wgmma.cuh")
DQ_WIDE_TILE_KS = _constant(_BWD, "DQ_WIDE_TILE_KS")
DKV_WIDE_TILE_KS = _constant(_BWD, "DKV_WIDE_TILE_KS")
MAX_DKV = _constant(_BWD, "MAX_DKV")
BLOCK_KEYS = 64 * _constant(_source("attention_wgmma.cuh"), "CONSUMERS")


def dq_tile_keys(d: int) -> int:
    """Keys per K/V tile of C's Hopper body (attention_bwd_wgmma.cuh)."""
    return 128 if (d + 15) // 16 <= DQ_WIDE_TILE_KS else 64


def dkv_tile_queries(d: int) -> int:
    """Queries per Q/dO tile of D's Hopper body (attention_bwd_wgmma.cuh)."""
    return 64 if (d + 15) // 16 <= DKV_WIDE_TILE_KS else 32


def _pad_rows(t: torch.Tensor, r0: int, n: int) -> torch.Tensor:
    """Rows r0 .. r0 + n of a (B, H, S, D) tensor, rows past S zero-filled
    (TMA's out-of-bounds fill)."""
    out = t.new_zeros(*t.shape[:2], n, t.shape[3])
    part = t[:, :, r0:r0 + n]
    out[:, :, :part.shape[2]] = part
    return out


def _bhsd(t: torch.Tensor) -> torch.Tensor:
    return t.float().permute(0, 2, 1, 3)


def dq_emulation(q, k, v, dout, lse, delta, scale, kb=None, vb=None):
    """Kernel C (bank kb/vb of batch 1 or B) as the Hopper body computes it,
    in the input dtype's rounding. Returns dQ (B, Sq, H, D) in q's dtype."""
    b, sq, h, d = q.shape
    tile = dq_tile_keys(d)
    c = scale * LOG2E
    qf, dof = _bhsd(q), _bhsd(dout)
    lse2, dl = (lse * LOG2E)[..., None], delta[..., None]
    acc = torch.zeros(b, h, sq, d)
    for ks, vs in [(k, v)] + ([(kb, vb)] if kb is not None else []):
        kf, vf = (_bhsd(t).expand(b, -1, -1, -1) for t in (ks, vs))  # batch 1: coordinate 0
        for t0 in range(0, ks.shape[1], tile):
            nk = min(tile, ks.shape[1] - t0)
            kt, vt = _pad_rows(kf, t0, tile), _pad_rows(vf, t0, tile)
            p = torch.exp2(qf @ kt.transpose(-1, -2) * c - lse2)
            p[..., nk:] = 0.0
            dp = dof @ vt.transpose(-1, -2)
            ds = (p * (dp - dl) * scale).to(q.dtype).float()
            acc = acc + ds @ kt
    return acc.permute(0, 2, 1, 3).to(q.dtype)


def split_ranges(tiles: int, nsplit: int) -> list:
    """The query tiles each split of D's Hopper body walks (the kernel's t0,
    t1)."""
    return [(tiles * s // nsplit, tiles * (s + 1) // nsplit) for s in range(nsplit)]


def dkv_emulation(k, v, q, dout, lse, delta, scale, nsplit=1):
    """Kernel D (a source of batch 1 or B) as the Hopper body computes it:
    each split's fp32 partials, then their sum in split order, rounded to
    the input dtype. Returns (dK, dV) of k's shape."""
    bq, sq, h, d = q.shape
    bk = k.shape[0]
    shared = bk == 1 and bq > 1
    c = scale * LOG2E
    tile = dkv_tile_queries(d)
    tpb = -(-sq // tile)
    kf, vf = _bhsd(k), _bhsd(v)
    qf, dof = _bhsd(q), _bhsd(dout)
    lse2 = lse * LOG2E
    parts = []
    for t0, t1 in split_ranges((bq if shared else 1) * tpb, nsplit):
        dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
        for t in range(t0, t1):
            bi, ti = divmod(t, tpb)
            rows = slice(bi, bi + 1) if shared else slice(None)  # the queries' batches
            q0 = ti * tile
            nq = min(tile, sq - q0)
            qt, dot = _pad_rows(qf[rows], q0, tile), _pad_rows(dof[rows], q0, tile)
            l2 = lse2.new_zeros(qt.shape[0], h, tile)
            dl = l2.clone()
            l2[..., :nq], dl[..., :nq] = lse2[rows, :, q0:q0 + nq], delta[rows, :, q0:q0 + nq]
            pt = torch.exp2(kf @ qt.transpose(-1, -2) * c - l2[:, :, None])
            pt[..., nq:] = 0.0
            dv = dv + pt.to(q.dtype).float() @ dot
            dst = pt * (vf @ dot.transpose(-1, -2) - dl[:, :, None]) * scale
            dk = dk + dst.to(q.dtype).float() @ qt
        parts.append((dk, dv))
    dk, dv = parts[0]
    for pk, pv in parts[1:]:
        dk, dv = dk + pk, dv + pv
    return tuple(t.permute(0, 2, 1, 3).to(k.dtype) for t in (dk, dv))


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


def _core(t: torch.Tensor, dtype) -> jnp.ndarray:
    """(B, S, H, D) -> the JAX core layout (B*H, S, D) in the test's dtype."""
    b, s, h, d = t.shape
    x = t.float().permute(0, 2, 1, 3).reshape(b * h, s, d).numpy()
    return jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


def _from_core(x, b: int) -> np.ndarray:
    x = np.asarray(jnp.asarray(x, jnp.float32))
    bh, s, d = x.shape
    return x.reshape(b, bh // b, s, d).transpose(0, 2, 1, 3)


def _inputs(d, sq, sk, sb, dtype, b=2, bank_batch=1, seed=0):
    """q, k, v, dout, kb, vb (bank batch `bank_batch`, None for no bank) and
    the forward's fp32 lse and delta from the plain versions."""
    q, dout = (torch.from_numpy(np_rand((b, sq, H, d), seed + i)).to(dtype) for i in (0, 1))
    k, v = (torch.from_numpy(np_rand((b, sk, H, d), seed + i)).to(dtype) for i in (2, 3))
    kb = vb = None
    if bank_batch:
        kb, vb = (torch.from_numpy(np_rand((bank_batch, sb, H, d), seed + i)).to(dtype)
                  for i in (4, 5))
        out, lse = V.two_source_attention_lse_ref(q, k, v, kb, vb)
    else:
        out, lse = V.self_attention_lse_ref(q, k, v)
    return q, k, v, dout, kb, vb, lse, V.attention_delta(dout, out)


# (dtype, D, Sq, Sk, Sb, bank batch: None, 1 or "B"): lengths off the 64-
# and 128-row tiles (ragged last tiles), with power-of-two divisors so that
# the Pallas kernels' blocks stay few; D = 40 takes one partial 64-column
# box, 80 a full and a partial one. Each Pallas call compiles in interpret
# mode (about a second a shape): where a bank has the self source's length
# its dK/dV call reuses the compilation.
BF, F32 = torch.bfloat16, torch.float32
CASES = [(BF, 40, 96, 80, 0, None), (BF, 40, 80, 208, 48, 1), (BF, 80, 144, 80, 80, "B"),
         (F32, 40, 96, 80, 0, None), (F32, 40, 80, 208, 48, 1)]


@pytest.mark.parametrize("dtype,d,sq,sk,sb,bank", CASES,
                         ids=[f"{'bf16' if c[0] == BF else 'fp32'}-D{c[1]}-bank{c[5]}"
                              for c in CASES])
def test_emulation_matches_jax_kernels(dtype, d, sq, sk, sb, bank):
    """C and D (every source whose gradient the kernels give) as the
    emulation computes them against the Pallas kernels in interpret mode and
    the port's plain versions: bf16 by the gradient rule, fp32 within
    2e-5."""
    b = 2
    bb = {None: None, 1: 1, "B": b}[bank]
    q, k, v, dout, kb, vb, lse, delta = _inputs(d, sq, sk, sb, dtype, b, bb, seed=d + sk)
    scale = d ** -0.5
    got = dq_emulation(q, k, v, dout, lse, delta, scale, kb, vb)
    assert got.dtype == dtype and got.shape == q.shape
    with pltpu.force_tpu_interpret_mode():
        if kb is None:
            want = JV._core_dq(*(_core(t, dtype) for t in (q, k, v, dout)), scale=scale)
        else:
            want = JV._core2_dq(*(_core(t, dtype) for t in (q, k, v, kb, vb, dout)),
                                scale=scale)
    _within(_np(got), _from_core(want, b), dtype)
    _within(_np(got), _np(V.attention_dq_ref(q, k, v, dout, lse, delta, scale, kb, vb)), dtype)

    rows = jnp.asarray(lse.reshape(b * H, 1, sq).numpy())
    drows = jnp.asarray(delta.reshape(b * H, 1, sq).numpy())
    for kk, vv in [(k, v)] + ([(kb, vb)] if kb is not None else []):
        got_dk, got_dv = dkv_emulation(kk, vv, q, dout, lse, delta, scale)
        with pltpu.force_tpu_interpret_mode():
            kx, vx = (_core(t.expand(b, -1, -1, -1), dtype) for t in (kk, vv))
            dk, dv = JV._core_dkv(kx, vx, _core(q, dtype), _core(dout, dtype), rows, drows,
                                  scale=scale)
        dk, dv = _from_core(dk, b), _from_core(dv, b)
        if kk.shape[0] != b:  # a batch-1 bank: JAX sums its per-frame result
            dk, dv = dk.sum(0, keepdims=True), dv.sum(0, keepdims=True)
        ref_dk, ref_dv = V.attention_dkv_ref(kk, vv, q, dout, lse, delta, scale)
        for g_, w_, r_ in ((got_dk, dk, ref_dk), (got_dv, dv, ref_dv)):
            assert g_.dtype == dtype and g_.shape == kk.shape
            _within(_np(g_), w_, dtype)
            _within(_np(g_), _np(r_), dtype)


@pytest.mark.parametrize("shared", [False, True], ids=["own-batch", "batch-1-source"])
def test_split_partials_sum_in_order(shared):
    """D's query split: the splits' ranges cover every tile once; each
    split's fp32 partials summed in split order give the unsplit result
    within 2e-5 (fp32) and the same bits on a second run; a batch-1 source's
    walk crosses the batches."""
    for tiles, nsplit in ((64, 8), (16, 3), (5, 4), (4, 4)):
        ranges = split_ranges(tiles, nsplit)
        assert ranges[0][0] == 0 and ranges[-1][1] == tiles
        assert all(a[1] == b_[0] and a[0] <= a[1] for a, b_ in zip(ranges, ranges[1:]))
    q, k, v, dout, _, _, lse, delta = _inputs(40, 200, 150, 0, torch.float32, b=3,
                                              bank_batch=None, seed=5)
    if shared:
        k, v = k[:1], v[:1]
    scale = 40 ** -0.5
    whole = dkv_emulation(k, v, q, dout, lse, delta, scale)
    ref = V.attention_dkv_ref(k, v, q, dout, lse, delta, scale)
    for g_, r_ in zip(whole, ref):
        _within(_np(g_), _np(r_), torch.float32)
    for nsplit in (2, 3, 5):
        got = dkv_emulation(k, v, q, dout, lse, delta, scale, nsplit)
        again = dkv_emulation(k, v, q, dout, lse, delta, scale, nsplit)
        for g_, a_, w_ in zip(got, again, whole):
            assert torch.equal(g_, a_)
            _within(_np(g_), _np(w_), torch.float32)


@pytest.mark.parametrize("bk,sk,heads,queries,nsplit", [
    (2, 77, 8, 4096, 8),     # the "flash" 77-key cross-attention at (2, 4096): 16 blocks
    (2, 77, 8, 1024, 4),     # the same at (2, 1024): 256 queries a split at least
    (2, 1024, 8, 1024, 1),   # 128 blocks: one wave already
    (8, 16, 8, 256, 1),      # 64 blocks of 256 queries: no split
    (2, 256, 8, 256, 1),     # (2, 256, 160): 32 blocks of 256 queries
    (1, 4096, 8, 65536, 1),  # 256 blocks
    (1, 16, 8, 4096, 16),    # a batch-1 source read by 16 batches of 256 queries
])
def test_dkv_split_rule(bk, sk, heads, queries, nsplit):
    """Splits fill one wave of 132 SMs (one block each) where the key
    blocks leave SMs idle, each split walking at least SPLIT_MIN_QUERIES
    queries."""
    assert V.dkv_split(bk, sk, heads, queries) == nsplit
    assert V.DKV_BLOCK_KEYS == BLOCK_KEYS
    assert A.WGMMA_MAX_DKV == MAX_DKV


# --------------------------------------------------------------------------
# the body choice
# --------------------------------------------------------------------------

# (kernel, width, query rows, key counts, body): the size rule on both sides
# of its edges (attention.py, DQ_MIN_KEYS_NARROW / DQ_MIN_KEYS /
# DKV_MIN_ROWS) and the widths each Hopper body takes
SIZE_CASES = [
    ("dq", 40, 4096, (4096,), "wgmma"), ("dq", 40, 4096, (77,), "mma_sync"),
    ("dq", 40, 4096, (64, 64), "mma_sync"), ("dq", 40, 4096, (77, 77), "wgmma"),
    ("dq", 40, 16, (16,), "mma_sync"), ("dq", 80, 1024, (77,), "wgmma"),
    ("dq", 80, 1024, (64,), "mma_sync"), ("dq", 80, 16, (16, 16), "mma_sync"),
    ("dq", 160, 16, (16,), "wgmma"), ("dq", 192, 256, (256,), "wgmma"),
    ("dq", 200, 256, (256,), "mma_sync"),
    ("dkv", 40, 4096, (4096,), "wgmma"), ("dkv", 40, 4096, (77,), "wgmma"),
    ("dkv", 40, 64, (4096,), "mma_sync"), ("dkv", 40, 256, (16,), "wgmma"),
    ("dkv", 80, 16, (16,), "mma_sync"), ("dkv", 96, 1024, (1024,), "wgmma"),
    ("dkv", 160, 4096, (4096,), "wgmma"), ("dkv", 192, 4096, (4096,), "mma_sync"),
]


@pytest.mark.parametrize("kernel,width,rows,keys,body", SIZE_CASES,
                         ids=[f"{c[0]}-D{c[1]}-Sq{c[2]}-Sk{'+'.join(map(str, c[3]))}"
                              for c in SIZE_CASES])
def test_backward_body_by_size(kernel, width, rows, keys, body):
    """bf16 C takes the Hopper body up to D = 192 over more than one of its
    key tiles (more than 128 keys at D <= 48, more than 64 up to D = 80,
    any above); D up to D = 160 over 256 query rows walked a block or more;
    fp32 stays on the CUDA cores."""
    assert A.attention_body(torch.bfloat16, width, rows=rows, keys=keys, kernel=kernel) == body
    assert A.attention_body(torch.float32, width, rows=rows, keys=keys,
                            kernel=kernel) == "cuda_core"
    assert A.attention_body(torch.bfloat16, width, kernel=kernel) == (
        "wgmma" if width <= {"dq": A.WGMMA_MAX_DQ, "dkv": A.WGMMA_MAX_DKV}[kernel]
        else "mma_sync")


def test_backward_body_refusals():
    for body, dtype, width, kernel in (("wgmma", torch.bfloat16, 200, "dq"),
                                       ("wgmma", torch.bfloat16, 168, "dkv"),
                                       ("wgmma", torch.float32, 40, "dq"),
                                       ("mma_sync", torch.float32, 40, "dkv"),
                                       ("cuda_core", torch.bfloat16, 40, "dq")):
        with pytest.raises(ValueError):
            A.check_body(body, dtype, width, kernel=kernel)
    A.check_body("wgmma", torch.bfloat16, 160, kernel="dkv")
    A.check_body("wgmma", torch.bfloat16, 192, kernel="dq")
    with pytest.raises(ValueError):
        A.attention_body(torch.bfloat16, 40, kernel="backward")


def test_named_backward_bodies_on_the_cpu():
    """A named body must take the dtype and width, on the CPU as on the
    card; the CPU takes the plain version whichever body is named."""
    q, k, v, dout, kb, vb, lse, delta = _inputs(40, 70, 70, 70, torch.bfloat16, seed=13)
    for body in ("wgmma", "mma_sync"):
        assert torch.equal(V.attention_dq(q, k, v, dout, lse, delta, None, kb, vb, body=body),
                           V.attention_dq_ref(q, k, v, dout, lse, delta, None, kb, vb))
        for g_, w_ in zip(V.attention_dkv(k, v, q, dout, lse, delta, body=body),
                          V.attention_dkv_ref(k, v, q, dout, lse, delta)):
            assert torch.equal(g_, w_)
    wide = torch.zeros(1, 16, 2, 192, dtype=torch.bfloat16)
    rows = torch.zeros(1, 2, 16)
    V.attention_dq(wide, wide, wide, wide, rows, rows, body="wgmma")
    with pytest.raises(ValueError):
        V.attention_dkv(wide, wide, wide, wide, rows, rows, body="wgmma")
    with pytest.raises(ValueError):
        V.attention_dq(q.float(), k.float(), v.float(), dout.float(), lse, delta,
                       body="mma_sync")


def test_launch_passes_the_chosen_backward_body(monkeypatch):
    """The wrappers hand the C entries the body code and D's split: the
    Hopper body (2) where the size rule picks it, with D's split and its
    fp32 scratch where the grid would leave SMs idle; the mma.sync body (1)
    below the sizes, for keys broadcast over rows
    and for lse rows TMA cannot read (Sq not a multiple of 4); the CUDA
    cores (0) in fp32. The launch itself is replaced: the checks and the
    choice run on CPU tensors."""
    seen = []
    monkeypatch.setattr(V, "launch", lambda lib, counter, ref, lead, args, *rest: seen.append(
        (lib, counter, tuple(lead), None if lib == "attention_dq" or args[-1] is None
         else args[-1].numel())))
    bf = torch.bfloat16

    def qkv(d, b=2, s=256, sk=None, dtype=bf):
        q, dout = (torch.zeros(b, s, H, d, dtype=dtype) for _ in range(2))
        k, v = (torch.zeros(b, sk or s, H, d, dtype=dtype) for _ in range(2))
        return q, k, v, dout, torch.zeros(b, H, s), torch.zeros(b, H, s)

    q, k, v, dout, lse, delta = qkv(40, s=4096, sk=77)
    V.attention_dq_cuda(q, k, v, dout, lse, delta, 0.1)              # 77 keys at D = 40
    V.attention_dq_cuda(q, k, v, dout, lse, delta, 0.1, k, v)        # 154 keys
    V.attention_dkv_cuda(k, v, q, dout, lse, delta, 0.1)             # 4 blocks: 16 splits
    V.attention_dkv_cuda(k, v, q, dout, lse, delta, 0.1, nsplit=1)
    q, k, v, dout, lse, delta = qkv(160)
    V.attention_dq_cuda(q, k, v, dout, lse, delta, 0.1)
    V.attention_dkv_cuda(k, v, q, dout, lse, delta, 0.1)             # 256 queries: no split
    q, k, v, dout, lse, delta = qkv(40, s=1030, sk=390)
    V.attention_dkv_cuda(k, v, q, dout, lse, delta, 0.1)             # lse rows off 16 bytes
    q, k, v, dout, lse, delta = qkv(40, s=256)
    k_rows = torch.zeros(2, 1, H, 40, dtype=bf).expand(2, 256, H, 40)
    V.attention_dq_cuda(q, k_rows, v, dout, lse, delta, 0.1)
    V.attention_dkv_cuda(k_rows, v, q, dout, lse, delta, 0.1)
    V.attention_dkv_cuda(k[:1], v[:1], q, dout, lse, delta, 0.1)     # batch-1 source: 512 rows
    q, k, v, dout, lse, delta = qkv(40, s=256, dtype=torch.float32)
    V.attention_dq_cuda(q, k, v, dout, lse, delta, 0.1)
    V.attention_dkv_cuda(k, v, q, dout, lse, delta, 0.1)
    assert seen == [
        ("attention_dq", "attention_dq", (1, 1), None),
        ("attention_dq", "attention_dq_two_source", (2, 2), None),
        ("attention_dkv", "attention_dkv", (2, 16), 2 * 16 * 2 * 77 * H * 40),
        ("attention_dkv", "attention_dkv", (2, 1), None),
        ("attention_dq", "attention_dq", (2, 1), None),
        ("attention_dkv", "attention_dkv", (2, 1), None),
        ("attention_dkv", "attention_dkv", (1, 1), None),
        ("attention_dq", "attention_dq", (1, 1), None),
        ("attention_dkv", "attention_dkv", (1, 1), None),
        ("attention_dkv", "attention_dkv", (2, 2), 2 * 2 * 1 * 256 * H * 40),
        ("attention_dq", "attention_dq", (0, 1), None),
        ("attention_dkv", "attention_dkv", (0, 1), None),
    ]
    q, k, v, dout, lse, delta = qkv(40, s=1030, sk=390)
    with pytest.raises(ValueError):  # named, the Hopper body refuses what TMA cannot read
        V.attention_dkv_cuda(k, v, q, dout, lse, delta, 0.1, body="wgmma")
    with pytest.raises(ValueError):  # only the Hopper body splits
        V.attention_dkv_cuda(k, v, q, dout, lse, delta, 0.1, body="mma_sync", nsplit=2)
