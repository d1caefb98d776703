"""Differentiable attention: the training forward (kernels A/B with the
log-sum-exp output), kernel C (dQ) and kernel D (dK/dV), their plain
PyTorch versions, and the autograd Functions that tie them together.

Counterpart of `magicdance_tpu.ops.pallas.flash_vjp`:

  * `self_attention_lse` / `two_source_attention_lse` -- `_fwd_lse_kernel` /
    `_fwd2_lse_kernel`: the attention output plus each query row's
    log-sum-exp of the (joint) logits, fp32, laid out (B, H, Sq).
  * `attention_dq` -- `_dq_kernel` / `_dq2_kernel`: dQ for one source or for
    the two sources of a bank read (P, dP and delta over both).
  * `attention_dkv` -- `_dkv_kernel`: dK/dV of one K/V source. It serves the
    self source and the bank source alike; a batch-1 bank's dK/dV come out
    summed over the query batch (JAX sums its B-fold result afterwards).
  * `mha`, `mha_packed`, `mha_two_source`, `mha_two_source_packed` -- the
    custom-VJP entry points, as `torch.autograd.Function`s.
  * `mha_grouped` -- the custom VJP of JAX's `mha_grouped`: grouped
    (temporal) attention whose backward is the grouped kernel's
    (`ops.kernels.grouped`); it keeps q, k and v only and recomputes the
    probabilities, as JAX does.

delta = rowsum(dO o O) is a plain torch reduction (`attention_delta`), as JAX
computes it in XLA (`_delta`). Unlike the Pallas dQ kernel, which recomputes
the softmax statistics from a whole K row, kernel C reads the forward's LSE.

Bodies. bf16 C and D run the Hopper body (`csrc/attention_bwd_wgmma.cuh`,
C up to D = 192, D up to 160) where `attention.attention_body` picks it, and
the mma.sync body otherwise; fp32 runs on the CUDA cores. `body=` names one
as for kernels A and B. Where kernel D's grid would not fill the card
(`dkv_split`), its Hopper body splits the query walk over several blocks,
which write fp32 partial sums into a scratch buffer the wrapper allocates;
a second kernel sums them in a fixed order, so two runs on the same inputs
give the same bits (no atomics in C or D).

The wrapper rule is the one of `ops.kernels.attention`: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises, and each launch
adds one to `LAUNCHES[<mode>]`. The plain versions mirror the JAX kernels'
arithmetic: fp32 logits, P cast to dO's dtype before dV = P^T dO, dS cast to
the input dtype before dQ = dS K and dK = dS^T Q.

Layout: BSNH (B, S, H, D) with unit stride over D; a packed (B, S, H*D)
projection output viewed as (B, S, H, D) is the same memory. Gradients come
back as new contiguous (B, S, H, D) tensors in the input dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from magicdance_tpu_torch.ops.kernels.attention import (
    BODIES,
    _check_operand,
    _check_q,
    _pick_body,
    _strides,
    check_body,
    launch,
    self_attention_cuda,
    two_source_attention_cuda,
)
from magicdance_tpu_torch.ops.kernels.grouped import grouped_attention, grouped_attention_bwd
from magicdance_tpu_torch.utils.profiling import dims, span

# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _bank_views(q: torch.Tensor, k_bank: torch.Tensor, v_bank: torch.Tensor):
    """A batch-1 bank read by B > 1 query batches is contracted without its
    batch axis (never tiled); returns (kb, vb, shared)."""
    shared = k_bank.shape[0] == 1 and q.shape[0] != 1
    return (k_bank[0], v_bank[0], True) if shared else (k_bank, v_bank, False)


def _logits(q: torch.Tensor, k: torch.Tensor, shared: bool, scale: float) -> torch.Tensor:
    eq = "bqhd,khd->bhqk" if shared else "bqhd,bkhd->bhqk"
    return torch.einsum(eq, q.float(), k.float()) * scale


def _pv(p: torch.Tensor, v: torch.Tensor, shared: bool) -> torch.Tensor:
    eq = "bhqk,khd->bqhd" if shared else "bhqk,bkhd->bqhd"
    return torch.einsum(eq, p.to(v.dtype).float(), v.float())


def self_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: Optional[float] = None):
    """(out, lse): softmax(q k^T * scale) v in q's dtype and the row
    log-sum-exp (B, H, Sq) fp32. Mirrors `_fwd_lse_kernel`: unnormalized
    probabilities cast to v's dtype, divided after the PV product."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = _logits(q, k, False, scale)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    denom = p.sum(-1, keepdim=True)
    out = _pv(p, v, False) / denom.permute(0, 2, 1, 3)
    return out.to(q.dtype), (m + torch.log(denom))[..., 0]


def two_source_attention_lse_ref(q: torch.Tensor, k_self: torch.Tensor,
                                 v_self: torch.Tensor, k_bank: torch.Tensor,
                                 v_bank: torch.Tensor, scale: Optional[float] = None):
    """(out, lse) of the joint softmax over [self keys ; bank keys];
    mirrors `_fwd2_lse_kernel`. The bank batch is 1 or B."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    kb, vb, shared = _bank_views(q, k_bank, v_bank)
    l_s = _logits(q, k_self, False, scale)
    l_b = _logits(q, kb, shared, scale)
    m = torch.maximum(l_s.amax(-1, keepdim=True), l_b.amax(-1, keepdim=True))
    p_s, p_b = torch.exp(l_s - m), torch.exp(l_b - m)
    denom = p_s.sum(-1, keepdim=True) + p_b.sum(-1, keepdim=True)
    out = (_pv(p_s, v_self, False) + _pv(p_b, vb, shared)) / denom.permute(0, 2, 1, 3)
    return out.to(q.dtype), (m + torch.log(denom))[..., 0]


def attention_delta(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO o O) in fp32, laid out (B, H, Sq) like the LSE."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _ds(q, k, v, dout, lse, delta, shared, scale):
    """dS = P o (dO V^T - delta) * scale for one source, P from the LSE."""
    p = torch.exp(_logits(q, k, shared, scale) - lse[..., None])
    eq = "bqhd,khd->bhqk" if shared else "bqhd,bkhd->bhqk"
    dp = torch.einsum(eq, dout.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def attention_dq_ref(q: torch.Tensor, k_self: torch.Tensor, v_self: torch.Tensor,
                     dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                     scale: Optional[float] = None,
                     k_bank: Optional[torch.Tensor] = None,
                     v_bank: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dQ of self-attention, or of a bank read when k_bank/v_bank are given
    (mirrors `_dq_kernel` / `_dq2_kernel`, with P from the LSE): dS is cast
    to the key dtype before the dS K product, which accumulates in fp32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    sources = [(k_self, v_self, False)]
    if k_bank is not None:
        kb, vb, shared = _bank_views(q, k_bank, v_bank)
        sources.append((kb, vb, shared))
    dq = 0.0
    for k, v, shared in sources:
        _, ds = _ds(q, k, v, dout, lse, delta, shared, scale)
        eq = "bhqk,khd->bqhd" if shared else "bhqk,bkhd->bqhd"
        dq = dq + torch.einsum(eq, ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def attention_dkv_ref(k: torch.Tensor, v: torch.Tensor, q: torch.Tensor,
                      dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                      scale: Optional[float] = None):
    """(dK, dV) of one K/V source (mirrors `_dkv_kernel`): dV = P^T dO with P
    cast to dO's dtype, dK = dS^T Q with dS cast to Q's dtype. A batch-1
    source read by B > 1 query batches gets the sum over the batches."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    shared = k.shape[0] == 1 and q.shape[0] != 1
    kk, vv = (k[0], v[0]) if shared else (k, v)
    p, ds = _ds(q, kk, vv, dout, lse, delta, shared, scale)
    eq = "bhqk,bqhd->khd" if shared else "bhqk,bqhd->bkhd"
    dv = torch.einsum(eq, p.to(dout.dtype).float(), dout.float())
    dk = torch.einsum(eq, ds.to(q.dtype).float(), q.float())
    if shared:
        dk, dv = dk[None], dv[None]
    return dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------------
# wrappers: plain version on the CPU, the kernel on CUDA
# --------------------------------------------------------------------------


def self_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: Optional[float] = None, body: Optional[str] = None):
    """Kernel A with the LSE output. Returns (out (B, Sq, H, D), lse (B, H, Sq)).
    `body` as for `attention.self_attention`."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if body is not None:
        check_body(body, q.dtype, q.shape[-1])
    if q.device.type == "cpu":
        return self_attention_lse_ref(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"self_attention_lse: unsupported device {q.device}")
    return self_attention_cuda(q, k, v, scale, with_lse=True, body=body)


def two_source_attention_lse(q: torch.Tensor, k_self: torch.Tensor,
                             v_self: torch.Tensor, k_bank: torch.Tensor,
                             v_bank: torch.Tensor, scale: Optional[float] = None,
                             body: Optional[str] = None):
    """Kernel B with the joint LSE output. Returns (out, lse (B, H, Sq)).
    `body` as for `attention.self_attention`."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if body is not None:
        check_body(body, q.dtype, q.shape[-1])
    if q.device.type == "cpu":
        return two_source_attention_lse_ref(q, k_self, v_self, k_bank, v_bank, scale)
    if q.device.type != "cuda":
        raise ValueError(f"two_source_attention_lse: unsupported device {q.device}")
    return two_source_attention_cuda(q, k_self, v_self, k_bank, v_bank, scale,
                                     with_lse=True, body=body)


def _check_rows(name: str, t: torch.Tensor, q: torch.Tensor) -> None:
    b, sq, h, _ = q.shape
    if (t.dtype != torch.float32 or t.device != q.device
            or tuple(t.shape) != (b, h, sq) or not t.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous float32 (B, H, Sq) = "
                         f"{(b, h, sq)} tensor on {q.device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


# Kernel D's Hopper body: keys a block owns (csrc/attention_bwd_wgmma.cuh,
# BM). One of its blocks fills an SM; where the key blocks leave SMs idle
# the query walk is split so that one wave fills the card, each split
# walking at least SPLIT_MIN_QUERIES queries (my sweep runs, PR 17,
# PERF.md: 77 keys at (2, 4096, 40), 16
# blocks, 0.0678-0.0688 ms unsplit, 0.0183-0.0186 in 8 splits of 512
# queries, one wave; splits of 128 queries lost to the second kernel's
# launch: D = 80, 64 blocks, 0.0103-0.0115 ms unsplit, 0.0129-0.0193 in
# two; D = 160, 32 blocks, 0.0201 unsplit, 0.0306 in two).
DKV_BLOCK_KEYS = 128
SMS = 132
SPLIT_MIN_QUERIES = 256


def dkv_split(bk: int, sk: int, heads: int, queries: int) -> int:
    """Query splits of kernel D's Hopper body for `bk` key batches of `sk`
    keys and `heads` heads, each key block walking `queries` queries (those
    of every batch for a batch-1 source)."""
    blocks = -(-sk // DKV_BLOCK_KEYS) * heads * bk
    return max(1, min(SMS // blocks, queries // SPLIT_MIN_QUERIES))


def attention_dq(q: torch.Tensor, k_self: torch.Tensor, v_self: torch.Tensor,
                 dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 scale: Optional[float] = None,
                 k_bank: Optional[torch.Tensor] = None,
                 v_bank: Optional[torch.Tensor] = None,
                 body: Optional[str] = None) -> torch.Tensor:
    """Kernel C: dQ (B, Sq, H, D) of self-attention, or of a bank read when
    k_bank/v_bank (bank batch 1 or B) are given. On the card `body`
    defaults to `attention_body`'s choice (kernel "dq"); another body that
    can take the dtype and width may be named (checked on the CPU too, where
    the plain version runs whichever is named)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if body is not None:
        check_body(body, q.dtype, q.shape[-1], kernel="dq")
    if q.device.type == "cpu":
        return attention_dq_ref(q, k_self, v_self, dout, lse, delta, scale,
                                k_bank, v_bank)
    if q.device.type != "cuda":
        raise ValueError(f"attention_dq: unsupported device {q.device}")
    return attention_dq_cuda(q, k_self, v_self, dout, lse, delta, scale, k_bank, v_bank, body)


def attention_dq_cuda(q, k_self, v_self, dout, lse, delta, scale: float, k_bank=None,
                      v_bank=None, body: Optional[str] = None) -> torch.Tensor:
    """Launch kernel C on CUDA tensors on `body` (default:
    `attention_body`'s choice for kernel "dq")."""
    _check_q(q)
    b, sq, h, d = q.shape
    _check_operand("q", q, q, (b,), sq)
    _check_operand("dout", dout, q, (b,), sq)
    _check_operand("k_self", k_self, q, (b,), None)
    _check_operand("v_self", v_self, q, (b,), k_self.shape[1])
    _check_rows("lse", lse, q)
    _check_rows("delta", delta, q)
    two = k_bank is not None
    if two:
        _check_operand("k_bank", k_bank, q, (1, b), None)
        _check_operand("v_bank", v_bank, q, (k_bank.shape[0],), k_bank.shape[1])
        bank_batched = k_bank.shape[0] == b and b > 1
        bank_strides = _strides(k_bank, bank_batched) + _strides(v_bank, bank_batched)
        sb = k_bank.shape[1]
    else:
        bank_strides, sb = [0] * 6, 0
    sources = ((k_self, v_self),) + (((k_bank, v_bank),) if two else ())
    body = _pick_body("attention_dq", body, q, sources, kernel="dq", more=(dout,))
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    strides = (_strides(q) + _strides(k_self) + _strides(v_self) + bank_strides
               + _strides(dout) + _strides(dq))
    launch("attention_dq", "attention_dq_two_source" if two else "attention_dq",
           q, [BODIES[body], 2 if two else 1],
           [q, k_self, v_self, k_bank, v_bank, dout, lse, delta, dq],
           strides, [b, h, d, sq, k_self.shape[1], sb], scale)
    return dq


def attention_dkv(k: torch.Tensor, v: torch.Tensor, q: torch.Tensor,
                  dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  scale: Optional[float] = None, body: Optional[str] = None,
                  nsplit: Optional[int] = None):
    """Kernel D: (dK, dV) of one K/V source of batch 1 or B; a batch-1
    source read by B > 1 query batches gets the sum over the batches.
    `body` as for `attention_dq` (kernel "dkv"); `nsplit`: query splits of
    the Hopper body (default `dkv_split`'s; the mma.sync body takes 1)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if body is not None:
        check_body(body, q.dtype, q.shape[-1], kernel="dkv")
    if q.device.type == "cpu":
        return attention_dkv_ref(k, v, q, dout, lse, delta, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention_dkv: unsupported device {q.device}")
    return attention_dkv_cuda(k, v, q, dout, lse, delta, scale, body, nsplit)


def attention_dkv_cuda(k, v, q, dout, lse, delta, scale: float, body: Optional[str] = None,
                       nsplit: Optional[int] = None):
    """Launch kernel D on CUDA tensors on `body` (default:
    `attention_body`'s choice for kernel "dkv") in `nsplit` query splits
    (default: `dkv_split`'s on the Hopper body, else 1)."""
    _check_q(q)
    b, sq, h, d = q.shape
    _check_operand("q", q, q, (b,), sq)
    _check_operand("dout", dout, q, (b,), sq)
    _check_operand("k", k, q, (1, b), None)
    _check_operand("v", v, q, (k.shape[0],), k.shape[1])
    _check_rows("lse", lse, q)
    _check_rows("delta", delta, q)
    bk, sk = k.shape[0], k.shape[1]
    body = _pick_body("attention_dkv", body, q, ((k, v),), kernel="dkv", more=(dout,),
                      rows=(lse, delta))
    if nsplit is None:
        nsplit = dkv_split(bk, sk, h, (b if bk == 1 else 1) * sq) if body == "wgmma" else 1
    if nsplit < 1 or (nsplit > 1 and body != "wgmma"):
        raise ValueError(f"attention_dkv: nsplit {nsplit} on body {body!r} (only the wgmma "
                         "body splits the query walk)")
    dk = torch.empty((bk, sk, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((bk, sk, h, d), dtype=v.dtype, device=q.device)
    part = (torch.empty(2 * nsplit * bk * sk * h * d, dtype=torch.float32, device=q.device)
            if nsplit > 1 else None)
    strides = (_strides(k) + _strides(v) + _strides(q) + _strides(dout)
               + _strides(dk) + _strides(dv))
    launch("attention_dkv", "attention_dkv", q, [BODIES[body], nsplit],
           [k, v, q, dout, lse, delta, dk, dv, part], strides,
           [b, bk, h, d, sq, sk], scale)
    return dk, dv


# --------------------------------------------------------------------------
# autograd Functions (the custom VJPs of flash_vjp.mha / mha_two_source)
# --------------------------------------------------------------------------


def bwd_detail(q: torch.Tensor, k: torch.Tensor, k_bank: Optional[torch.Tensor] = None) -> str:
    """A backward call's shapes, as its `md.attn.bwd` span carries them: q
    (B x Sq x H x D) and the (batch x rows) of each key source, "0x0" for
    no bank."""
    bank = "0x0" if k_bank is None else f"{k_bank.shape[0]}x{k_bank.shape[1]}"
    return f" q={dims(q)} kv={k.shape[0]}x{k.shape[1]} bank={bank}"


class _MHA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = self_attention_lse(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        with span("md.attn.bwd", bwd_detail, q, k):
            g = g.contiguous()  # the kernels take unit stride over D, aligned rows
            delta = attention_delta(g, out)
            need_q, need_k, need_v = ctx.needs_input_grad[:3]
            dq = attention_dq(q, k, v, g, lse, delta, ctx.scale) if need_q else None
            dk = dv = None
            if need_k or need_v:
                dk, dv = attention_dkv(k, v, q, g, lse, delta, ctx.scale)
        return dq, dk, dv, None


class _MHATwoSource(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k_self, v_self, k_bank, v_bank, scale):
        out, lse = two_source_attention_lse(q, k_self, v_self, k_bank, v_bank, scale)
        ctx.save_for_backward(q, k_self, v_self, k_bank, v_bank, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k_self, v_self, k_bank, v_bank, out, lse = ctx.saved_tensors
        with span("md.attn.bwd", bwd_detail, q, k_self, k_bank):
            g = g.contiguous()
            delta = attention_delta(g, out)
            need = ctx.needs_input_grad
            grads = [None] * 6
            if need[0]:
                grads[0] = attention_dq(q, k_self, v_self, g, lse, delta, ctx.scale,
                                        k_bank, v_bank)
            if need[1] or need[2]:
                grads[1], grads[2] = attention_dkv(k_self, v_self, q, g, lse, delta,
                                                   ctx.scale)
            if need[3] or need[4]:
                grads[3], grads[4] = attention_dkv(k_bank, v_bank, q, g, lse, delta,
                                                   ctx.scale)
        return tuple(grads)


def _default_scale(d: int, scale: Optional[float]) -> float:
    return d ** -0.5 if scale is None else float(scale)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        scale: Optional[float] = None) -> torch.Tensor:
    """(B, S, H, D) self-attention, differentiable."""
    return _MHA.apply(q, k, v, _default_scale(q.shape[-1], scale))


def mha_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: Optional[float], num_heads: int) -> torch.Tensor:
    """(B, S, H*D) packed self-attention, differentiable."""
    sp = lambda t: t.unflatten(-1, (num_heads, t.shape[-1] // num_heads))  # noqa: E731
    return mha(sp(q), sp(k), sp(v), scale).reshape(q.shape)


def mha_two_source(q: torch.Tensor, k_self: torch.Tensor, v_self: torch.Tensor,
                   k_bank: torch.Tensor, v_bank: torch.Tensor,
                   scale: Optional[float] = None) -> torch.Tensor:
    """(B, S, H, D) bank-read attention, differentiable. Bank batch 1 or B;
    a batch-1 bank's gradient is the sum over the frames."""
    return _MHATwoSource.apply(q, k_self, v_self, k_bank, v_bank,
                               _default_scale(q.shape[-1], scale))


def mha_two_source_packed(q: torch.Tensor, k_self: torch.Tensor,
                          v_self: torch.Tensor, k_bank: torch.Tensor,
                          v_bank: torch.Tensor, scale: Optional[float],
                          num_heads: int) -> torch.Tensor:
    """(B, S, H*D) packed bank-read attention, differentiable."""
    sp = lambda t: t.unflatten(-1, (num_heads, t.shape[-1] // num_heads))  # noqa: E731
    return mha_two_source(sp(q), sp(k_self), sp(v_self), sp(k_bank), sp(v_bank),
                          scale).reshape(q.shape)


def grouped_bwd_detail(q: torch.Tensor, num_heads: int) -> str:
    """The grouped backward's shapes for its `md.attn.bwd` span: packed q
    (sequences x rows x H*D) and the heads."""
    return f" grouped={dims(q)} heads={num_heads}"


class _MHAGrouped(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, num_heads):
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.num_heads = scale, num_heads
        return grouped_attention(q, k, v, scale, num_heads)  # grad mode is off here

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:3]
        if not any(need):
            return None, None, None, None, None
        q, k, v = ctx.saved_tensors
        with span("md.attn.bwd", grouped_bwd_detail, q, ctx.num_heads):
            grads = grouped_attention_bwd(q, k, v, g.contiguous(), ctx.scale, ctx.num_heads)
        return tuple(d if n else None for d, n in zip(grads, need)) + (None, None)


def mha_grouped(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: Optional[float], num_heads: int) -> torch.Tensor:
    """Packed (B, S, H*D) grouped attention over B sequences of S <= 64 rows
    (S | 128, 128 | B*S), differentiable: the motion module's training path."""
    return _MHAGrouped.apply(q, k, v, scale, num_heads)
