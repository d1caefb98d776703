"""Kernel G: grouped (temporal) attention forward and backward -- ctypes
wrappers, launch counters and the plain PyTorch versions they are held
against.

Counterpart of `magicdance_tpu.ops.pallas.flash.flash_attention_grouped`
(`_grouped_attn_kernel`) and of the backward of
`magicdance_tpu.ops.pallas.flash_vjp.mha_grouped` (`_grouped_bwd_kernel`):
exact per-sequence softmax(q k^T * scale) v over packed (B, S, H*D) inputs,
where each of the B sequences has S <= 64 rows (S | 128, 128 | B*S) -- the
motion module's attention over the frame axis, (b*h*w, F, C). The Pallas
kernel's block-diagonal 128-row tiles are a TPU layout device; the kernels
here compute each (sequence, head) pair directly. In bf16 both the forward
and the backward run on the tensor cores (`grouped_tc` in
csrc/grouped_attention.cu, `grouped_bwd_tc` in csrc/grouped_attention_bwd.cu:
several pairs a block, one warp per 16 rows, sequences shorter than 16
packed into one 16-row tile under a block-diagonal mask); in fp32 they run
the CUDA-core bodies of csrc/grouped_common.cuh. The backward recomputes the
probabilities from q and k: nothing but q, k and v is kept from the
forward; its bf16 body gives the same bits on every run (no atomics).

The wrapper rule of `ops.kernels.attention`: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises, and each launch adds
one to `LAUNCHES["grouped"]` or `LAUNCHES["grouped_bwd"]`. The forward
wrapper refuses an input that requires grad (it builds no graph):
`ops.kernels.flash_vjp.mha_grouped` is the differentiable entry point.
"""

from __future__ import annotations

from typing import Optional

import torch

from magicdance_tpu_torch.ops.kernels.attention import (
    _check_no_grad,
    _check_operand,
    _check_q,
    _strides,
    launch,
)


def check_grouped_shape(q: torch.Tensor) -> None:
    """The Pallas kernel's preconditions (flash.py:421-424), kept so that
    both packages accept the same calls: S | 128 and 128 | B*S; and S <= 64,
    the longest sequence the kernels hold in shared memory."""
    if q.dim() != 3:
        raise ValueError(f"grouped attention: expected packed (B, S, H*D), got "
                         f"{tuple(q.shape)}")
    b, s, _ = q.shape
    if s > 64 or 128 % s != 0 or (b * s) % 128 != 0:
        raise ValueError(f"grouped attention needs S | 128, S <= 64 and 128 | B*S, "
                         f"got B={b}, S={s}")


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    return t.unflatten(-1, (num_heads, t.shape[-1] // num_heads))


def _scale(q: torch.Tensor, num_heads: int, scale: Optional[float]) -> float:
    return (q.shape[-1] // num_heads) ** -0.5 if scale is None else float(scale)


# --------------------------------------------------------------------------
# plain versions (fp32 logits and softmax; the JAX kernels' order of casts)
# --------------------------------------------------------------------------


def _probs(q: torch.Tensor, k: torch.Tensor, scale: float):
    """(unnormalised p, its row sums) of (B, S, H, D) q and k, fp32."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    return p, p.sum(-1, keepdim=True)


def grouped_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float], num_heads: int) -> torch.Tensor:
    """Packed (B, S, H*D) -> (B, S, H*D) in q's dtype; mirrors
    `_grouped_attn_kernel`: unnormalised probabilities cast to v's dtype, the
    PV product in fp32, divided by the fp32 denominator."""
    check_grouped_shape(q)
    scale = _scale(q, num_heads, scale)
    qh, kh, vh = (_heads(t, num_heads) for t in (q, k, v))
    p, denom = _probs(qh, kh, scale)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vh.float())
    return (out / denom.permute(0, 2, 1, 3)).to(q.dtype).reshape(q.shape)


def grouped_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              dout: torch.Tensor, scale: Optional[float],
                              num_heads: int):
    """(dq, dk, dv), packed like q; mirrors `_grouped_bwd_kernel`:
    pn = p / denom, dp = dO v^T, delta = rowsum(pn dp), ds = pn (dp - delta)
    scale; pn cast to dO's dtype and ds to q's dtype before the products."""
    check_grouped_shape(q)
    scale = _scale(q, num_heads, scale)
    qh, kh, vh, gh = (_heads(t, num_heads) for t in (q, k, v, dout))
    p, denom = _probs(qh, kh, scale)
    pn = p / denom
    dp = torch.einsum("bqhd,bkhd->bhqk", gh.float(), vh.float())
    delta = (pn * dp).sum(-1, keepdim=True)
    ds = ((pn * (dp - delta)) * scale).to(q.dtype).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", pn.to(dout.dtype).float(), gh.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qh.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kh.float())
    return tuple(g.to(t.dtype).reshape(t.shape) for g, t in ((dq, q), (dk, k), (dv, v)))


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def _operands(q: torch.Tensor, num_heads: int, *others: torch.Tensor):
    """(B, S, H, D) views of packed tensors, checked for the kernels."""
    views = [_heads(t, num_heads) for t in (q, *others)]
    _check_q(views[0])
    b, s = q.shape[:2]
    for name, t in zip("qkvg", views):
        _check_operand(name, t, views[0], (b,), s)
    return views


def grouped_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: Optional[float], num_heads: int) -> torch.Tensor:
    """Kernel G forward. Packed (B, S, H*D) q, k, v -> (B, S, H*D)."""
    scale = _scale(q, num_heads, scale)
    if q.device.type == "cpu":
        return grouped_attention_ref(q, k, v, scale, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"grouped_attention: unsupported device {q.device}")
    _check_no_grad("grouped_attention", q, k, v)
    check_grouped_shape(q)
    qh, kh, vh = _operands(q, num_heads, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    oh = _heads(out, num_heads)
    b, s, h, d = qh.shape
    launch("grouped_attention", "grouped", q, [], [qh, kh, vh, oh],
           _strides(qh) + _strides(kh) + _strides(vh) + _strides(oh), [b, h, d, s], scale)
    return out


def grouped_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          dout: torch.Tensor, scale: Optional[float], num_heads: int):
    """Kernel G backward: (dq, dk, dv) of grouped attention, packed like q."""
    scale = _scale(q, num_heads, scale)
    if q.device.type == "cpu":
        return grouped_attention_bwd_ref(q, k, v, dout, scale, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"grouped_attention_bwd: unsupported device {q.device}")
    check_grouped_shape(q)
    views = _operands(q, num_heads, k, v, dout)
    grads = [torch.empty(t.shape, dtype=t.dtype, device=q.device) for t in (q, k, v)]
    gviews = [_heads(g, num_heads) for g in grads]
    b, s, h, d = views[0].shape
    strides = sum((_strides(t) for t in views + gviews), [])
    launch("grouped_attention_bwd", "grouped_bwd", q, [], views + gviews, strides,
           [b, h, d, s], scale)
    return tuple(grads)
