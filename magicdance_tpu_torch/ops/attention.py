"""Attention entry points with kernel dispatch.

Counterpart of `magicdance_tpu.ops.attention`: BSNH (`dot_product_attention`,
`bank_read_attention`) and packed (B, S, H*D) (`attention_packed`,
`bank_read_attention_packed`) functions with fp32 logits and softmax. On a
CUDA tensor, attention with S_q >= 256, S_kv >= 256 and D <= 256 goes to the
hand-written kernels (self-attention: kernel A; bank read: kernel B). All
else -- cross-attention over the 77 context tokens, the S = 64 middle block,
the VAE's single 512-wide head, and every CPU tensor -- takes the kernels'
plain versions (`*_ref` in `ops.kernels`), which mirror the JAX package's
XLA path. So on a card the plain math runs only at the sites JAX left to
XLA, never at a kernel site. The thresholds are the JAX package's;
H100-specific ones come from measurements on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from magicdance_tpu_torch.ops.kernels import (
    self_attention, self_attention_ref, two_source_attention,
    two_source_attention_ref)


def _use_kernel(q: torch.Tensor, sq: int, sk_total: int, d: int) -> bool:
    return q.is_cuda and sq >= 256 and sk_total >= 256 and d <= 256


def _split_heads(t: torch.Tensor, h: int) -> torch.Tensor:
    return t.unflatten(-1, (h, t.shape[-1] // h))


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention over BSNH tensors: q (B, Sq, H, D), k/v
    (B, Sk, H, D) -> (B, Sq, H, D) in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _use_kernel(q, q.shape[1], k.shape[1], q.shape[-1]):
        return self_attention(q, k, v, scale)
    return self_attention_ref(q, k, v, scale)


def attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     num_heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention on packed (B, S, H*D) projection outputs."""
    out = dot_product_attention(_split_heads(q, num_heads),
                                _split_heads(k, num_heads),
                                _split_heads(v, num_heads), scale=scale)
    return out.reshape(q.shape)


def bank_read_attention(q: torch.Tensor, k_self: torch.Tensor,
                        v_self: torch.Tensor, k_bank: torch.Tensor,
                        v_bank: torch.Tensor, *,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention whose keys/values are the union of the layer's own
    sequence and the appearance-bank sequence (one joint softmax). The bank
    batch is 1 (one reference serving every frame, broadcast) or B."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _use_kernel(q, q.shape[1], k_self.shape[1] + k_bank.shape[1], q.shape[-1]):
        return two_source_attention(q, k_self, v_self, k_bank, v_bank, scale)
    return two_source_attention_ref(q, k_self, v_self, k_bank, v_bank, scale)


def bank_read_attention_packed(q: torch.Tensor, k_self: torch.Tensor,
                               v_self: torch.Tensor, k_bank: torch.Tensor,
                               v_bank: torch.Tensor, *, num_heads: int,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Bank-read attention on packed (B, S, H*D) inputs (bank batch 1 or B)."""
    sp = lambda t: _split_heads(t, num_heads)  # noqa: E731
    out = bank_read_attention(sp(q), sp(k_self), sp(v_self), sp(k_bank),
                              sp(v_bank), scale=scale)
    return out.reshape(q.shape)
