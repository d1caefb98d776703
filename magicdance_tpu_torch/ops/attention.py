"""Attention entry points with kernel dispatch.

Counterpart of `magicdance_tpu.ops.attention`: BSNH (`dot_product_attention`,
`bank_read_attention`) and packed (B, S, H*D) (`attention_packed`,
`bank_read_attention_packed`) functions with fp32 logits and softmax.

Attention with S_q >= 256, S_kv >= 256 and D <= 256 (a kernel site) is
dispatched by what the caller needs:

  * a gradient (grad mode on and an input requires grad): the autograd
    Functions of `ops.kernels.flash_vjp` -- on a CUDA tensor the forward runs
    kernel A/B with the LSE output and the backward kernels C (dQ) and D
    (dK/dV); on a CPU tensor the same Functions run their plain versions.
    This mirrors JAX, whose fast primal kernels run only when no gradient is
    requested and whose training path is the custom VJP.
  * no gradient: kernel A (self-attention) or kernel B (bank read), whose
    wrappers take their plain versions on a CPU tensor -- so a CPU run calls
    the wrappers exactly where the card launches the kernels.

Packed self-attention over many short sequences (a grouped site: the motion
module's attention over S = F frames, and at small images the S <= 32
spatial sites; `_grouped_site`, the JAX package's `flash_grouped` rule) is
dispatched the same way to the grouped kernel G (`ops.kernels.grouped`):
`mha_grouped` with a gradient, the kernel's wrapper without one.

A bank read gated per batch row (`bank_mask`, fused classifier-free
guidance) is forward-only, as in JAX: a gated kernel site launches kernel B
in its gated mode, any other gated site takes the gated plain version, and a
gated site asked for a gradient raises.

All else -- cross-attention over the 77 context tokens, the S = 64 middle
block, the VAE's single 512-wide head -- takes the kernels' plain versions
(`*_ref` in `ops.kernels`), which mirror the JAX package's XLA path and are
differentiable by autograd. So on a card
the plain math runs only at the sites JAX left to XLA, never at a kernel
site. The thresholds are the JAX package's; H100-specific ones come from
measurements on the card.

That is the "auto" dispatch. The `attention_impl` context (JAX
`ops.attention.attention_impl`, `TrainConfig.attention_impl`) overrides it
for the code run inside it, as JAX's `_pick_impl` / `_pick_impl_packed` do:
  * "xla": every site takes the plain version (the JAX package's XLA path);
    no attention kernel launches.
  * "flash": every site is a kernel site in BSNH layout (JAX routes it to
    `flash_attention` / `flash_attention_two_source`): with a gradient the
    autograd Functions `mha` / `mha_two_source`, without one kernel A / B,
    whatever S, S_kv or the sequence count -- cross-attention over the
    context tokens, the S = 64 middle block and the temporal S = F sites
    included; the grouped kernel G is not used. A gated bank read stays
    forward-only.
`MD_DISABLE_GROUPED_ATTN=1` (JAX's switch) turns off the grouped rule
under "auto": those sites then fall to the thresholds above.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Optional

import torch

from magicdance_tpu_torch.ops.kernels import (
    grouped_attention, self_attention, self_attention_ref, two_source_attention,
    two_source_attention_ref)
from magicdance_tpu_torch.ops.kernels.flash_vjp import mha, mha_grouped, mha_two_source


IMPLS = ("auto", "xla", "flash")

_IMPL_OVERRIDE: contextvars.ContextVar[str] = contextvars.ContextVar(
    "attention_impl", default="auto")


@contextlib.contextmanager
def attention_impl(impl: str):
    """Force the attention dispatch ("auto" | "xla" | "flash") for the code
    run within this context (see the module docstring)."""
    if impl not in IMPLS:
        raise ValueError(f"attention_impl {impl!r} is not one of {IMPLS}")
    token = _IMPL_OVERRIDE.set(impl)
    try:
        yield
    finally:
        _IMPL_OVERRIDE.reset(token)


def current_impl() -> str:
    return _IMPL_OVERRIDE.get()


def _kernel_site(sq: int, sk_total: int, d: int) -> bool:
    impl = _IMPL_OVERRIDE.get()
    if impl != "auto":
        return impl == "flash"
    return sq >= 256 and sk_total >= 256 and d <= 256


def _grouped_site(sq: int, sk: int, d: int, batch: int) -> bool:
    """A packed self-attention (never a bank read) over `batch` sequences
    that the grouped kernel takes: `_pick_impl_packed`'s `flash_grouped`
    rule without its TPU-backend term (never under an override)."""
    return (_IMPL_OVERRIDE.get() == "auto" and sq == sk and sq <= 32 and 128 % sq == 0
            and batch > 0 and batch * sq % 128 == 0 and d <= 256
            and os.environ.get("MD_DISABLE_GROUPED_ATTN") != "1")


def route(sq: int, sk_total: int, d: int, *, bank: bool = False, batch: int = 0) -> str:
    """Where a site goes under the current `attention_impl`: "grouped" (kernel
    G), "kernel" (A / B, or the autograd Functions with a gradient) or
    "plain" -- the counterpart of JAX's `_pick_impl_packed` answers
    "flash_grouped", "flash_fused" / "flash" and "xla" on a TPU."""
    if not bank and _grouped_site(sq, sk_total, d, batch):
        return "grouped"
    return "kernel" if _kernel_site(sq, sk_total, d) else "plain"


def _wants_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _split_heads(t: torch.Tensor, h: int) -> torch.Tensor:
    return t.unflatten(-1, (h, t.shape[-1] // h))


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention over BSNH tensors: q (B, Sq, H, D), k/v
    (B, Sk, H, D) -> (B, Sq, H, D) in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _kernel_site(q.shape[1], k.shape[1], q.shape[-1]):
        if _wants_grad(q, k, v):
            return mha(q, k, v, scale)
        return self_attention(q, k, v, scale)
    return self_attention_ref(q, k, v, scale)


def attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     num_heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention on packed (B, S, H*D) projection outputs."""
    if route(q.shape[1], k.shape[1], q.shape[-1] // num_heads, batch=q.shape[0]) == "grouped":
        if _wants_grad(q, k, v):
            return mha_grouped(q, k, v, scale, num_heads)
        return grouped_attention(q, k, v, scale, num_heads)
    out = dot_product_attention(_split_heads(q, num_heads),
                                _split_heads(k, num_heads),
                                _split_heads(v, num_heads), scale=scale)
    return out.reshape(q.shape)


def bank_read_attention(q: torch.Tensor, k_self: torch.Tensor,
                        v_self: torch.Tensor, k_bank: torch.Tensor,
                        v_bank: torch.Tensor, *,
                        scale: Optional[float] = None,
                        bank_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention whose keys/values are the union of the layer's own
    sequence and the appearance-bank sequence (one joint softmax). The bank
    batch is 1 (one reference serving every frame, broadcast) or B.
    `bank_mask` (B,): per-row gate on the bank; rows with 0 ignore it
    (exactly plain self-attention). Forward-only."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    site = route(q.shape[1], k_self.shape[1] + k_bank.shape[1], q.shape[-1],
                 bank=True) == "kernel"
    if bank_mask is not None:
        if _wants_grad(q, k_self, v_self, k_bank, v_bank):
            raise NotImplementedError("the gated bank read (fused CFG) is forward-only, "
                                      "as in the JAX package")
        if site:
            return two_source_attention(q, k_self, v_self, k_bank, v_bank, scale,
                                        bank_mask=bank_mask)
        return two_source_attention_ref(q, k_self, v_self, k_bank, v_bank, scale,
                                        bank_mask=bank_mask)
    if site:
        if _wants_grad(q, k_self, v_self, k_bank, v_bank):
            return mha_two_source(q, k_self, v_self, k_bank, v_bank, scale)
        return two_source_attention(q, k_self, v_self, k_bank, v_bank, scale)
    return two_source_attention_ref(q, k_self, v_self, k_bank, v_bank, scale)


def bank_read_attention_packed(q: torch.Tensor, k_self: torch.Tensor,
                               v_self: torch.Tensor, k_bank: torch.Tensor,
                               v_bank: torch.Tensor, *, num_heads: int,
                               scale: Optional[float] = None,
                               bank_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bank-read attention on packed (B, S, H*D) inputs (bank batch 1 or B)."""
    sp = lambda t: _split_heads(t, num_heads)  # noqa: E731
    out = bank_read_attention(sp(q), sp(k_self), sp(v_self), sp(k_bank),
                              sp(v_bank), scale=scale, bank_mask=bank_mask)
    return out.reshape(q.shape)
