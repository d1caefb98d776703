"""Attention kernels A and B: ctypes wrappers, launch counters and the plain
PyTorch versions they are held against.

Layout: every operand is a (B, S, H, D) tensor with unit stride over D. A
contiguous BSNH tensor and a packed (B, S, H*D) projection output viewed as
(B, S, H, D) are the same memory, so one strided kernel serves both; the
output is a new contiguous (B, Sq, H, D) tensor, i.e. packed (B, Sq, H*D).

The wrapper rule: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises -- there is no fallback. Each launch adds one to
`LAUNCHES[<kernel name>]`. The plain versions are also the one plain
attention of the port: `ops.attention` calls them at the sites below its
kernel thresholds.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from magicdance_tpu_torch.ops.kernels import build

LAUNCHES = {"self_attention": 0, "two_source_attention": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# --------------------------------------------------------------------------
# plain versions (fp32 logits and softmax, output in q's dtype)
# --------------------------------------------------------------------------


def self_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v over BSNH tensors; mirrors the JAX package's
    `_xla_attention` (probabilities are cast to v's dtype before the PV
    product, which accumulates in fp32)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def two_source_attention_ref(q: torch.Tensor, k_self: torch.Tensor,
                             v_self: torch.Tensor, k_bank: torch.Tensor,
                             v_bank: torch.Tensor,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Joint softmax over [q k_self^T ; q k_bank^T] * scale applied to
    [v_self ; v_bank]: one max and one denominator over both sources, as the
    JAX package's `bank_read_attention`. The bank batch is 1 or B; a batch-1
    bank is contracted without its batch axis, never tiled."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf = q.float()
    shared = k_bank.shape[0] == 1 and q.shape[0] != 1
    kb = k_bank[0] if shared else k_bank
    vb = v_bank[0] if shared else v_bank
    bank_qk = "bqhd,khd->bhqk" if shared else "bqhd,bkhd->bhqk"
    bank_pv = "bhqk,khd->bqhd" if shared else "bhqk,bkhd->bqhd"
    logits_s = torch.einsum("bqhd,bkhd->bhqk", qf, k_self.float()) * scale
    logits_b = torch.einsum(bank_qk, qf, kb.float()) * scale
    m = torch.maximum(logits_s.amax(-1, keepdim=True),
                      logits_b.amax(-1, keepdim=True))
    p_s = torch.exp(logits_s - m)
    p_b = torch.exp(logits_b - m)
    denom = p_s.sum(-1, keepdim=True) + p_b.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p_s.to(v_self.dtype).float(),
                       v_self.float())
    out = out + torch.einsum(bank_pv, p_b.to(vb.dtype).float(), vb.float())
    out = out / denom.permute(0, 2, 1, 3)
    return out.to(q.dtype)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def _check_operand(name: str, t: torch.Tensor, ref: torch.Tensor,
                   batch_ok: tuple[int, ...], s: Optional[int]) -> None:
    if t.dim() != 4:
        raise ValueError(f"{name}: expected (B, S, H, D), got {tuple(t.shape)}")
    if t.device != ref.device or t.dtype != ref.dtype:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                         f"{ref.dtype} on {ref.device}")
    b, st, h, d = t.shape
    if b not in batch_ok or h != ref.shape[2] or d != ref.shape[3] or (
            s is not None and st != s):
        raise ValueError(f"{name}: shape {tuple(t.shape)} does not match "
                         f"q {tuple(ref.shape)}")
    if st < 1:
        raise ValueError(f"{name}: empty sequence")
    if t.stride(3) != 1:
        raise ValueError(f"{name}: the head dim must have unit stride")
    # 16-byte vector loads: aligned base, every used stride a multiple of 8
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")
    for dim in range(3):
        if t.shape[dim] > 1 and t.stride(dim) % 8:
            raise ValueError(f"{name}: stride {t.stride()} not a multiple of 8 "
                             f"elements along dim {dim}")


def _check_q(q: torch.Tensor) -> None:
    if q.dim() != 4:
        raise ValueError(f"q: expected (B, S, H, D), got {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"q: dtype {q.dtype} not supported (float32, bfloat16)")
    d = q.shape[3]
    if d % 8 or not 8 <= d <= 256:
        raise ValueError(f"head dim {d} must be a multiple of 8 in [8, 256]")


def _strides(t: torch.Tensor, batched: bool = True) -> list[int]:
    return [t.stride(0) if batched else 0, t.stride(1), t.stride(2)]


def _launch(name: str, q: torch.Tensor, args: list, strides: list[int],
            sizes: list[int], scale: float) -> None:
    lib = build.load(name)
    fn = getattr(lib, f"md_{name}")
    arr = (ctypes.c_longlong * len(strides))(*strides)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODE[q.dtype], *[ctypes.c_void_p(t.data_ptr()) for t in args],
                 arr, *sizes, ctypes.c_float(scale), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({lib.md_error_string(err).decode()})")
    LAUNCHES[name] += 1


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Kernel A. q: (B, Sq, H, D); k, v: (B, Sk, H, D) -> (B, Sq, H, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return self_attention_ref(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"self_attention: unsupported device {q.device}")
    _check_q(q)
    b, sq, h, d = q.shape
    _check_operand("q", q, q, (b,), sq)
    _check_operand("k", k, q, (b,), None)
    _check_operand("v", v, q, (b,), k.shape[1])
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    strides = (_strides(q) + _strides(k) + _strides(v) + _strides(out))
    _launch("self_attention", q, [q, k, v, out], strides,
            [b, h, d, sq, k.shape[1]], scale)
    return out


def two_source_attention(q: torch.Tensor, k_self: torch.Tensor,
                         v_self: torch.Tensor, k_bank: torch.Tensor,
                         v_bank: torch.Tensor,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Kernel B. q, k_self, v_self: (B, S*, H, D); k_bank, v_bank:
    (Bb, Sb, H, D) with Bb in {1, B} (a batch-1 bank is read with batch
    stride 0) -> (B, Sq, H, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return two_source_attention_ref(q, k_self, v_self, k_bank, v_bank, scale)
    if q.device.type != "cuda":
        raise ValueError(f"two_source_attention: unsupported device {q.device}")
    _check_q(q)
    b, sq, h, d = q.shape
    _check_operand("q", q, q, (b,), sq)
    _check_operand("k_self", k_self, q, (b,), None)
    _check_operand("v_self", v_self, q, (b,), k_self.shape[1])
    _check_operand("k_bank", k_bank, q, (1, b), None)
    _check_operand("v_bank", v_bank, q, (k_bank.shape[0],), k_bank.shape[1])
    bank_batched = k_bank.shape[0] == b and b > 1
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    strides = (_strides(q) + _strides(k_self) + _strides(v_self)
               + _strides(k_bank, bank_batched) + _strides(v_bank, bank_batched)
               + _strides(out))
    _launch("two_source_attention", q, [q, k_self, v_self, k_bank, v_bank, out],
            strides, [b, h, d, sq, k_self.shape[1], k_bank.shape[1]], scale)
    return out
