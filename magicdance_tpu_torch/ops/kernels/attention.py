"""Attention kernels A and B: ctypes wrappers, launch counters and the plain
PyTorch versions they are held against; the shared launch helpers of the
backward kernels C and D (`ops.kernels.flash_vjp`).

Layout: every operand is a (B, S, H, D) tensor with unit stride over D. A
contiguous BSNH tensor and a packed (B, S, H*D) projection output viewed as
(B, S, H, D) are the same memory, so one strided kernel serves both; the
output is a new contiguous (B, Sq, H, D) tensor, i.e. packed (B, Sq, H*D).

The wrapper rule: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises -- there is no fallback. Each launch adds one to
`LAUNCHES[<kernel mode>]`. The plain versions are also the one plain
attention of the port: `ops.attention` calls them at the sites below its
kernel thresholds.

Kernels A and B produce no autograd graph. A CUDA call with grad enabled on
an input that requires grad raises: a differentiable caller goes through the
autograd Functions of `ops.kernels.flash_vjp` (kernels A/B with the LSE
output forward, kernels C/D backward), as `ops.attention` does.

Kernel B takes an optional `bank_mask`, a (B,) gate on the bank per batch row
(fused classifier-free guidance: 1 for cond rows, 0 for uncond rows). It is
forward-only, as in JAX; its launches count under
`LAUNCHES["two_source_attention_gated"]`.

Bodies. On the card A, B (every mode), K9 (`ops.kernels.packed`) and the
backward kernels C and D (`ops.kernels.flash_vjp`) run one of three bodies,
chosen by `attention_body` from the kernel, the dtype, the head width and,
but for K9, the query length and key counts, and passed to the C entry as
its `body` argument: "wgmma" (bf16 up to the kernel's WGMMA_MAX_*, at the
sizes where it is the faster body: `csrc/attention_wgmma.cuh` for A, B and
K9, `csrc/attention_bwd_wgmma.cuh` for C and D, Hopper's wgmma fed by TMA
through an mbarrier ring), "mma_sync" (bf16 at any width: `attention_tc` of
`csrc/attention_mma.cuh`, `attention_dq_tc` / `attention_dkv_tc` of
`csrc/attention_bwd_mma.cuh`) and "cuda_core" (fp32). A caller may name
another body that can take the dtype and width; a body is never chosen
because another failed to build or launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from magicdance_tpu_torch.ops.kernels import build

# one counter per kernel mode: A and B plain (serving) and with the LSE
# output (training forward), C with one or two sources, D, the grouped
# (temporal) kernel's forward and backward (`ops.kernels.grouped`), B gated
# by a bank mask (fused CFG), the fused GroupNorm (`ops.kernels.groupnorm`,
# both of its kernels counted) and the head-packed attention of the head-packing
# probe (`ops.kernels.packed`)
LAUNCHES = {
    "self_attention": 0,
    "two_source_attention": 0,
    "self_attention_lse": 0,
    "two_source_attention_lse": 0,
    "attention_dq": 0,
    "attention_dq_two_source": 0,
    "attention_dkv": 0,
    "grouped": 0,
    "grouped_bwd": 0,
    "two_source_attention_gated": 0,
    "groupnorm_silu": 0,
    "packed_attention": 0,
}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the C entries' body codes. The Hopper body ("wgmma") holds Q and three
# stages of K and V in shared memory as 64-column boxes (a fourth box a row
# would need 256 KB, past the 227 KB a block may have) and one fp32
# accumulator of the row in registers; K9 keeps two, which fit up to 128
BODIES = {"cuda_core": 0, "mma_sync": 1, "wgmma": 2}
WGMMA_MAX_HEAD = 192
WGMMA_MAX_PACKED = 128
# C's Hopper body holds dQ's fp32 accumulator of the row (three boxes leave
# room for two stages); D's holds dK and dV, 8 x ceil(D / 16) registers
# each a thread, beside 96 for the logits and their fragments at 64-query
# tiles, 48 at the 32 it takes above D = 96: past D = 160 they would pass
# setmaxnreg's 232 (csrc/attention_bwd_wgmma.cuh)
WGMMA_MAX_DQ = 192
WGMMA_MAX_DKV = 160
# what each kernel's Hopper body takes: A and B, K9, C, D
_WGMMA_MAX = {"attention": WGMMA_MAX_HEAD, "packed": WGMMA_MAX_PACKED, "dq": WGMMA_MAX_DQ,
              "dkv": WGMMA_MAX_DKV}
# Where the Hopper body beats attention_tc at the widths it takes, timed
# over query lengths 16-4096 and key counts 16-4096 at D = 40, 80 and 160
# (scripts/bench_attention_hopper.py; PERF.md). One of its blocks
# holds 128 query rows and fills an SM (384 threads at 168 registers), so it
# needs enough key tiles to amortise its set-up (the barriers, the Q copy,
# the ring's fill), where attention_tc runs several blocks an SM:
# - D <= 48: at WGMMA_MIN_KEYS keys or more over all sources (fewer: 0.71-
#   0.95x attention_tc's speed for A, 0.91-1.00x for B);
# - 48 < D <= 80, kernel A: at more than WGMMA_MIN_ROWS query rows (at 64
#   or fewer, 0.57-1.09x: attention_tc's blocks there are 64 rows, full
#   where the Hopper body's 128 are half empty or less);
# - otherwise always (B at D = 80 0.93-1.42x, D = 160 1.09-2.52x).
WGMMA_MIN_KEYS = 512
WGMMA_MIN_ROWS = 64
# The backward kernels, timed the same way (C with one and two sources, D on
# a source of batch B and on a batch-1 source read by every batch; query
# lengths 16-4096, key counts 16-4096 and 77, at 2 S / Sq and 16 S / Sq
# sequences; my two sweep runs, PR 17, PERF.md). C's Hopper block walks
# tiles of 128 keys up to D = 64 and of 64 above, so it needs more than one:
# - C, D <= 48: above DQ_MIN_KEYS_NARROW keys over all sources (at 128 or
#   fewer 0.67-1.05x the mma.sync body's speed; above, 1.05-1.91x);
# - C, 48 < D <= 80: above DQ_MIN_KEYS keys (at 64 or fewer 0.80-1.24x;
#   above, 0.93-2.22x); wider: always (0.87-2.34x).
# D's Hopper block owns 128 keys and walks the query tiles of its batch (of
# every batch for a batch-1 source), so it needs enough of them:
# - D: at DKV_MIN_ROWS query rows walked or more (at 16-64 rows 0.58-1.20x;
#   at 256 0.88-1.64x; from 1024 1.25-8.59x, and 1.42-31.75x on a batch-1
#   source, where the mma.sync body walks every batch in one block).
DQ_MIN_KEYS_NARROW = 128
DQ_MIN_KEYS = 64
DKV_MIN_ROWS = 256


def _kind(packed: bool, kernel: str) -> str:
    if kernel not in _WGMMA_MAX:
        raise ValueError(f"kernel {kernel!r}: one of {sorted(_WGMMA_MAX)}")
    return "packed" if packed else kernel


def _backward_wgmma(kernel: str, width: int, rows: int, keys: tuple[int, ...]) -> bool:
    """Where the Hopper body of C (`kernel` "dq": `rows` query rows over
    `keys` per source) or D ("dkv": `rows` query rows walked by each key
    block, those of every batch for a batch-1 source) is the faster body
    (the rules above DQ_MIN_KEYS)."""
    if kernel == "dkv":
        return rows >= DKV_MIN_ROWS
    if width <= 48:
        return sum(keys) > DQ_MIN_KEYS_NARROW
    return width > 80 or sum(keys) > DQ_MIN_KEYS


def attention_body(dtype: torch.dtype, width: int, packed: bool = False,
                   rows: Optional[int] = None, keys: tuple[int, ...] = (),
                   kernel: str = "attention") -> str:
    """The body that runs kernel A or B (head width `width`), K9 (`packed`:
    packed width G*D), or the backward kernel C (`kernel="dq"`) or D
    ("dkv") on the card: fp32 on the CUDA cores, bf16 on the Hopper body up
    to its width and on the mma.sync body above it. A, B, C and D name their
    query length `rows` and each source's key count `keys`, and where the
    Hopper body would be the slower one (the rules above WGMMA_MIN_KEYS and
    `_backward_wgmma`) bf16 takes the mma.sync body."""
    kind = _kind(packed, kernel)
    if dtype == torch.float32:
        return "cuda_core"
    if dtype != torch.bfloat16:
        raise ValueError(f"dtype {dtype} not supported (float32, bfloat16)")
    if width > _WGMMA_MAX[kind]:
        return "mma_sync"
    if rows is None:
        return "wgmma"
    if kind in ("dq", "dkv"):
        return "wgmma" if _backward_wgmma(kind, width, rows, keys) else "mma_sync"
    if width <= 48:
        return "wgmma" if sum(keys) >= WGMMA_MIN_KEYS else "mma_sync"
    if width <= 80 and len(keys) == 1:
        return "wgmma" if rows > WGMMA_MIN_ROWS else "mma_sync"
    return "wgmma"


def check_body(body: str, dtype: torch.dtype, width: int, packed: bool = False,
               kernel: str = "attention") -> None:
    """Refuse a body that cannot take this dtype and width (`kernel` as for
    `attention_body`)."""
    kind = _kind(packed, kernel)
    ok = {"cuda_core": dtype == torch.float32,
          "mma_sync": dtype == torch.bfloat16,
          "wgmma": dtype == torch.bfloat16 and width <= _WGMMA_MAX[kind]}
    if not ok.get(body, False):
        what = {"attention": "attention", "packed": "K9", "dq": "kernel C", "dkv": "kernel D"}
        raise ValueError(f"body {body!r} cannot run {what[kind]} in {dtype} at width {width} "
                         f"(bodies: {sorted(BODIES)})")


def tma_readable(t: torch.Tensor) -> bool:
    """Whether the Hopper body's TMA maps can read a (B, S, H, D) operand the
    wrappers accept: every stride but one of 0 over more than one row (an
    operand broadcast over its batch rows or heads is read at coordinate 0;
    TMA takes no stride of 0, and rows cannot be read so)."""
    return t.shape[1] <= 1 or t.stride(1) != 0


def rows_tma_readable(t: torch.Tensor) -> bool:
    """Whether kernel D's Hopper body can copy tiles of a contiguous (B, H,
    Sq) fp32 lse or delta tensor by TMA: a tile starts at row r's query q0,
    (r * Sq + q0) * 4 bytes on from an aligned base, and TMA takes 16-byte
    aligned starts only."""
    return t.data_ptr() % 16 == 0 and t.shape[-1] % 4 == 0


def _pick_body(name: str, body: Optional[str], q: torch.Tensor, sources,
               kernel: str = "attention", more=(), rows=()) -> str:
    """`body`, or `attention_body`'s choice for `kernel`, q and the (K, V)
    pair of each source; an operand TMA cannot read (q, the sources, the
    tensors of `more`, the fp32 row tensors of `rows`) sends the default
    choice to the mma.sync body and refuses a named "wgmma"."""
    readable = (all(tma_readable(t) for t in (q, *more, *(t for kv in sources for t in kv)))
                and all(rows_tma_readable(t) for t in rows))
    if body is None:
        walked = q.shape[1] * (q.shape[0] if kernel == "dkv" and sources[0][0].shape[0] == 1
                               else 1)
        body = attention_body(q.dtype, q.shape[3], rows=walked,
                              keys=tuple(k.shape[1] for k, _ in sources), kernel=kernel)
        if body == "wgmma" and not readable:
            body = "mma_sync"
    check_body(body, q.dtype, q.shape[3], kernel=kernel)
    if body == "wgmma" and not readable:
        raise ValueError(f"{name}: an operand has row stride 0, or lse / delta rows start "
                         "off 16 bytes, which the wgmma body's TMA maps cannot read")
    return body


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
                             scale: Optional[float] = None,
                             bank_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Joint softmax over [q k_self^T ; q k_bank^T] * scale applied to
    [v_self ; v_bank]: one max and one denominator over both sources, as the
    JAX package's `bank_read_attention`. The bank batch is 1 or B; a batch-1
    bank is contracted without its batch axis, never tiled. `bank_mask`
    (B,): the bank probabilities of row b are multiplied by bank_mask[b]
    after the exp, inside the joint max and denominator (a row gated by 0 is
    plain self-attention)."""
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
    if bank_mask is not None:
        p_b = p_b * bank_mask.float()[:, None, None, None]
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


def _check_no_grad(name: str, *ts: torch.Tensor) -> None:
    """Kernels A/B write a fresh tensor with no autograd graph: refuse to
    drop a gradient silently."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            f"{name}: an input requires grad, and this kernel has no backward; "
            "use the autograd Functions of ops.kernels.flash_vjp (or "
            "ops.attention), which train through the backward kernels")


def _strides(t: torch.Tensor, batched: bool = True) -> list[int]:
    return [t.stride(0) if batched else 0, t.stride(1), t.stride(2)]


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def launch(lib_name: str, counter: str, ref: torch.Tensor, lead: list[int],
           args: list, strides: list[int], sizes: list[int], scale: float) -> None:
    """Call `md_<lib_name>(dtype, *lead, *pointers, strides, *sizes, scale,
    stream)` on the current stream of `ref`'s device; None in `args` is a
    null pointer. Raises on a launch error; counts the launch."""
    lib = build.load(lib_name)
    fn = getattr(lib, f"md_{lib_name}")
    arr = (ctypes.c_longlong * len(strides))(*strides)
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        err = fn(_DTYPE_CODE[ref.dtype], *lead, *[_ptr(t) for t in args],
                 arr, *sizes, ctypes.c_float(scale), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{lib_name} kernel launch failed: CUDA error {err} "
                           f"({lib.md_error_string(err).decode()})")
    LAUNCHES[counter] += 1


def _lse_buffer(q: torch.Tensor, with_lse: bool) -> Optional[torch.Tensor]:
    b, sq, h, _ = q.shape
    return (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
            if with_lse else None)


def self_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, with_lse: bool, body: Optional[str] = None):
    """Launch kernel A on CUDA tensors on `body` (default: `attention_body`'s
    choice); returns (out, lse or None)."""
    _check_q(q)
    b, sq, h, d = q.shape
    _check_operand("q", q, q, (b,), sq)
    _check_operand("k", k, q, (b,), None)
    _check_operand("v", v, q, (b,), k.shape[1])
    body = _pick_body("self_attention", body, q, ((k, v),))
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = _lse_buffer(q, with_lse)
    strides = (_strides(q) + _strides(k) + _strides(v) + _strides(out))
    launch("self_attention", "self_attention_lse" if with_lse else "self_attention",
           q, [BODIES[body]], [q, k, v, out, lse], strides, [b, h, d, sq, k.shape[1]], scale)
    return out, lse


def two_source_attention_cuda(q: torch.Tensor, k_self: torch.Tensor,
                              v_self: torch.Tensor, k_bank: torch.Tensor,
                              v_bank: torch.Tensor, scale: float, with_lse: bool,
                              bank_mask: Optional[torch.Tensor] = None,
                              body: Optional[str] = None):
    """Launch kernel B on CUDA tensors on `body` (default: `attention_body`'s
    choice); returns (out, lse or None). With `bank_mask` it is the gated
    forward (never with the LSE)."""
    _check_q(q)
    b, sq, h, d = q.shape
    _check_operand("q", q, q, (b,), sq)
    _check_operand("k_self", k_self, q, (b,), None)
    _check_operand("v_self", v_self, q, (b,), k_self.shape[1])
    _check_operand("k_bank", k_bank, q, (1, b), None)
    _check_operand("v_bank", v_bank, q, (k_bank.shape[0],), k_bank.shape[1])
    if bank_mask is not None:
        if with_lse:
            raise ValueError("the gated kernel B is forward-only (no LSE output)")
        if bank_mask.shape != (b,) or bank_mask.device != q.device:
            raise ValueError(f"bank_mask: expected ({b},) on {q.device}, got "
                             f"{tuple(bank_mask.shape)} on {bank_mask.device}")
        bank_mask = bank_mask.to(torch.float32).contiguous()
    body = _pick_body("two_source_attention", body, q,
                      ((k_self, v_self), (k_bank, v_bank)))
    bank_batched = k_bank.shape[0] == b and b > 1
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = _lse_buffer(q, with_lse)
    strides = (_strides(q) + _strides(k_self) + _strides(v_self)
               + _strides(k_bank, bank_batched) + _strides(v_bank, bank_batched)
               + _strides(out))
    counter = ("two_source_attention_gated" if bank_mask is not None else
               "two_source_attention_lse" if with_lse else "two_source_attention")
    launch("two_source_attention", counter, q, [BODIES[body]],
           [q, k_self, v_self, k_bank, v_bank, out, lse, bank_mask], strides,
           [b, h, d, sq, k_self.shape[1], k_bank.shape[1]], scale)
    return out, lse


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: Optional[float] = None, body: Optional[str] = None) -> torch.Tensor:
    """Kernel A. q: (B, Sq, H, D); k, v: (B, Sk, H, D) -> (B, Sq, H, D). On
    the card `body` defaults to `attention_body`'s choice for the dtype, D,
    Sq and Sk; another body that can take the dtype and width may be named (checked on the CPU too, where
    the plain version runs whichever is named)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if body is not None:
        check_body(body, q.dtype, q.shape[-1])
    if q.device.type == "cpu":
        return self_attention_ref(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"self_attention: unsupported device {q.device}")
    _check_no_grad("self_attention", q, k, v)
    return self_attention_cuda(q, k, v, scale, with_lse=False, body=body)[0]


def two_source_attention(q: torch.Tensor, k_self: torch.Tensor,
                         v_self: torch.Tensor, k_bank: torch.Tensor,
                         v_bank: torch.Tensor,
                         scale: Optional[float] = None,
                         bank_mask: Optional[torch.Tensor] = None,
                         body: Optional[str] = None) -> torch.Tensor:
    """Kernel B. q, k_self, v_self: (B, S*, H, D); k_bank, v_bank:
    (Bb, Sb, H, D) with Bb in {1, B} (a batch-1 bank is read with batch
    stride 0) -> (B, Sq, H, D). `bank_mask`: optional (B,) gate on the bank
    (the gated mode). `body` as for `self_attention`."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if body is not None:
        check_body(body, q.dtype, q.shape[-1])
    if q.device.type == "cpu":
        return two_source_attention_ref(q, k_self, v_self, k_bank, v_bank, scale,
                                        bank_mask)
    if q.device.type != "cuda":
        raise ValueError(f"two_source_attention: unsupported device {q.device}")
    _check_no_grad("two_source_attention", q, k_self, v_self, k_bank, v_bank)
    return two_source_attention_cuda(q, k_self, v_self, k_bank, v_bank, scale,
                                     with_lse=False, bank_mask=bank_mask, body=body)[0]
