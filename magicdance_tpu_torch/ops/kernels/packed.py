"""Kernel K9, head-packed attention: ctypes wrapper, launch counter, the
plain PyTorch version it is held against, and the packing helpers of the
head-packing probe (`magicdance_tpu_torch.scripts.bench_head_packing`).

`packed_attention(qp, kbd, vbd, G, scale)` takes lane-packed queries qp
(BG, Sq, G*D) -- head g in columns [g*D, (g+1)*D) -- and keys/values kbd,
vbd (BG, G*S, G*D) whose rows [g*S, (g+1)*S) are head g's segment. It
computes logits = qp kbd^T * scale in fp32, a softmax over each segment's S
keys separately, and o = P vbd (BG, Sq, G*D) in qp's dtype, with P cast to
that dtype before the PV product. It does so for any kbd/vbd; with the
block-diagonal ones of `blockdiag` it is per-head attention of G heads at a
time. It replaces `scripts/bench_head_packing.py::_packed_kernel`; source
`csrc/packed_attention.cu`. Three bodies, chosen by `packed_body(dtype,
G*D)`: "wgmma" (bf16, G*D <= 128: `csrc/attention_wgmma.cuh`, the Hopper
body of bf16 kernels A and B, wgmma fed by TMA through an mbarrier ring),
"mma_sync" (bf16, wider: `attention_tc`) and "cuda_core" (fp32).

The wrapper rule of the other kernels: a CPU tensor takes the plain version;
a CUDA tensor launches the kernel or raises. Each launch adds one to
`LAUNCHES["packed_attention"]`.
"""

from __future__ import annotations

from typing import Optional

import torch

from magicdance_tpu_torch.ops.kernels.attention import (  # noqa: F401  (BODIES: the codes)
    _DTYPE_CODE,
    BODIES,
    WGMMA_MAX_PACKED,
    _check_no_grad,
    _check_operand,
    attention_body,
    check_body,
    launch,
)

# --------------------------------------------------------------------------
# packing (the probe's layout; its cost is kept out of the kernel's time)
# --------------------------------------------------------------------------


def pack_heads(x: torch.Tensor, G: int) -> torch.Tensor:
    """(B, S, H, D) -> (B * H/G, S, G*D): each group of G consecutive heads
    side by side along the last axis."""
    b, s, h, d = x.shape
    ng = h // G
    return x.reshape(b, s, ng, G, d).permute(0, 2, 1, 3, 4).reshape(b * ng, s, G * d)


def blockdiag(x: torch.Tensor, G: int) -> torch.Tensor:
    """(B, S, H, D) -> (B * H/G, G*S, G*D), block-diagonal: row g*S + s of a
    group holds head g's row s in columns [g*D, (g+1)*D) and zeros
    elsewhere."""
    b, s, h, d = x.shape
    ng = h // G
    xg = x.reshape(b, s, ng, G, d).permute(0, 2, 3, 1, 4)  # (B, ng, G, S, D)
    out = x.new_zeros(b, ng, G, s, G, d)
    for g in range(G):
        out[:, :, g, :, g, :] = xg[:, :, g]
    return out.reshape(b * ng, G * s, G * d)


def unpack_heads(xp: torch.Tensor, batch: int, G: int) -> torch.Tensor:
    """Inverse of `pack_heads`: (B * H/G, S, G*D) -> (B, S, H, D)."""
    bg, s, gd = xp.shape
    ng, d = bg // batch, gd // G
    return xp.reshape(batch, ng, s, G, d).permute(0, 2, 1, 3, 4).reshape(batch, s, ng * G, d)


# --------------------------------------------------------------------------
# plain version and wrapper
# --------------------------------------------------------------------------

def packed_body(dtype: torch.dtype, width: int) -> str:
    """The body that runs K9 on the card for this dtype and packed width
    G*D (`attention.attention_body` for K9): fp32 on the CUDA cores, bf16 on
    the Hopper body up to WGMMA_MAX_PACKED and on attention_tc above it."""
    return attention_body(dtype, width, packed=True)


def _check(qp: torch.Tensor, kbd: torch.Tensor, vbd: torch.Tensor, G: int) -> int:
    """Shape and type checks; returns the segment length S."""
    if qp.dim() != 3:
        raise ValueError(f"qp: expected (BG, Sq, G*D), got {tuple(qp.shape)}")
    if qp.dtype not in _DTYPE_CODE:
        raise ValueError(f"qp: dtype {qp.dtype} not supported (float32, bfloat16)")
    bg, sq, gd = qp.shape
    if G < 1 or gd % G:
        raise ValueError(f"packed width {gd} is not G = {G} heads")
    if gd % 8 or not 8 <= gd <= 256:
        raise ValueError(f"packed width {gd} must be a multiple of 8 in [8, 256]")
    for name, t in (("kbd", kbd), ("vbd", vbd)):
        if t.dim() != 3 or t.shape[0] != bg or t.shape[2] != gd or t.shape != kbd.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} does not match qp "
                             f"{tuple(qp.shape)} and kbd {tuple(kbd.shape)}")
        if t.dtype != qp.dtype or t.device != qp.device:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected {qp.dtype} "
                             f"on {qp.device}")
    if kbd.shape[1] % G or kbd.shape[1] < G or sq < 1:
        raise ValueError(f"kbd: {kbd.shape[1]} key rows are not G = {G} segments")
    return kbd.shape[1] // G


def packed_attention_ref(qp: torch.Tensor, kbd: torch.Tensor, vbd: torch.Tensor, G: int,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Per segment g: softmax(qp kbd_g^T * scale) in fp32, normalised
    probabilities cast to vbd's dtype, times vbd_g in fp32; summed over the
    segments, returned in qp's dtype. `_packed_kernel`'s arithmetic: it
    contracts all G*S keys in one product, which only reorders the fp32
    sum."""
    s = _check(qp, kbd, vbd, G)
    if scale is None:
        scale = (qp.shape[2] // G) ** -0.5
    qf = qp.float()
    out = None
    for g in range(G):
        kg, vg = kbd[:, g * s:(g + 1) * s], vbd[:, g * s:(g + 1) * s]
        probs = torch.softmax(torch.bmm(qf, kg.float().transpose(1, 2)) * scale, dim=-1)
        part = torch.bmm(probs.to(vbd.dtype).float(), vg.float())
        out = part if out is None else out + part
    return out.to(qp.dtype)


def packed_attention(qp: torch.Tensor, kbd: torch.Tensor, vbd: torch.Tensor, G: int,
                     scale: Optional[float] = None, body: Optional[str] = None) -> torch.Tensor:
    """Kernel K9. qp: (BG, Sq, G*D); kbd, vbd: (BG, G*S, G*D) ->
    (BG, Sq, G*D). `scale` defaults to D ** -0.5. On the card `body`
    defaults to `packed_body(dtype, G*D)`; another body that can take the
    dtype and width may be named (a body is never chosen because another
    failed)."""
    s = _check(qp, kbd, vbd, G)
    if scale is None:
        scale = (qp.shape[2] // G) ** -0.5
    if body is None:
        body = packed_body(qp.dtype, qp.shape[2])
    check_body(body, qp.dtype, qp.shape[2], packed=True)
    if qp.device.type == "cpu":
        return packed_attention_ref(qp, kbd, vbd, G, scale)
    if qp.device.type != "cuda":
        raise ValueError(f"packed_attention: unsupported device {qp.device}")
    _check_no_grad("packed_attention", qp, kbd, vbd)
    bg, sq, gd = qp.shape
    # kernel A's operand rules (unit last stride, 16-byte aligned rows), on
    # (BG, rows, 1, G*D) views
    for name, t in (("qp", qp), ("kbd", kbd), ("vbd", vbd)):
        _check_operand(name, t.unsqueeze(2), qp.unsqueeze(2), (bg,), None)
    out = torch.empty((bg, sq, gd), dtype=qp.dtype, device=qp.device)
    strides = [qp.stride(0), qp.stride(1), kbd.stride(0), kbd.stride(1),
               vbd.stride(0), vbd.stride(1), out.stride(0), out.stride(1)]
    launch("packed_attention", "packed_attention", qp, [BODIES[body]], [qp, kbd, vbd, out],
           strides, [bg, gd, sq, s, G], scale)
    return out
