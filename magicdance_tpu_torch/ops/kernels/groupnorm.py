"""Kernel K8, fused GroupNorm with an activation epilogue: ctypes wrapper,
launch counter and the plain PyTorch version it is held against.

`groupnorm_act(x, weight, bias, groups, eps, act)` computes
act(GroupNorm(x) * weight + bias), act "silu" or None (the identity), over x
of shape (B, HW, C) with unit channel stride (the port's channels_last UNet
activations seen as rows of channels), with fp32 statistics and an fp32
affine, and returns a new contiguous (B, HW, C) tensor in x's dtype. It
replaces `magicdance_tpu/ops/pallas/groupnorm.py::_gn_silu_kernel` (SiLU)
and carries the transformers' norms besides (identity); source
`csrc/groupnorm_silu.cu`: two kernels per call (per-chunk statistics, then
the normalise-and-apply pass, through a small fp32 workspace), which read
the affine in the dtype it is stored in (fp32 or bf16), so a call launches
nothing else. Forward-only, as in JAX: `models.layers.GroupNorm32`
dispatches to it only where no gradient is asked for.

The wrapper rule of the other kernels: a CPU tensor takes the plain version;
a CUDA tensor launches the kernel or raises. Each call adds its two kernels
to `LAUNCHES["groupnorm_silu"]`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from magicdance_tpu_torch.ops.kernels.attention import (
    LAUNCHES,
    _DTYPE_CODE,
    _check_no_grad,
    launch,
)

# clusters of chunks per batch row the kernel's statistics pass writes at
# most (csrc/groupnorm_silu.cu: MAX_CLUSTERS)
GN_MAX_CLUSTERS = 32
# the epilogue codes of csrc/groupnorm_silu.cu (ACT_NONE, ACT_SILU)
ACTS = {None: 0, "silu": 1}


def groupnorm_silu_ref(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                       groups: int, eps: float, act: Optional[str] = "silu") -> torch.Tensor:
    """The fp32 group norm (`models.layers.group_norm_f32`'s arithmetic),
    then F.silu when `act` is "silu", cast to x's dtype. x: (B, HW, C); the
    result is contiguous, as the kernel's."""
    if act not in ACTS:
        raise ValueError(f"groupnorm: act {act!r}, one of {sorted(ACTS, key=str)}")
    xt = x.float().transpose(1, 2)  # (B, C, HW): F.group_norm's layout
    y = F.group_norm(xt, groups, weight.float(), bias.float(), eps)
    if act == "silu":
        y = F.silu(y)
    return y.transpose(1, 2).to(x.dtype).contiguous()


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
           act: Optional[str]) -> None:
    if x.dim() != 3:
        raise ValueError(f"groupnorm: expected x (B, HW, C), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"groupnorm: dtype {x.dtype} not supported")
    if act not in ACTS:
        raise ValueError(f"groupnorm: act {act!r}, one of {sorted(ACTS, key=str)}")
    b, hw, c = x.shape
    if x.stride(2) != 1 and c > 1:
        raise ValueError(f"groupnorm: the channel dim must have unit stride, "
                         f"got strides {x.stride()} (channels_last activations)")
    if groups < 1 or c % groups:
        raise ValueError(f"groupnorm: {c} channels not divisible into {groups} groups")
    for name, t in (("weight", weight), ("bias", bias)):
        if tuple(t.shape) != (c,) or t.device != x.device or t.dtype not in _DTYPE_CODE:
            raise ValueError(f"groupnorm: {name} must be ({c},) fp32 or bf16 on {x.device}")
    if weight.dtype != bias.dtype:
        raise ValueError(f"groupnorm: weight {weight.dtype} and bias {bias.dtype} differ")


def groupnorm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  groups: int, eps: float, act: Optional[str]) -> torch.Tensor:
    """Kernel K8. x: (B, HW, C), unit channel stride; weight, bias: (C,) in
    fp32 or bf16; act: "silu" or None."""
    _check(x, weight, bias, groups, act)
    if x.device.type == "cpu":
        return groupnorm_silu_ref(x, weight, bias, groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"groupnorm: unsupported device {x.device}")
    _check_no_grad("groupnorm", x, weight, bias)
    b, hw, c = x.shape
    y = torch.empty((b, hw, c), dtype=x.dtype, device=x.device)
    # (C,) parameters are contiguous: no copy, and no cast (the kernel
    # widens them as it loads them)
    w, bb = weight.detach().contiguous(), bias.detach().contiguous()
    # the statistics pass's (mean, M2) per (batch row, cluster of chunks, group)
    ws = torch.empty(b * GN_MAX_CLUSTERS * groups * 2, dtype=torch.float32, device=x.device)
    launch("groupnorm_silu", "groupnorm_silu", x, [_DTYPE_CODE[w.dtype], ACTS[act]],
           [x, w, bb, y, ws], [x.stride(0), x.stride(1), y.stride(0), y.stride(1)],
           [b, hw, c, groups], eps)
    LAUNCHES["groupnorm_silu"] += 1  # `launch` counted gn_stats; this is gn_apply
    return y
