"""Kernel K8, fused GroupNorm + SiLU: ctypes wrapper, launch counter and the
plain PyTorch version it is held against.

`groupnorm_silu(x, weight, bias, groups, eps)` computes
SiLU(GroupNorm(x) * weight + bias) over x of shape (B, HW, C) with unit
channel stride (the port's channels_last UNet activations seen as rows of
channels), with fp32 statistics and an fp32 affine, and returns a new
contiguous (B, HW, C) tensor in x's dtype. It replaces
`magicdance_tpu/ops/pallas/groupnorm.py::_gn_silu_kernel`; source
`csrc/groupnorm_silu.cu` (two launches per call: per-chunk statistics, then
the normalise-and-apply pass, through a small fp32 workspace). Forward-only,
as in JAX: `models.layers.GroupNorm32` dispatches to it only where no
gradient is asked for.

The wrapper rule of the other kernels: a CPU tensor takes the plain version;
a CUDA tensor launches the kernel or raises. Each launch adds one to
`LAUNCHES["groupnorm_silu"]`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from magicdance_tpu_torch.ops.kernels.attention import _DTYPE_CODE, _check_no_grad, launch

# clusters of chunks per batch row the kernel's statistics pass writes at
# most (csrc/groupnorm_silu.cu: MAX_CLUSTERS)
GN_MAX_CLUSTERS = 32


def groupnorm_silu_ref(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                       groups: int, eps: float) -> torch.Tensor:
    """F.silu of the fp32 group norm (`models.layers.group_norm_f32`'s
    arithmetic), cast to x's dtype. x: (B, HW, C); the result is contiguous,
    as the kernel's."""
    xt = x.float().transpose(1, 2)  # (B, C, HW): F.group_norm's layout
    y = F.group_norm(xt, groups, weight.float(), bias.float(), eps)
    return F.silu(y).transpose(1, 2).to(x.dtype).contiguous()


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int) -> None:
    if x.dim() != 3:
        raise ValueError(f"groupnorm_silu: expected x (B, HW, C), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"groupnorm_silu: dtype {x.dtype} not supported")
    b, hw, c = x.shape
    if x.stride(2) != 1 and c > 1:
        raise ValueError(f"groupnorm_silu: the channel dim must have unit stride, "
                         f"got strides {x.stride()} (channels_last activations)")
    if groups < 1 or c % groups:
        raise ValueError(f"groupnorm_silu: {c} channels not divisible into {groups} groups")
    for name, t in (("weight", weight), ("bias", bias)):
        if tuple(t.shape) != (c,) or t.device != x.device:
            raise ValueError(f"groupnorm_silu: {name} must be ({c},) on {x.device}")


def groupnorm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   groups: int, eps: float) -> torch.Tensor:
    """Kernel K8. x: (B, HW, C), unit channel stride; weight, bias: (C,)."""
    _check(x, weight, bias, groups)
    if x.device.type == "cpu":
        return groupnorm_silu_ref(x, weight, bias, groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"groupnorm_silu: unsupported device {x.device}")
    _check_no_grad("groupnorm_silu", x, weight, bias)
    b, hw, c = x.shape
    y = torch.empty((b, hw, c), dtype=x.dtype, device=x.device)
    w = weight.detach().to(torch.float32).contiguous()
    bb = bias.detach().to(torch.float32).contiguous()
    # the statistics pass's (mean, M2) per (batch row, cluster of chunks, group)
    ws = torch.empty(b * GN_MAX_CLUSTERS * groups * 2, dtype=torch.float32, device=x.device)
    launch("groupnorm_silu", "groupnorm_silu", x, [], [x, w, bb, y, ws],
           [x.stride(0), x.stride(1), y.stride(0), y.stride(1)],
           [b, hw, c, groups], eps)
    return y
