"""I3D (Inflated Inception-v1) in PyTorch, the FVD backbone.

Counterpart of `magicdance_tpu.metrics.i3d_flax` (a first-party port of
ref: tool/metrics/inception3d.py InceptionI3d -- the DeepMind Kinetics-400
I3D; ref features.py:42-44 loads `i3d_pretrained_400.pt` and FVD features
are the forward logits, metric_center.py:545,114-119). Submodules carry the
Flax names (`Conv3d_1a_7x7.conv`/`.bn`, `Mixed_3b.b0`, ..., `logits`), so
`convert.from_jax` carries a Flax I3D tree over and `convert_i3d` takes the
public state dict (`conv3d` -> `conv`).

Padding is the reference's dynamic "same" padding, which is XLA's SAME
convention: per dim total = max((ceil(n/s)-1)*s + k - n, 0), low =
total // 2, the rest high -- asymmetric at stride 2 (torch's
padding="same" refuses stride > 1, and symmetric padding would shift the
grid by one). It is applied explicitly with F.pad: zeros before a conv,
-inf before a max-pool.

Input: (B, T, H, W, 3) in [-1, 1] (ref utils.py:501-503), T >= 9, H=W=224
for pretrained weights. Output: (B, 400) logits (spatial squeeze +
time-mean, inception3d.py:342-354).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from magicdance_tpu_torch.metrics.core import as_tensor

# Kinetics I3D channel table (ref inception3d.py:215-313):
# InceptionModule rows are [b0, b1a, b1b, b2a, b2b, b3b].
KINETICS_MIXED = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}
BRANCHES = ("b0", "b1a", "b1b", "b2a", "b2b", "b3b")


class BatchNormInference(nn.Module):
    """Inference-mode BatchNorm3d with converted running stats (ref
    inception3d.py:81-82: eps=0.001): (x - mean) * rsqrt(var + eps) * weight
    + bias over the channel dim of an NCDHW tensor."""

    def __init__(self, c: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        inv = torch.rsqrt(self.running_var + self.eps)
        return ((x - self.running_mean.view(shape)) * inv.view(shape) * self.weight.view(shape)
                + self.bias.view(shape))


def same_pads(sizes: Sequence[int], kernel: Sequence[int], strides: Sequence[int]) -> tuple:
    """F.pad's argument (last dim first) for XLA SAME padding of the spatial
    dims `sizes` under `kernel` and `strides`."""
    pads = []
    for n, k, s in zip(sizes, kernel, strides):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(p for lo_hi in reversed(pads) for p in lo_hi)


class Unit3D(nn.Module):
    """Conv3D + BN + ReLU (ref inception3d.py:50-118), SAME padded."""

    def __init__(self, cin: int, features: int, kernel: Sequence[int] = (1, 1, 1),
                 stride: Sequence[int] = (1, 1, 1), use_bn: bool = True, act: bool = True,
                 use_bias: bool = False):
        super().__init__()
        self.kernel, self.stride, self.act = tuple(kernel), tuple(stride), act
        self.conv = nn.Conv3d(cin, features, self.kernel, self.stride, bias=use_bias)
        self.bn = BatchNormInference(features) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(F.pad(x, same_pads(x.shape[2:], self.kernel, self.stride)))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.act else x


def _maxpool_same(x, window, strides):
    x = F.pad(x, same_pads(x.shape[2:], window, strides), value=float("-inf"))
    return F.max_pool3d(x, window, strides)


class InceptionModule(nn.Module):
    """Four-branch inception block (ref inception3d.py:120-146)."""

    def __init__(self, cin: int, ch: Sequence[int]):  # (b0, b1a, b1b, b2a, b2b, b3b)
        super().__init__()
        self.b0 = Unit3D(cin, ch[0])
        self.b1a = Unit3D(cin, ch[1])
        self.b1b = Unit3D(ch[1], ch[2], (3, 3, 3))
        self.b2a = Unit3D(cin, ch[3])
        self.b2b = Unit3D(ch[3], ch[4], (3, 3, 3))
        self.b3b = Unit3D(cin, ch[5])
        self.out_channels = ch[0] + ch[2] + ch[4] + ch[5]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b0 = self.b0(x)
        b1 = self.b1b(self.b1a(x))
        b2 = self.b2b(self.b2a(x))
        b3 = self.b3b(_maxpool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([b0, b1, b2, b3], dim=1)


class I3D(nn.Module):
    """InceptionI3d forward-logits path (ref inception3d.py:148-354).

    `width` scales every channel count (1.0 = Kinetics; tests use smaller).
    """

    def __init__(self, num_classes: int = 400, width: float = 1.0):
        super().__init__()
        c = lambda n: max(1, int(round(n * width)))  # noqa: E731
        self.Conv3d_1a_7x7 = Unit3D(3, c(64), (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(c(64), c(64))
        self.Conv3d_2c_3x3 = Unit3D(c(64), c(192), (3, 3, 3))
        cin = c(192)
        for name, ch in KINETICS_MIXED.items():
            block = InceptionModule(cin, [c(v) for v in ch])
            self.add_module(name, block)
            cin = block.out_channels
        self.logits = Unit3D(cin, num_classes, use_bn=False, act=False, use_bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 4, 1, 2, 3)  # NDHWC -> NCDHW
        x = self.Conv3d_1a_7x7(x)
        x = _maxpool_same(x, (1, 3, 3), (1, 2, 2))  # MaxPool3d_2a_3x3
        x = self.Conv3d_2b_1x1(x)
        x = self.Conv3d_2c_3x3(x)
        x = _maxpool_same(x, (1, 3, 3), (1, 2, 2))  # MaxPool3d_3a_3x3
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = _maxpool_same(x, (3, 3, 3), (2, 2, 2))  # MaxPool3d_4a_3x3
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, name)(x)
        x = _maxpool_same(x, (2, 2, 2), (2, 2, 2))  # MaxPool3d_5a_2x2
        x = self.Mixed_5c(self.Mixed_5b(x))
        # Logits head: avg_pool (1,7,7) VALID, 1x1x1 conv with bias, spatial
        # squeeze + time-mean (inception3d.py:315-326,342-354). avg_pool is
        # clamped to the actual spatial extent for small test inputs.
        kh, kw = min(7, x.shape[3]), min(7, x.shape[4])
        x = F.avg_pool3d(x, (1, kh, kw), stride=1)
        x = self.logits(x)
        x = torch.mean(x, dim=(3, 4))  # spatial squeeze
        return torch.mean(x, dim=2)  # time-mean -> (B, classes)


# ---------------------------------------------------------------------------
# torch state-dict conversion (i3d_pretrained_400.pt layout)
# ---------------------------------------------------------------------------


def _unit(sd: Mapping[str, Any], p: str, use_bn=True, use_bias=False) -> Dict[str, torch.Tensor]:
    out = {f"{p}.conv.weight": as_tensor(sd[f"{p}.conv3d.weight"])}
    if use_bias:
        out[f"{p}.conv.bias"] = as_tensor(sd[f"{p}.conv3d.bias"])
    if use_bn:
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{p}.bn.{leaf}"] = as_tensor(sd[f"{p}.bn.{leaf}"])
    return out


def convert_i3d(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """`i3d_pretrained_400.pt` state dict -> the port's I3D state dict
    (ref inception3d.py end_points naming; features.py:42-44)."""
    out: Dict[str, torch.Tensor] = {}
    for ep in ("Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3"):
        out.update(_unit(sd, ep))
    for name in KINETICS_MIXED:
        for b in BRANCHES:
            out.update(_unit(sd, f"{name}.{b}"))
    out.update(_unit(sd, "logits", use_bn=False, use_bias=True))
    return out

