"""3D-ResNet50 in PyTorch, the FID-VID backbone.

Counterpart of `magicdance_tpu.metrics.resnet3d_flax` (a first-party port of
ref: tool/metrics/resnet3d.py -- Kinetics 3D-ResNet50, Hara et al.;
features.py:31-40 loads `resnet-50-kinetics.pth` with `last_fc=False`, so
the FID-VID feature is the flattened 2048-d pooled activation). Submodules
carry the Flax names (`conv1`, `bn1`, `layer1_0.conv1`, ...,
`layer1_0.downsample_conv`), so `convert.from_jax` carries a Flax tree over
and `convert_resnet3d` takes the reference state dict. Static torch padding
(pad 1/3 both sides); BN eps 1e-5. Input preprocessing per the reference:
0-255 pixels minus the Kinetics channel mean (114.7748, 107.7354, 99.4750),
clips of sample_duration=16 at 112^2 (ref utils.py:463,498-500).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from magicdance_tpu_torch.metrics.core import as_tensor
from magicdance_tpu_torch.metrics.i3d import BatchNormInference

KINETICS_PIXEL_MEAN = (114.7748, 107.7354, 99.4750)


class Bottleneck3D(nn.Module):
    """1-3-1 bottleneck with BN shortcut (ref resnet3d.py:71-107,
    shortcut_type 'B')."""

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv3d(cin, planes, 1, bias=False)
        self.bn1 = BatchNormInference(planes, eps=1e-5)
        self.conv2 = nn.Conv3d(planes, planes, 3, stride, padding=1, bias=False)
        self.bn2 = BatchNormInference(planes, eps=1e-5)
        self.conv3 = nn.Conv3d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNormInference(planes * 4, eps=1e-5)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = nn.Conv3d(cin, planes * 4, 1, stride, bias=False)
            self.downsample_bn = BatchNormInference(planes * 4, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = x
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        if self.downsample:
            r = self.downsample_bn(self.downsample_conv(x))
        return F.relu(h + r)


class ResNet3D(nn.Module):
    """3D-ResNet50 feature extractor (ref resnet3d.py:110-184; last_fc
    behavior selected by `num_classes=None` -> flattened pooled features)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: float = 1.0,
                 num_classes: Optional[int] = None):
        super().__init__()
        c = lambda n: max(1, int(round(n * width)))  # noqa: E731
        self.conv1 = nn.Conv3d(3, c(64), 7, (1, 2, 2), padding=3, bias=False)
        self.bn1 = BatchNormInference(c(64), eps=1e-5)
        self.blocks = []
        in_ch = c(64)
        for li, (planes, n_blocks, stride) in enumerate(
            zip((64, 128, 256, 512), layers, (1, 2, 2, 2))
        ):
            p = c(planes)
            for i in range(n_blocks):
                ds = i == 0 and (stride != 1 or in_ch != p * 4)
                name = f"layer{li + 1}_{i}"
                self.add_module(name, Bottleneck3D(in_ch if i == 0 else p * 4, p,
                                                   stride if i == 0 else 1, ds))
                self.blocks.append(name)
            in_ch = p * 4
        self.fc = nn.Linear(in_ch, num_classes) if num_classes is not None else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, T, H, W, 3), 0-255 minus Kinetics pixel mean
        t_in, s_in = x.shape[1], x.shape[2]
        h = F.relu(self.bn1(self.conv1(x.permute(0, 4, 1, 2, 3))))
        h = F.max_pool3d(F.pad(h, (1, 1) * 3), 3, 2)  # zero pad after ReLU, VALID pool
        for name in self.blocks:
            h = getattr(self, name)(h)
        kt = min(h.shape[2], math.ceil(t_in / 16))
        ks = min(h.shape[3], math.ceil(s_in / 32))
        h = F.avg_pool3d(h, (kt, ks, ks), stride=1)
        h = h.permute(0, 2, 3, 4, 1).reshape(h.shape[0], -1)  # flatten as NDHWC
        if self.fc is not None:
            h = self.fc(h)
        return h


# ---------------------------------------------------------------------------
# torch state-dict conversion (resnet-50-kinetics.pth: {'state_dict':
# {'module.conv1.weight', ...}}; features.py:34-39 strips 'module.')
# ---------------------------------------------------------------------------

_BN = ("weight", "bias", "running_mean", "running_var")


def convert_resnet3d(
    sd: Mapping[str, Any], layers: Sequence[int] = (3, 4, 6, 3),
    with_fc: bool = False,
) -> Dict[str, torch.Tensor]:
    """Kinetics 3D-ResNet50 state dict -> the port's ResNet3D state dict."""
    sd = {k.replace("module.", ""): v for k, v in sd.items()}
    pairs = [("conv1.weight", "conv1.weight")] + [(f"bn1.{b}", f"bn1.{b}") for b in _BN]
    for li, n_blocks in enumerate(layers):
        for i in range(n_blocks):
            ref, port = f"layer{li + 1}.{i}", f"layer{li + 1}_{i}"
            for j in (1, 2, 3):
                pairs.append((f"{ref}.conv{j}.weight", f"{port}.conv{j}.weight"))
                pairs += [(f"{ref}.bn{j}.{b}", f"{port}.bn{j}.{b}") for b in _BN]
            if f"{ref}.downsample.0.weight" in sd:
                pairs.append((f"{ref}.downsample.0.weight", f"{port}.downsample_conv.weight"))
                pairs += [(f"{ref}.downsample.1.{b}", f"{port}.downsample_bn.{b}") for b in _BN]
    if with_fc and "fc.weight" in sd:
        pairs += [("fc.weight", "fc.weight"), ("fc.bias", "fc.bias")]
    return {port: as_tensor(sd[ref]) for ref, port in pairs}
