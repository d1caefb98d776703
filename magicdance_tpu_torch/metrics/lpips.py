"""LPIPS perceptual distance (VGG16 backbone) in PyTorch.

Counterpart of `magicdance_tpu.metrics.lpips` (the LPIPS metric of the
DisCo suite, ref: tool/metrics/ssim_l1_lpips_psnr.py -- `lpips.LPIPS(net=
'vgg')`): VGG16 conv features at relu1_2/relu2_2/relu3_3/relu4_3/relu5_3,
unit-normalized per channel, squared differences weighted by learned 1x1
"lin" layers, spatially averaged and summed over stages. Submodules carry
the Flax names (`vgg.conv_0..12`, `lin_0..4`), so `convert.from_jax` carries
a Flax LPIPS tree over.

Pretrained weights are not in the repository; load them with
`convert_lpips_torch_state` from a torch `lpips` package state dict (the
torchvision VGG16 features + lin weights). Without weights the scorer still
runs (seeded random features) for smoke tests -- scores are then NOT
comparable.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from magicdance_tpu_torch.device import full_fp32, resolve_device
from magicdance_tpu_torch.metrics.core import as_tensor, seeded_init

# VGG16 conv plan: (out_channels, n_convs) per stage
VGG_STAGES = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]

# input normalization used by lpips (shift/scale on [-1,1] inputs)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# torchvision VGG16.features conv indices, and the lpips slice holding each
_TV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]


class VGG16Features(nn.Module):
    def __init__(self):
        super().__init__()
        cin, i = 3, 0
        for ch, n in VGG_STAGES:
            for _ in range(n):
                self.add_module(f"conv_{i}", nn.Conv2d(cin, ch, 3, padding=1))
                cin, i = ch, i + 1

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x: (B, 3, H, W) -> the five stage outputs, NCHW."""
        feats = []
        conv_i = 0
        for stage, (_, n) in enumerate(VGG_STAGES):
            for _ in range(n):
                x = F.relu(getattr(self, f"conv_{conv_i}")(x))
                conv_i += 1
            feats.append(x)
            if stage != len(VGG_STAGES) - 1:
                x = F.max_pool2d(x, 2, 2)
        return feats


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, (ch, _) in enumerate(VGG_STAGES):
            self.add_module(f"lin_{i}", nn.Conv2d(ch, 1, 1, bias=False))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.from_numpy(_SCALE).view(1, 3, 1, 1), persistent=False)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a, b: (B, H, W, 3) in [-1, 1]. Returns (B,) distances."""
        a = (a.permute(0, 3, 1, 2) - self.shift) / self.scale
        b = (b.permute(0, 3, 1, 2) - self.shift) / self.scale
        fa = self.vgg(a)
        fb = self.vgg(b)
        total = 0.0
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            na = xa / torch.sqrt(torch.sum(xa ** 2, dim=1, keepdim=True) + 1e-10)
            nb = xb / torch.sqrt(torch.sum(xb ** 2, dim=1, keepdim=True) + 1e-10)
            w = getattr(self, f"lin_{i}")((na - nb) ** 2)
            total = total + torch.mean(w, dim=(1, 2, 3))
        return total


def convert_lpips_torch_state(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a torch `lpips.LPIPS(net='vgg')` state dict (keys `net.slice{k}.*`
    torchvision-indexed convs + `lin{k}.model.1.weight`) onto the port's
    LPIPS state dict (layouts unchanged: both are torch)."""

    def find(key_opts):
        for k in key_opts:
            if k in sd:
                return as_tensor(sd[k])
        raise KeyError(key_opts)

    out: Dict[str, torch.Tensor] = {}
    # lpips stores vgg as net.sliceN.<tv_index>.weight
    for ci, ti in enumerate(_TV_IDX):
        for leaf in ("weight", "bias"):
            out[f"vgg.conv_{ci}.{leaf}"] = find(
                [f"net.slice{s}.{ti}.{leaf}" for s in range(1, 6)]
                + [f"net.features.{ti}.{leaf}"])
    for i in range(len(VGG_STAGES)):
        out[f"lin_{i}.weight"] = find([f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"])
    return out


class LPIPSScorer:
    """Callable wrapper with (optionally) loaded weights, on `device` (the
    GPU unless the caller asks for the CPU)."""

    def __init__(self, torch_weights_path: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.model = LPIPS()
        if torch_weights_path:
            from magicdance_tpu_torch.convert.torch_convert import load_torch_state

            sd = load_torch_state(torch_weights_path)
            self.model.load_state_dict(convert_lpips_torch_state(sd), strict=True)
            self.calibrated = True
        else:
            seeded_init(self.model, 0)
            self.calibrated = False
        self.model.to(self.device).eval().requires_grad_(False)

    @torch.inference_mode()
    def __call__(self, a, b) -> np.ndarray:
        """a, b: (B, H, W, 3) in [-1, 1] (numpy or tensors) -> (B,) numpy."""
        with full_fp32():
            a = torch.as_tensor(a, dtype=torch.float32, device=self.device)
            b = torch.as_tensor(b, dtype=torch.float32, device=self.device)
            return self.model(a, b).cpu().numpy()
