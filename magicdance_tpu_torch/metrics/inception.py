"""InceptionV3 (torchvision layout, BN folded) in PyTorch -- FID and IS
features on the card.

Counterpart of `magicdance_tpu.metrics.inception_flax` (which replaces the
reference's torch-side Inception feature extractors, ref:
tool/cleanfid/inception_* and tool/metrics/features.py:21
build_feature_extractor). BatchNorms are FOLDED into the convolutions at
conversion (inference-exact, eps 1e-3), so the net is conv+bias+relu only.
Every conv pads explicitly as Flax's does (0 = VALID); the 3x3 average pools
of the branches exclude the padding, the stride-2 max-pools are VALID.

Submodules carry the Flax names. A Flax name holds a dot
(`"Mixed_5b.branch1x1"`) and a torch module name cannot, so the branches
nest (`Mixed_5b` -> `branch1x1`): the state-dict key is then the same string
(`Mixed_5b.branch1x1.weight`), and both `convert.from_jax`'s tree walk and
the torchvision prefixes land on it.

`convert_inception_torchvision` maps a torchvision `inception_v3` state dict
(Conv2d_1a_3x3.conv.weight / .bn.{weight,bias,running_mean,running_var},
Mixed_5b.branch1x1..., fc.*; AuxLogits skipped) onto this module; no
torchvision is needed. The clean-fid TorchScript file keeps its own path in
metrics/fid.py.

Returns (pool_features (B, 2048), logits (B, 1000)).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from magicdance_tpu_torch.device import full_fp32, resolve_device


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class _Branches(nn.Module):
    """A container whose children are one Inception block's convs."""


def _avg_pool3(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _max_pool3s2(x):
    return F.max_pool2d(x, 3, stride=2)


# (name, in, out, kernel, stride, padding) of every conv, by block
def _stem():
    return [("Conv2d_1a_3x3", 3, 32, 3, 2, 0), ("Conv2d_2a_3x3", 32, 32, 3, 1, 0),
            ("Conv2d_2b_3x3", 32, 64, 3, 1, 1), ("Conv2d_3b_1x1", 64, 80, 1, 1, 0),
            ("Conv2d_4a_3x3", 80, 192, 3, 1, 0)]


def _inception_a(cin, pool_features):
    return [("branch1x1", cin, 64, 1, 1, 0), ("branch5x5_1", cin, 48, 1, 1, 0),
            ("branch5x5_2", 48, 64, 5, 1, 2), ("branch3x3dbl_1", cin, 64, 1, 1, 0),
            ("branch3x3dbl_2", 64, 96, 3, 1, 1), ("branch3x3dbl_3", 96, 96, 3, 1, 1),
            ("branch_pool", cin, pool_features, 1, 1, 0)]


def _inception_b(cin):
    return [("branch3x3", cin, 384, 3, 2, 0), ("branch3x3dbl_1", cin, 64, 1, 1, 0),
            ("branch3x3dbl_2", 64, 96, 3, 1, 1), ("branch3x3dbl_3", 96, 96, 3, 2, 0)]


def _inception_c(cin, c7):
    return [("branch1x1", cin, 192, 1, 1, 0), ("branch7x7_1", cin, c7, 1, 1, 0),
            ("branch7x7_2", c7, c7, (1, 7), 1, (0, 3)),
            ("branch7x7_3", c7, 192, (7, 1), 1, (3, 0)),
            ("branch7x7dbl_1", cin, c7, 1, 1, 0),
            ("branch7x7dbl_2", c7, c7, (7, 1), 1, (3, 0)),
            ("branch7x7dbl_3", c7, c7, (1, 7), 1, (0, 3)),
            ("branch7x7dbl_4", c7, c7, (7, 1), 1, (3, 0)),
            ("branch7x7dbl_5", c7, 192, (1, 7), 1, (0, 3)),
            ("branch_pool", cin, 192, 1, 1, 0)]


def _inception_d(cin):
    return [("branch3x3_1", cin, 192, 1, 1, 0), ("branch3x3_2", 192, 320, 3, 2, 0),
            ("branch7x7x3_1", cin, 192, 1, 1, 0),
            ("branch7x7x3_2", 192, 192, (1, 7), 1, (0, 3)),
            ("branch7x7x3_3", 192, 192, (7, 1), 1, (3, 0)),
            ("branch7x7x3_4", 192, 192, 3, 2, 0)]


def _inception_e(cin):
    return [("branch1x1", cin, 320, 1, 1, 0), ("branch3x3_1", cin, 384, 1, 1, 0),
            ("branch3x3_2a", 384, 384, (1, 3), 1, (0, 1)),
            ("branch3x3_2b", 384, 384, (3, 1), 1, (1, 0)),
            ("branch3x3dbl_1", cin, 448, 1, 1, 0), ("branch3x3dbl_2", 448, 384, 3, 1, 1),
            ("branch3x3dbl_3a", 384, 384, (1, 3), 1, (0, 1)),
            ("branch3x3dbl_3b", 384, 384, (3, 1), 1, (1, 0)),
            ("branch_pool", cin, 192, 1, 1, 0)]


BLOCKS = [("Mixed_5b", _inception_a(192, 32)), ("Mixed_5c", _inception_a(256, 64)),
          ("Mixed_5d", _inception_a(288, 64)), ("Mixed_6a", _inception_b(288)),
          ("Mixed_6b", _inception_c(768, 128)), ("Mixed_6c", _inception_c(768, 160)),
          ("Mixed_6d", _inception_c(768, 160)), ("Mixed_6e", _inception_c(768, 192)),
          ("Mixed_7a", _inception_d(768)), ("Mixed_7b", _inception_e(1280)),
          ("Mixed_7c", _inception_e(2048))]


def _add_convs(parent: nn.Module, convs) -> None:
    for name, cin, cout, k, s, p in convs:
        parent.add_module(name, nn.Conv2d(cin, cout, _pair(k), stride=s, padding=_pair(p)))


class InceptionV3(nn.Module):
    def __init__(self):
        super().__init__()
        _add_convs(self, _stem())
        for name, convs in BLOCKS:
            block = _Branches()
            _add_convs(block, convs)
            self.add_module(name, block)
        self.fc = nn.Linear(2048, 1000)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x: (B, H, W, 3) in [-1, 1] (torchvision transform; 299x299 for
        FID, at least 75x75). Returns (pool (B, 2048), logits (B, 1000))."""
        x = x.permute(0, 3, 1, 2)

        def r(conv, t):
            return F.relu(conv(t))

        x = r(self.Conv2d_1a_3x3, x)
        x = r(self.Conv2d_2a_3x3, x)
        x = r(self.Conv2d_2b_3x3, x)
        x = _max_pool3s2(x)
        x = r(self.Conv2d_3b_1x1, x)
        x = r(self.Conv2d_4a_3x3, x)
        x = _max_pool3s2(x)

        def inception_a(m, x):
            b1 = r(m.branch1x1, x)
            b5 = r(m.branch5x5_2, r(m.branch5x5_1, x))
            b3 = r(m.branch3x3dbl_3, r(m.branch3x3dbl_2, r(m.branch3x3dbl_1, x)))
            bp = r(m.branch_pool, _avg_pool3(x))
            return torch.cat([b1, b5, b3, bp], dim=1)

        for m in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d):
            x = inception_a(m, x)

        m = self.Mixed_6a  # InceptionB
        b3 = r(m.branch3x3, x)
        bd = r(m.branch3x3dbl_3, r(m.branch3x3dbl_2, r(m.branch3x3dbl_1, x)))
        x = torch.cat([b3, bd, _max_pool3s2(x)], dim=1)

        def inception_c(m, x):
            b1 = r(m.branch1x1, x)
            b7 = r(m.branch7x7_3, r(m.branch7x7_2, r(m.branch7x7_1, x)))
            bd = r(m.branch7x7dbl_1, x)
            for conv in (m.branch7x7dbl_2, m.branch7x7dbl_3, m.branch7x7dbl_4,
                         m.branch7x7dbl_5):
                bd = r(conv, bd)
            bp = r(m.branch_pool, _avg_pool3(x))
            return torch.cat([b1, b7, bd, bp], dim=1)

        for m in (self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e):
            x = inception_c(m, x)

        m = self.Mixed_7a  # InceptionD
        b3 = r(m.branch3x3_2, r(m.branch3x3_1, x))
        b7 = r(m.branch7x7x3_1, x)
        for conv in (m.branch7x7x3_2, m.branch7x7x3_3, m.branch7x7x3_4):
            b7 = r(conv, b7)
        x = torch.cat([b3, b7, _max_pool3s2(x)], dim=1)

        def inception_e(m, x):
            b1 = r(m.branch1x1, x)
            b3 = r(m.branch3x3_1, x)
            b3 = torch.cat([r(m.branch3x3_2a, b3), r(m.branch3x3_2b, b3)], dim=1)
            bd = r(m.branch3x3dbl_2, r(m.branch3x3dbl_1, x))
            bd = torch.cat([r(m.branch3x3dbl_3a, bd), r(m.branch3x3dbl_3b, bd)], dim=1)
            bp = r(m.branch_pool, _avg_pool3(x))
            return torch.cat([b1, b3, bd, bp], dim=1)

        x = inception_e(self.Mixed_7b, x)
        x = inception_e(self.Mixed_7c, x)

        pool = torch.mean(x, dim=(2, 3))  # global average pool -> (B, 2048)
        return pool, self.fc(pool)


def convert_inception_torchvision(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """torchvision inception_v3 state dict -> InceptionV3 state dict, BN
    folded into each conv (the fold computed in numpy float32, as the JAX
    converter computes it)."""

    def arr(k):
        v = sd[k]
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    out: Dict[str, torch.Tensor] = {}
    convs = sorted({k[: -len(".conv.weight")] for k in sd
                    if k.endswith(".conv.weight") and not k.startswith("AuxLogits")})
    for prefix in convs:
        w = arr(f"{prefix}.conv.weight")  # OIHW, no bias
        gamma = arr(f"{prefix}.bn.weight")
        beta = arr(f"{prefix}.bn.bias")
        mean = arr(f"{prefix}.bn.running_mean")
        var = arr(f"{prefix}.bn.running_var")
        eps = 1e-3  # torchvision BasicConv2d BN eps
        scale = gamma / np.sqrt(var + eps)
        out[f"{prefix}.weight"] = torch.from_numpy(
            (w * scale[:, None, None, None]).astype(np.float32))
        out[f"{prefix}.bias"] = torch.from_numpy((beta - mean * scale).astype(np.float32))
    out["fc.weight"] = torch.from_numpy(arr("fc.weight").astype(np.float32))
    out["fc.bias"] = torch.from_numpy(arr("fc.bias").astype(np.float32))
    return out


class InceptionExtractor:
    """FID/IS feature extractor on `device` (the GPU unless the caller asks
    for the CPU) from a torchvision-layout state dict file. Raises KeyError
    or ValueError on a file of another layout (metrics/fid.py then tries the
    TorchScript path)."""

    def __init__(self, torchvision_weights_path: str,
                 device: Union[str, torch.device] = "cuda"):
        from magicdance_tpu_torch.convert.torch_convert import load_torch_state

        self.device = resolve_device(device)
        sd = load_torch_state(torchvision_weights_path)
        self.model = InceptionV3()
        self.model.load_state_dict(convert_inception_torchvision(sd), strict=True)
        self.model.to(self.device).eval().requires_grad_(False)

    @torch.inference_mode()
    def __call__(self, images_01: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """images in [0,1], (B, 299, 299, 3) -> (features, logits), numpy."""
        with full_fp32():
            x = torch.as_tensor(np.asarray(images_01, np.float32), device=self.device) * 2 - 1
            pool, logits = self.model(x)
        return pool.cpu().numpy(), logits.cpu().numpy()
