"""OpenPose CPM networks (body PAF + heatmap, hand, face) in PyTorch.

Counterpart of `magicdance_tpu.models.openpose` (the reference's detector
networks: model_lib/ControlNet/annotator/openpose/model.py bodypose_model /
handpose_model, face.py FaceNet, the standard CMU convolutional pose
machines). They turn a driving video into the pose maps that sampling
consumes (ref README.md:156-185, misc_scripts/detect_openpose_map_tiktok.py).

Plain same-padded k x k convolutions with ReLU and 2 x 2 stride-2 max-pools
(floor mode, as Flax's "VALID" `nn.max_pool`), in fp32; the JAX package left
them to XLA, so they are `nn.Conv2d` and `F.max_pool2d` here. Inputs and
outputs are NCHW; the detector transposes at the nets' boundary.

Layer tables (channels, kernel) mirror the CMU nets:
  body: VGG-ish trunk -> 128-ch F; 6 two-branch stages (PAF 38 ch / heatmap
        19 ch), stages 2+ consume cat(L1, L2, F) = 185 ch.
  hand: deeper trunk -> 128-ch F; stage 1 1x1 head -> 22 maps; stages 2-6
        consume cat(out, F) = 150 ch.
  face: the hand trunk; 71 maps; stages consume cat(out, F) = 199 ch.

The converters map the public `body_pose_model.pth` / `hand_pose_model.pth`
/ `facenet.pth` keys onto these modules' state-dict keys (both OIHW).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# (name, out_ch, kernel); "pool" entries are 2x2 max-pools
BODY_TRUNK = [
    ("conv1_1", 64, 3), ("conv1_2", 64, 3), ("pool", 0, 0),
    ("conv2_1", 128, 3), ("conv2_2", 128, 3), ("pool", 0, 0),
    ("conv3_1", 256, 3), ("conv3_2", 256, 3), ("conv3_3", 256, 3),
    ("conv3_4", 256, 3), ("pool", 0, 0),
    ("conv4_1", 512, 3), ("conv4_2", 512, 3),
    ("conv4_3_CPM", 256, 3), ("conv4_4_CPM", 128, 3),
]

HAND_FACE_TRUNK = [
    ("conv1_1", 64, 3), ("conv1_2", 64, 3), ("pool", 0, 0),
    ("conv2_1", 128, 3), ("conv2_2", 128, 3), ("pool", 0, 0),
    ("conv3_1", 256, 3), ("conv3_2", 256, 3), ("conv3_3", 256, 3),
    ("conv3_4", 256, 3), ("pool", 0, 0),
    ("conv4_1", 512, 3), ("conv4_2", 512, 3), ("conv4_3", 512, 3),
    ("conv4_4", 512, 3), ("conv5_1", 512, 3), ("conv5_2", 512, 3),
    ("conv5_3_CPM", 128, 3),
]


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=k // 2)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


def _add_trunk(module: nn.Module, table: List[Tuple[str, int, int]]) -> None:
    """The trunk's convolutions as flat attributes (the Flax names)."""
    cin = 3
    for name, ch, k in table:
        if name != "pool":
            module.add_module(name, _conv(cin, ch, k))
            cin = ch


def _run_trunk(module: nn.Module, table: List[Tuple[str, int, int]],
               x: torch.Tensor) -> torch.Tensor:
    for name, _, _ in table:
        x = _max_pool(x) if name == "pool" else F.relu(getattr(module, name)(x))
    return x


def _add_stage(module: nn.Module, names: List[str], cin: int, out_ch: int) -> None:
    """A refinement stage: five 7x7 convs of 128, a 1x1 of 128, the 1x1
    head."""
    for name, (cout, k) in zip(names, [(128, 7)] * 5 + [(128, 1), (out_ch, 1)]):
        module.add_module(name, _conv(cin, cout, k))
        cin = cout


def _run_chain(module: nn.Module, names: List[str], x: torch.Tensor) -> torch.Tensor:
    """Convolutions in order, ReLU after each but the last."""
    for i, name in enumerate(names):
        x = getattr(module, name)(x)
        if i < len(names) - 1:
            x = F.relu(x)
    return x


class BodyPoseNet(nn.Module):
    """Input (B, 3, H, W) in [-0.5, 0.5] (caffe preprocessing: /256 - 0.5);
    outputs (paf (B, 38, H/8, W/8), heatmap (B, 19, H/8, W/8))."""

    def __init__(self):
        super().__init__()
        _add_trunk(self, BODY_TRUNK)
        for branch, out_ch in ((1, 38), (2, 19)):
            for name, cin, cout, k in (
                    [(f"conv5_{i}_CPM_L{branch}", 128, 128, 3) for i in range(1, 4)]
                    + [(f"conv5_4_CPM_L{branch}", 128, 512, 1),
                       (f"conv5_5_CPM_L{branch}", 512, out_ch, 1)]):
                self.add_module(name, _conv(cin, cout, k))
            for s in range(2, 7):
                _add_stage(self, self._stage_names(s, branch), 185, out_ch)

    @staticmethod
    def _stage_names(s: int, branch: int) -> List[str]:
        return [f"Mconv{i}_stage{s}_L{branch}" for i in range(1, 8)]

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        f = _run_trunk(self, BODY_TRUNK, x.float())
        l1, l2 = (_run_chain(self, [f"conv5_{i}_CPM_L{b}" for i in range(1, 6)], f)
                  for b in (1, 2))
        for s in range(2, 7):
            inp = torch.cat([l1, l2, f], dim=1)
            l1, l2 = (_run_chain(self, self._stage_names(s, b), inp) for b in (1, 2))
        return l1, l2


class CPMSingleBranch(nn.Module):
    """Hand (22 maps) / face (71 maps) CPM: (B, 3, H, W) -> (B, maps, H/8,
    W/8)."""

    def __init__(self, out_maps: int):
        super().__init__()
        self.out_maps = out_maps
        _add_trunk(self, HAND_FACE_TRUNK)
        self.conv6_1_CPM = _conv(128, 512, 1)
        self.conv6_2_CPM = _conv(512, out_maps, 1)
        for s in range(2, 7):
            _add_stage(self, self._stage_names(s), out_maps + 128, out_maps)

    @staticmethod
    def _stage_names(s: int) -> List[str]:
        return [f"Mconv{i}_stage{s}" for i in range(1, 8)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = _run_trunk(self, HAND_FACE_TRUNK, x.float())
        out = _run_chain(self, ["conv6_1_CPM", "conv6_2_CPM"], f)
        for s in range(2, 7):
            out = _run_chain(self, self._stage_names(s), torch.cat([out, f], dim=1))
        return out


def HandPoseNet() -> CPMSingleBranch:
    return CPMSingleBranch(out_maps=22)


def FacePoseNet() -> CPMSingleBranch:
    return CPMSingleBranch(out_maps=71)


# ---------------------------------------------------------------------------
# converters: reference key -> port key
# ---------------------------------------------------------------------------

def _cv(sd: Mapping[str, torch.Tensor], ref: str, port: str) -> Dict[str, torch.Tensor]:
    return {f"{port}.weight": sd[f"{ref}.weight"], f"{port}.bias": sd[f"{ref}.bias"]}


def convert_body_pose(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`body_pose_model.pth` (keys model0.conv1_1.* / modelK_B.M*.*) ->
    BodyPoseNet state dict."""
    out: Dict[str, torch.Tensor] = {}
    for name, _, _ in BODY_TRUNK:
        if name != "pool":
            out.update(_cv(sd, f"model0.{name}", name))
    for branch in (1, 2):
        for i in range(1, 6):
            nm = f"conv5_{i}_CPM_L{branch}"
            out.update(_cv(sd, f"model1_{branch}.{nm}", nm))
        for s in range(2, 7):
            for i in range(1, 8):
                nm = f"Mconv{i}_stage{s}_L{branch}"
                out.update(_cv(sd, f"model{s}_{branch}.{nm}", nm))
    return out


def convert_hand_pose(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`hand_pose_model.pth` -> CPMSingleBranch(22) state dict."""
    out: Dict[str, torch.Tensor] = {}
    for name, _, _ in HAND_FACE_TRUNK:
        if name != "pool":
            out.update(_cv(sd, f"model1_0.{name}", name))
    out.update(_cv(sd, "model1_1.conv6_1_CPM", "conv6_1_CPM"))
    out.update(_cv(sd, "model1_1.conv6_2_CPM", "conv6_2_CPM"))
    for s in range(2, 7):
        for i in range(1, 8):
            nm = f"Mconv{i}_stage{s}"
            out.update(_cv(sd, f"model{s}.{nm}", nm))
    return out


def convert_face_pose(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`facenet.pth` (flat attribute keys) -> CPMSingleBranch(71) state
    dict."""
    out: Dict[str, torch.Tensor] = {}
    for name, _, _ in HAND_FACE_TRUNK:
        if name != "pool":
            out.update(_cv(sd, name, name))
    out.update(_cv(sd, "conv6_1_CPM", "conv6_1_CPM"))
    out.update(_cv(sd, "conv6_2_CPM", "conv6_2_CPM"))
    for s in range(2, 7):
        for i in range(1, 8):
            nm = f"Mconv{i}_stage{s}"
            out.update(_cv(sd, nm, nm))
    return out
