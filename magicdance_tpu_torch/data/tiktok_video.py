"""F-frame clip dataset for temporal (stage-3) training.

The PyTorch port's own copy of `magicdance_tpu.data.tiktok_video` (numpy and
PIL only; ref dataset/tiktok_video_mm.py: 16-frame clips with per-frame pose
maps (:236-262) and a reference frame from the same video; video_length 16
is hardcoded in the reference's motion modules, motion_module.py:137), on
the TikTok-v4 frame-folder tree of `data.tiktok`.

Batch layout: frames folded into the batch axis, image and pose
(B_clips * F, H, W, C) with static F, reference (B_clips, H, W, 3): one
reference per clip (ref train_tiktok.py:1189-1200). One crop serves a whole
clip and its pose maps.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from magicdance_tpu_torch.data.tiktok import _list_frames, _load
from magicdance_tpu_torch.data.transforms import (
    is_monochrome,
    random_resized_crop,
    to_hint_range,
    to_model_range,
)


@dataclass
class TikTokClipDataset:
    root: str
    split: str = "train_set"
    pose_split: str = "pose_map_train_set"
    image_size: int = 256
    clip_len: int = 16
    frame_stride: int = 4  # temporal subsampling within the clip
    use_pose: bool = True
    crop_scale: tuple[float, float] = (0.9, 1.0)
    seed: int = 0
    rank: int = 0
    world_size: int = 1

    def __post_init__(self):
        base = os.path.join(self.root, self.split)
        self.videos = [v for v in sorted(os.listdir(base))
                       if os.path.isdir(os.path.join(base, v))][self.rank::self.world_size]
        self.frames = {v: _list_frames(os.path.join(base, v)) for v in self.videos}
        need = self.clip_len * self.frame_stride
        self.videos = [v for v in self.videos if len(self.frames[v]) >= need + 1]
        if not self.videos:
            raise FileNotFoundError(f"no videos with >= {need + 1} frames under {base}")

    def sample(self, rng: np.random.RandomState) -> Optional[dict]:
        """One clip, or None when its reference frame is degenerate."""
        v = self.videos[rng.randint(len(self.videos))]
        frames = self.frames[v]
        span = self.clip_len * self.frame_stride
        start = rng.randint(0, len(frames) - span)
        idx = [start + i * self.frame_stride for i in range(self.clip_len)]
        ref_i = rng.randint(len(frames))

        img_dir = os.path.join(self.root, self.split, v)
        ref = _load(os.path.join(img_dir, frames[ref_i]))
        if is_monochrome(ref):
            return None
        ref_c, _ = random_resized_crop(ref, self.image_size, rng, scale=self.crop_scale)

        clip, poses = [], []
        params = None
        for i in idx:
            img = _load(os.path.join(img_dir, frames[i]))
            img_c, params = random_resized_crop(img, self.image_size, rng,
                                                scale=self.crop_scale, params=params)
            clip.append(to_model_range(img_c))
            if self.use_pose:
                pose = _load(os.path.join(self.root, self.pose_split, v, frames[i]))
                pose_c, _ = random_resized_crop(pose, self.image_size, rng, params=params)
                poses.append(to_hint_range(pose_c))
        out = {"image": np.stack(clip), "reference": to_model_range(ref_c)[None]}
        if self.use_pose:
            out["pose"] = np.stack(poses)
        return out

    def batches(self, batch_clips: int, seed: Optional[int] = None) -> Iterator[dict]:
        """Yields frame-folded batches: image/pose (B*F, ...), reference
        (B, ...)."""
        rng = np.random.RandomState(self.seed if seed is None else seed)
        while True:
            items = []
            while len(items) < batch_clips:
                s = self.sample(rng)
                if s is not None:
                    items.append(s)
            batch = {k: np.concatenate([it[k] for it in items])
                     for k in ("image", "reference")}
            if self.use_pose:
                batch["pose"] = np.concatenate([it["pose"] for it in items])
            yield batch
