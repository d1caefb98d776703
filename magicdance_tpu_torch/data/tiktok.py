"""TikTok-v4 dataset: (reference frame, target frame, pose map) samples.

Host-side rebuild of the reference's local-filesystem dataset
(ref: dataset/tiktok_video_arnold_copy.py — layout
`TikTok-v4/{train_set,pose_map_train_set,disco_test_set,pose_map_disco_test_set}/
{video_id}/NNNN.png`; train sampling picks a random (reference, target) frame
pair from the same video at most `img_bin_limit` seconds apart
(:146-152); eval uses frame 0 as the reference and the remaining frames as
targets (:217-280); degenerate frames are filtered by monochrome/low-std
checks (:158-171)).

Design departures: an index-based map-style dataset (deterministic, resumable
by step count) instead of an infinite IterableDataset; sharding by
(rank, world) args — the reference's local-FS dataset never actually sharded
by rank (SURVEY.md §2.3).

The PyTorch port's own copy of `magicdance_tpu.data.tiktok` (numpy and PIL
only): `TikTokPairDataset` with the Python decode path, and
`TikTokEvalDataset`. The native C++ loader is not ported yet.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
from PIL import Image

from magicdance_tpu_torch.data.transforms import (
    center_crop_square,
    is_monochrome,
    random_resized_crop,
    resize,
    to_hint_range,
    to_model_range,
)

FRAME_RATE = 30  # TikTok-v4 videos are 30 fps frame dumps


def _list_frames(d: str) -> list[str]:
    try:
        return sorted(
            f for f in os.listdir(d) if f.lower().endswith((".png", ".jpg", ".jpeg"))
        )
    except FileNotFoundError:
        return []


def _load(path: str) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"))


@dataclass
class TikTokPairDataset:
    """Training pairs for stages 1-2."""

    root: str
    split: str = "train_set"
    pose_split: str = "pose_map_train_set"
    image_size: int = 512
    img_bin_limit: int = 29  # max seconds between ref and target (stage 2)
    use_pose: bool = True
    crop_scale: tuple[float, float] = (0.9, 1.0)
    seed: int = 0
    rank: int = 0
    world_size: int = 1

    def __post_init__(self):
        base = os.path.join(self.root, self.split)
        self.videos = [
            v for v in sorted(os.listdir(base))
            if os.path.isdir(os.path.join(base, v))
        ][self.rank :: self.world_size]
        if not self.videos:
            raise FileNotFoundError(f"no videos under {base}")
        self.frames = {
            v: _list_frames(os.path.join(base, v)) for v in self.videos
        }
        self.videos = [v for v in self.videos if len(self.frames[v]) >= 2]

    def _draw_pair(self, rng: np.random.RandomState) -> tuple[str, str, str]:
        """(video, target_frame, reference_frame): a random frame pair of the
        same video ≤ img_bin_limit seconds apart (ref :146-152)."""
        v = self.videos[rng.randint(len(self.videos))]
        frames = self.frames[v]
        i = rng.randint(len(frames))
        max_gap = self.img_bin_limit * FRAME_RATE
        lo = max(0, i - max_gap)
        hi = min(len(frames) - 1, i + max_gap)
        j = rng.randint(lo, hi + 1)
        return v, frames[i], frames[j]

    def sample(self, rng: np.random.RandomState) -> Optional[dict]:
        v, frame_i, frame_j = self._draw_pair(rng)
        img_dir = os.path.join(self.root, self.split, v)
        target = _load(os.path.join(img_dir, frame_i))
        reference = _load(os.path.join(img_dir, frame_j))
        if is_monochrome(target) or is_monochrome(reference):
            return None

        target_c, params = random_resized_crop(
            target, self.image_size, rng, scale=self.crop_scale
        )
        reference_c, _ = random_resized_crop(
            reference, self.image_size, rng, scale=self.crop_scale
        )
        out = {
            "image": to_model_range(target_c),
            "reference": to_model_range(reference_c),
        }
        if self.use_pose:
            pose_path = os.path.join(self.root, self.pose_split, v, frame_i)
            pose = _load(pose_path)
            # the pose map gets the SAME crop as its target frame
            pose_c, _ = random_resized_crop(
                pose, self.image_size, rng, params=params
            )
            out["pose"] = to_hint_range(pose_c)
        return out

    def batches(self, batch_size: int, seed: Optional[int] = None) -> Iterator[dict]:
        """Infinite batch stream of stacked numpy samples (the Python decode
        path; the JAX package's native C++ batch loader is not ported)."""
        rng = np.random.RandomState(self.seed if seed is None else seed)
        while True:
            items = []
            while len(items) < batch_size:
                s = self.sample(rng)
                if s is not None:
                    items.append(s)
            yield {
                k: np.stack([it[k] for it in items]) for k in items[0]
            }


@dataclass
class TikTokEvalDataset:
    """Eval sequences: frame 0 = reference, the rest = targets
    (ref tiktok_video_arnold_copy.py:217-280; consumed by test_tiktok and
    `cli/eval.py`). Every `every_nth` target is kept; the videos are split
    `rank::world_size` across processes."""

    root: str
    split: str = "disco_test_set"
    pose_split: str = "pose_map_disco_test_set"
    image_size: int = 512
    every_nth: int = 1
    rank: int = 0
    world_size: int = 1

    def __post_init__(self):
        base = os.path.join(self.root, self.split)
        self.videos = [
            v for v in sorted(os.listdir(base))
            if os.path.isdir(os.path.join(base, v))
        ][self.rank :: self.world_size]

    def __iter__(self) -> Iterator[dict]:
        for v in self.videos:
            img_dir = os.path.join(self.root, self.split, v)
            pose_dir = os.path.join(self.root, self.pose_split, v)
            frames = _list_frames(img_dir)
            if len(frames) < 2:
                continue
            prep = lambda p: resize(center_crop_square(_load(p)), self.image_size)  # noqa: E731
            reference = prep(os.path.join(img_dir, frames[0]))
            targets = frames[1 :: self.every_nth]
            yield {
                "video": v,
                "reference": to_model_range(reference)[None],
                "gt": np.stack(
                    [to_model_range(prep(os.path.join(img_dir, f))) for f in targets]
                ),
                "pose": np.stack(
                    [to_hint_range(prep(os.path.join(pose_dir, f))) for f in targets]
                ),
                "frame_names": targets,
            }
