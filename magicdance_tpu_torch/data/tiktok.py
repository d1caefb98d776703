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

The PyTorch port's own copy of `magicdance_tpu.data.tiktok` (numpy, PIL
and the port's native C++ batch loader, `data.native`): `TikTokPairDataset`
with the Python decode path and the native batch path, and
`TikTokEvalDataset`.
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

    def batches(
        self,
        batch_size: int,
        seed: Optional[int] = None,
        use_native: Optional[bool] = None,
    ) -> Iterator[dict]:
        """Infinite batch stream. When the native C++ decode core is
        available (default auto-detect), the whole batch is decoded, cropped
        and normalized by `md_batch_load_rrc` — multi-threaded, GIL-free —
        with the same shared-crop-per-sample semantics as the Python path
        (target and pose map share a crop seed).

        Known semantic difference: the native path applies the monochrome
        filter to the decoded CROP (the core returns only the crop), while
        the Python path (and the reference, tiktok_video_arnold_copy.py:
        158-171) checks the full frame before cropping. At the default
        crop_scale (0.9, 1.0) the crop covers ≥90 % of the frame, so the
        filters agree except on frames whose uniform region dominates a
        near-full crop — a stricter, not looser, filter."""
        from magicdance_tpu_torch.data.native import native_rrc_available

        if use_native is None:
            use_native = native_rrc_available()
        rng = np.random.RandomState(self.seed if seed is None else seed)
        if use_native and self.use_pose and not self._pose_dims_match():
            # the native path aligns the pose crop with the target crop by
            # sharing the seed, which only holds when both images have the
            # same dimensions — otherwise use the Python path's explicit
            # shared crop params
            import logging

            logging.getLogger(__name__).warning(
                "pose maps are not frame-sized; native batch path would "
                "misalign crops — falling back to the Python loader")
            use_native = False
        if use_native:
            yield from self._native_batches(batch_size, rng)
            return
        while True:
            items = []
            while len(items) < batch_size:
                s = self.sample(rng)
                if s is not None:
                    items.append(s)
            yield {
                k: np.stack([it[k] for it in items]) for k in items[0]
            }

    def _pose_dims_match(self) -> bool:
        """The shared-seed crop trick requires pose map dims == frame dims
        (rrc_params derives the crop from the image dims). Probe ONE pair
        per video — PIL reads only the header, so this is a one-time
        O(#videos) header scan, and it catches datasets where only SOME
        videos have off-sized pose maps (a single random probe would not)."""
        for video in self.videos:
            frames = self.frames[video]
            if not frames:
                continue
            fp = os.path.join(self.root, self.split, video, frames[0])
            pp = os.path.join(self.root, self.pose_split, video, frames[0])
            try:
                with Image.open(fp) as a, Image.open(pp) as b:
                    if a.size != b.size:
                        return False
            except Exception:
                continue  # missing files surface later with a clearer error
        return True

    def _native_batches(
        self, batch_size: int, rng: np.random.RandomState
    ) -> Iterator[dict]:
        from magicdance_tpu_torch.data.native import batch_load_images_rrc

        def to_u8(x):
            return np.clip((x + 1.0) * 127.5, 0, 255).astype(np.uint8)

        B = batch_size
        while True:
            picks = [self._draw_pair(rng) for _ in range(B)]
            seeds_t = [int(rng.randint(1 << 31)) for _ in range(B)]
            seeds_r = [int(rng.randint(1 << 31)) for _ in range(B)]
            targets = np.empty((B, self.image_size, self.image_size, 3),
                               np.float32)
            refs = np.empty_like(targets)
            redo = list(range(B))
            for _ in range(10):  # resample degenerate (monochrome) picks
                tp = [os.path.join(self.root, self.split, picks[k][0],
                                   picks[k][1]) for k in redo]
                rp = [os.path.join(self.root, self.split, picks[k][0],
                                   picks[k][2]) for k in redo]
                targets[redo] = batch_load_images_rrc(
                    tp, self.image_size, [seeds_t[k] for k in redo],
                    self.crop_scale)
                refs[redo] = batch_load_images_rrc(
                    rp, self.image_size, [seeds_r[k] for k in redo],
                    self.crop_scale)
                redo = [k for k in redo
                        if is_monochrome(to_u8(targets[k]))
                        or is_monochrome(to_u8(refs[k]))]
                if not redo:
                    break
                for k in redo:
                    picks[k] = self._draw_pair(rng)
                    seeds_t[k] = int(rng.randint(1 << 31))
                    seeds_r[k] = int(rng.randint(1 << 31))
            if redo:
                # the Python path never yields monochrome frames; if 10
                # resample rounds could not clear the batch, say so rather
                # than silently training on degenerate pairs
                import logging

                logging.getLogger(__name__).warning(
                    "native loader: %d monochrome frame(s) survived 10 "
                    "resample rounds and were yielded", len(redo))
            out = {"image": targets, "reference": refs}
            if self.use_pose:
                pp = [os.path.join(self.root, self.pose_split, v, fi)
                      for v, fi, _ in picks]
                # pose maps share their target frame's crop seed (same dims
                # -> identical crop), in hint range [0, 1]
                out["pose"] = batch_load_images_rrc(
                    pp, self.image_size, seeds_t, self.crop_scale,
                    scale=1.0 / 255.0, offset=0.0)
            yield out


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
