"""Random mask generators for inpainting-style augmentation.

NumPy rebuild of the reference's mask zoo (ref: dataset/mask.py — random
bbox masks (:35 random_bbox), free-form brush strokes (brush_stroke_mask),
and the dispatching `get_mask` (:342)), used by the mask-conditioned model
variants (ControlLDMVideoMaskPose, cldm.py:985; first-conv zero-pad surgery
train_tiktok.py:251-271).

Masks are (H, W, 1) float32 in {0,1}; 1 = hole/masked region.

The PyTorch port's own copy of `magicdance_tpu.data.mask` (numpy and cv2
only): the same generator draws give the same masks.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


def random_bbox_mask(
    h: int,
    w: int,
    rng: np.random.RandomState,
    min_frac: float = 0.25,
    max_frac: float = 0.5,
) -> np.ndarray:
    mask = np.zeros((h, w, 1), np.float32)
    bh = rng.randint(int(h * min_frac), int(h * max_frac) + 1)
    bw = rng.randint(int(w * min_frac), int(w * max_frac) + 1)
    top = rng.randint(0, h - bh + 1)
    left = rng.randint(0, w - bw + 1)
    mask[top : top + bh, left : left + bw] = 1.0
    return mask


def brush_stroke_mask(
    h: int,
    w: int,
    rng: np.random.RandomState,
    min_strokes: int = 1,
    max_strokes: int = 4,
    min_vertices: int = 4,
    max_vertices: int = 12,
    mean_angle: float = 2 * math.pi / 5,
    angle_range: float = 2 * math.pi / 15,
    min_width: int = 12,
    max_width: int = 40,
) -> np.ndarray:
    """Free-form strokes: random walks rendered with thick round joints."""
    import cv2

    mask = np.zeros((h, w), np.float32)
    for _ in range(rng.randint(min_strokes, max_strokes + 1)):
        n = rng.randint(min_vertices, max_vertices + 1)
        x = rng.randint(0, w)
        y = rng.randint(0, h)
        width = rng.randint(min_width, max_width + 1)
        for i in range(n):
            angle = rng.uniform(mean_angle - angle_range, mean_angle + angle_range)
            if i % 2 == 0:
                angle = 2 * math.pi - angle
            length = rng.randint(10, max(11, min(h, w) // 4))
            nx = int(np.clip(x + length * math.cos(angle), 0, w - 1))
            ny = int(np.clip(y + length * math.sin(angle), 0, h - 1))
            cv2.line(mask, (x, y), (nx, ny), 1.0, width)
            cv2.circle(mask, (x, y), width // 2, 1.0, -1)
            x, y = nx, ny
        cv2.circle(mask, (x, y), width // 2, 1.0, -1)
    return mask[..., None]


def irregular_mask(
    h: int, w: int, rng: np.random.RandomState, blobs: int = 6
) -> np.ndarray:
    """Union of random rectangles + ellipses."""
    import cv2

    mask = np.zeros((h, w), np.float32)
    for _ in range(blobs):
        if rng.rand() < 0.5:
            bh, bw = rng.randint(h // 8, h // 3), rng.randint(w // 8, w // 3)
            top, left = rng.randint(0, h - bh), rng.randint(0, w - bw)
            mask[top : top + bh, left : left + bw] = 1.0
        else:
            c = (rng.randint(0, w), rng.randint(0, h))
            ax = (rng.randint(w // 10, w // 4), rng.randint(h // 10, h // 4))
            cv2.ellipse(mask, c, ax, rng.randint(0, 180), 0, 360, 1.0, -1)
    return mask[..., None]


def get_mask(
    h: int,
    w: int,
    rng: Optional[np.random.RandomState] = None,
    kind: str = "random",
) -> np.ndarray:
    """Dispatching entry (ref mask.py:342 get_mask)."""
    rng = rng or np.random.RandomState()
    if kind == "random":
        kind = ["bbox", "brush", "irregular"][rng.randint(3)]
    if kind == "bbox":
        return random_bbox_mask(h, w, rng)
    if kind == "brush":
        return brush_stroke_mask(h, w, rng)
    if kind == "irregular":
        return irregular_mask(h, w, rng)
    raise ValueError(f"unknown mask kind {kind!r}")
