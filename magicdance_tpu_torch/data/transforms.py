"""Image transforms for training/inference preprocessing.

NumPy/PIL reimplementations of the reference's preprocessing
(ref: dataset/transforms.py [RemoveWhite, CenterCrop],
dataset/tiktok_video_arnold_copy.py:60-80 [train/eval transform stacks:
RandomResizedCrop(512, scale=(0.9,1.0) train / (1.0,1.0) eval) + normalize
to [-1,1]], test_any_image_pose.py:46-82 [center-crop-to-512 path]).
All functions take/return HWC uint8 or float arrays (host side — this is the
CPU half of the pipeline feeding device batches).

The PyTorch port's own copy of the parts of `magicdance_tpu.data.transforms`
that the training-pair dataset, the trainer's sample grid and the sampling
CLI use (numpy and PIL only), so that the port imports nothing of the JAX
package. PIL is imported where an image is resized, so the range
conversions run without it.
"""

from __future__ import annotations

import numpy as np


def remove_white_border(img: np.ndarray, thresh: int = 245) -> np.ndarray:
    """Trim near-white margins (ref transforms.py:5 RemoveWhite)."""
    gray = img.mean(axis=2)
    rows = np.where(gray.min(axis=1) < thresh)[0]
    cols = np.where(gray.min(axis=0) < thresh)[0]
    if rows.size == 0 or cols.size == 0:
        return img
    return img[rows[0] : rows[-1] + 1, cols[0] : cols[-1] + 1]


def center_crop_square(img: np.ndarray) -> np.ndarray:
    """Crop the largest centered square (ref transforms.py:23 aspect-aware
    CenterCrop; test_any_image_pose.py:46-82)."""
    h, w = img.shape[:2]
    s = min(h, w)
    top = (h - s) // 2
    left = (w - s) // 2
    return img[top : top + s, left : left + s]


def resize(img: np.ndarray, size: int, method=None) -> np.ndarray:
    """Resize to size x size (PIL, bicubic unless `method` says)."""
    from PIL import Image

    pil = Image.fromarray(img.astype(np.uint8))
    return np.asarray(pil.resize((size, size), Image.BICUBIC if method is None else method))


def random_resized_crop(
    img: np.ndarray,
    size: int,
    rng: np.random.RandomState,
    scale: tuple[float, float] = (0.9, 1.0),
    ratio: tuple[float, float] = (1.0, 1.0),
    params: tuple | None = None,
):
    """RandomResizedCrop with optional externally-fixed params so that image,
    reference and pose map receive the SAME crop (the reference applies the
    same transform instance per sample, tiktok_video_arnold_copy.py).

    Returns (crop, params)."""
    h, w = img.shape[:2]
    if params is None:
        area = h * w
        for _ in range(10):
            target_area = rng.uniform(*scale) * area
            ar = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
            cw = int(round(np.sqrt(target_area * ar)))
            ch = int(round(np.sqrt(target_area / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                top = rng.randint(0, h - ch + 1)
                left = rng.randint(0, w - cw + 1)
                params = (top, left, ch, cw)
                break
        if params is None:  # fallback: center square
            s = min(h, w)
            params = ((h - s) // 2, (w - s) // 2, s, s)
    top, left, ch, cw = params
    crop = img[top : top + ch, left : left + cw]
    return resize(crop, size), params


def to_model_range(img: np.ndarray) -> np.ndarray:
    """uint8 [0,255] → float32 [-1,1] (images/reference)."""
    return img.astype(np.float32) / 127.5 - 1.0


def to_hint_range(img: np.ndarray) -> np.ndarray:
    """uint8 [0,255] → float32 [0,1] (pose hint maps, ref get_cond_control
    train_tiktok.py:283)."""
    return img.astype(np.float32) / 255.0


def from_model_range(img: np.ndarray) -> np.ndarray:
    # Non-finite pixels are mapped to black so random-weight smoke runs don't
    # trip the uint8 cast — but a real sampler producing NaN/Inf is a genuine
    # numerical failure, so warn instead of hiding it. The guard is a single
    # scalar reduction (NaN/Inf propagate through sum), not a full isfinite
    # materialization, to keep the hot decode path cheap.
    if not np.isfinite(np.sum(img, dtype=np.float64)):
        import warnings

        n_bad = int(np.size(img) - np.isfinite(img).sum())
        warnings.warn(
            f"from_model_range: {n_bad} non-finite pixel values mapped to "
            "black — sampler output is numerically broken unless this is a "
            "random-weight smoke run",
            RuntimeWarning,
            stacklevel=2,
        )
    return np.clip(np.nan_to_num((img + 1.0) * 127.5), 0, 255).astype(np.uint8)


def prepare_image(
    img: np.ndarray, size: int = 512, crop_to_square: bool = True
) -> np.ndarray:
    """Inference-time reference/pose preprocessing: trim, square-crop, resize
    (ref test_any_image_pose.py:46-82)."""
    if crop_to_square:
        img = center_crop_square(img)
    return resize(img, size)


def is_monochrome(img: np.ndarray, std_thresh: float = 10.0) -> bool:
    """Degenerate-frame filter (ref tiktok_video_arnold_copy.py:158-171
    monochrome/low-std filters)."""
    return float(img.astype(np.float32).std()) < std_thresh
