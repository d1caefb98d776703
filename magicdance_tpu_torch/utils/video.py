"""Frame folders, GIF / MP4 assembly and image grids (ref:
tool/video/gen_vid.py, tool/video/gen_gifs_for_fvd.py; the trainer's
periodic visualization).

The PyTorch port's own copy of `magicdance_tpu.utils.video` (numpy and PIL;
cv2, imported where an MP4 is written).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
from PIL import Image


def list_frames(folder: str) -> list[str]:
    return sorted(
        os.path.join(folder, f)
        for f in os.listdir(folder)
        if f.lower().endswith((".png", ".jpg", ".jpeg"))
    )


def frames_to_gif(
    frames: Sequence[np.ndarray] | str,
    out_path: str,
    fps: int = 10,
) -> str:
    if isinstance(frames, str):
        frames = [np.asarray(Image.open(p).convert("RGB")) for p in list_frames(frames)]
    imgs = [Image.fromarray(f.astype(np.uint8)) for f in frames]
    imgs[0].save(
        out_path, save_all=True, append_images=imgs[1:],
        duration=int(1000 / fps), loop=0,
    )
    return out_path


def frames_to_mp4(
    frames: Sequence[np.ndarray] | str,
    out_path: str,
    fps: int = 30,
) -> str:
    import cv2

    if isinstance(frames, str):
        frames = [np.asarray(Image.open(p).convert("RGB")) for p in list_frames(frames)]
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(
        out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
    )
    for f in frames:
        vw.write(cv2.cvtColor(f.astype(np.uint8), cv2.COLOR_RGB2BGR))
    vw.release()
    return out_path


def save_image_grid(
    rows: Sequence[Sequence[np.ndarray]], out_path: str, pad: int = 2
) -> str:
    """Comparison grids like the trainer's periodic visualization
    (ref train_tiktok.py:388-531: GT | pose | generated | reference)."""
    h = max(img.shape[0] for row in rows for img in row)
    w = max(img.shape[1] for row in rows for img in row)
    R, C = len(rows), max(len(r) for r in rows)
    canvas = np.full((R * (h + pad), C * (w + pad), 3), 255, np.uint8)
    for i, row in enumerate(rows):
        for j, img in enumerate(row):
            canvas[
                i * (h + pad) : i * (h + pad) + img.shape[0],
                j * (w + pad) : j * (w + pad) + img.shape[1],
            ] = img.astype(np.uint8)
    Image.fromarray(canvas).save(out_path)
    return out_path
