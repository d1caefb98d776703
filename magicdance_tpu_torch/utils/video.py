"""Image grids for the trainer's periodic visualization.

The PyTorch port's own copy of `save_image_grid` from
`magicdance_tpu.utils.video` (numpy and PIL only); GIF and MP4 writing are
not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from PIL import Image


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
