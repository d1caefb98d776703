"""Metric logging: TensorBoard when available, JSONL always.

Rebuild of the reference's rank-0 SummaryWriter + stdout logging
(ref train_tiktok.py:558-573,1246-1255). JSONL is the durable record; TB is
optional sugar (torch's SummaryWriter is used when importable).

The PyTorch port's own copy of `magicdance_tpu.utils.logging`.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping


class MetricLogger:
    def __init__(self, directory: str, enable_tb: bool = True):
        os.makedirs(directory, exist_ok=True)
        self._jsonl = open(os.path.join(directory, "metrics.jsonl"), "a")
        self._tb = None
        if enable_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(directory)
            except Exception:
                self._tb = None

    def log(self, step: int, metrics: Mapping[str, float]) -> None:
        rec = {"step": step, "time": time.time(), **{k: float(v) for k, v in metrics.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), step)

    def log_image(self, step: int, tag: str, image) -> None:
        """An (H, W, C) or (C, H, W) image to TensorBoard (nothing without
        it): HWC with 1 or 3 channels is transposed to CHW."""
        if self._tb is not None:
            import numpy as np

            arr = np.asarray(image)
            if arr.ndim == 3 and arr.shape[-1] in (1, 3):
                arr = arr.transpose(2, 0, 1)
            self._tb.add_image(tag, arr, step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
