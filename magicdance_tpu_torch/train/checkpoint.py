"""Checkpoint save/restore with torch.save.

Counterpart of `magicdance_tpu.train.checkpoint`: one directory per step,
`{directory}/step_{N:08d}/state.pt`, the newest `save_total_limit` kept
(ref utils/checkpoint.py:27-42), `latest_step` for resume. What is saved is
the caller's state dict -- for the trainer `Trainer.state_dict()`: step,
weights, optimizer state, EMA and the generator's state, so a resumed run
continues the same stream of draws.

Under a process group, rank 0 writes and every rank waits at a barrier
after the write; the trainer gathers its ZeRO-1 slices into the state dict
first, so a checkpoint has one layout at any world size, and every rank
restores from the same file (`Trainer.load_state_dict` re-shards).
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Optional

import torch

from magicdance_tpu_torch.parallel.multihost import is_primary, sync_global_devices


class CheckpointManager:
    """Step-indexed checkpoints under `directory` with rotation."""

    def __init__(self, directory: str, save_total_limit: int = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.save_total_limit = save_total_limit

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def all_steps(self) -> list[int]:
        steps = []
        for d in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", d)
            if m and os.path.exists(os.path.join(self.directory, d, "state.pt")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> None:
        """Write atomically (a temporary file renamed into place), then
        rotate; under a process group only rank 0 writes, and every rank
        returns after it has."""
        if is_primary():
            path = self._path(step)
            os.makedirs(path, exist_ok=True)
            tmp = os.path.join(path, "state.pt.tmp")
            torch.save(state, tmp)
            os.replace(tmp, os.path.join(path, "state.pt"))
            self._rotate()
        sync_global_devices(f"checkpoint step {step}")

    def restore(self, step: Optional[int] = None,
                map_location: Any = "cpu") -> Any:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return torch.load(os.path.join(self._path(step), "state.pt"),
                          map_location=map_location, weights_only=False)

    def _rotate(self) -> None:
        """Keep only the newest `save_total_limit` checkpoints."""
        steps = self.all_steps()
        for s in steps[:max(0, len(steps) - self.save_total_limit)]:
            shutil.rmtree(self._path(s), ignore_errors=True)
