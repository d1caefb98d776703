"""Process-group initialization and rank helpers.

Counterpart of `magicdance_tpu.parallel.multihost` (ref train_tiktok.py:
552-562: RANK / WORLD_SIZE from the environment, then init_process_group):
`torchrun --nproc_per_node N` sets RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT, and `initialize_distributed` joins that group;
rank-conditional work (logs, sample grids, checkpoints) is gated on
`is_primary()`.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                           world_size: Optional[int] = None, rank: Optional[int] = None,
                           timeout_s: Optional[float] = None) -> None:
    """Join the process group of this run. Explicit arguments win over
    torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR / MASTER_PORT);
    with neither, a single process does nothing (as JAX's does), and a group
    already initialized returns at once. The backend defaults to NCCL when a
    GPU is present, else gloo. On a GPU the process takes the card LOCAL_RANK
    (else its rank modulo the cards it sees)."""
    if dist.is_initialized():
        return
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if world_size is None and init_method is None:
        return
    if world_size is None or rank is None:
        raise ValueError("initialize_distributed: give both world_size and rank (or "
                         "torchrun's WORLD_SIZE and RANK)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", rank % max(1, torch.cuda.device_count())))
        torch.cuda.set_device(local)
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kw)


def local_device() -> torch.device:
    """The device this process computes on: its card when it has one (the
    one `initialize_distributed` set), else the CPU."""
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def is_primary() -> bool:
    """Rank 0 of the group, or a single process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def sync_global_devices(tag: str = "barrier") -> None:
    """Barrier over every rank (the reference's dist.barrier(),
    train_tiktok.py:1146); `tag` names it in errors. A single process
    returns at once."""
    if dist.is_initialized():
        try:
            dist.barrier()
        except RuntimeError as e:
            raise RuntimeError(f"barrier {tag!r} failed: {e}") from e
