"""Profiling and device-memory observability (PyTorch).

Counterpart of `magicdance_tpu.utils.profiling`: `trace` records a
`torch.profiler` trace (host and, when there is a GPU, device activity) and
writes it as a Chrome trace; `annotate` names a region in it;
`top_ops` ranks the device kernels by total time and
`device_busy_ms` gives the device's busy time within its span;
`device_memory_stats` reads the CUDA caching allocator's counters (an empty
dict on the CPU, as the JAX package's on a backend without stats);
`StepTimer` is a rolling wall-clock rate.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


def device_memory_stats(device=None) -> dict:
    """{bytes_in_use, peak_bytes_in_use, bytes_limit} of a CUDA device (the
    current one by default); an empty dict for the CPU or without a GPU."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(device).total_memory}


def log_peak_memory(tag: str, logger=None) -> dict:
    """One `[mem] tag: ...` line of `device_memory_stats` in GB; the peak also
    goes to `logger` (a `utils.logging.MetricLogger`) when given."""
    stats = device_memory_stats()
    msg = f"[mem] {tag}: " + ", ".join(f"{k}={v / 1e9:.2f}GB" for k, v in stats.items())
    print(msg, flush=True)
    if logger is not None and "peak_bytes_in_use" in stats:
        logger.log(0, {f"mem/{tag}": stats["peak_bytes_in_use"]})
    return stats


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace"):
    """Profile the block with `torch.profiler` (CPU activity, and CUDA
    activity when a GPU is present); yields the profiler, whose
    `key_averages()` the caller may read after the block, and writes
    `<log_dir>/<name>.json` (a Chrome trace, loadable in Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))


def annotate(name: str):
    """A named region visible in profiler traces."""
    return torch.profiler.record_function(name)


def device_events(prof) -> list:
    """The device activity of a finished profile: kernels, copies and sets
    (the events on the CUDA timeline), without the ranges of annotations."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_busy_ms(prof) -> tuple[float, float]:
    """(busy, span) in ms of a finished profile's device activity: the
    union of its intervals, and the time from the first start to the last
    end. span - busy is the time the device sat idle in between."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in device_events(prof))
    busy, end = 0.0, None
    for a, b in iv:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    span = (iv[-1][1] - iv[0][0]) if iv else 0.0
    return busy / 1e3, span / 1e3


def top_ops(prof, n: int = 10) -> list[dict]:
    """The `n` device operations (kernels and copies, by name) of a finished
    profile with the most total time. Each {name, count, total_ms, mean_ms}."""
    totals: dict = {}
    for e in device_events(prof):
        t, c = totals.get(e.name, (0.0, 0))
        totals[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    rows = sorted(totals.items(), key=lambda kv: -kv[1][0])[:n]
    return [dict(name=k, count=c, total_ms=t / 1e3, mean_ms=t / 1e3 / c)
            for k, (t, c) in rows]


class StepTimer:
    """Rolling wall-clock step timer."""

    def __init__(self, window: int = 50):
        self.window = window
        self._t: list[float] = []

    def tick(self) -> None:
        self._t.append(time.time())
        if len(self._t) > self.window + 1:
            self._t.pop(0)

    @property
    def steps_per_sec(self) -> Optional[float]:
        if len(self._t) < 2:
            return None
        return (len(self._t) - 1) / (self._t[-1] - self._t[0])
