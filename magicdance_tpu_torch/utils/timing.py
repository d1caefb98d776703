"""Device time of a piece of GPU work, from CUDA events.

`device_time_ms(fn)` times n back-to-back calls of fn() on the card. The
calls are queued behind a sleep kernel that outlasts the host's enqueueing of
them, so the card runs them without gaps and the events measure the card,
also where one call's host work (Python, argument checks, the launch) takes
longer than its kernels -- which, without the sleep, would make the events
measure the host's launch rate. fn must not wait on the card (no
`.item()`, no synchronize); otherwise the result includes that wait.

`card_line()` is the card's name and power limit, to print beside every
time: a card set below its top power limit runs slower under load.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable

import torch

# The H100's top SM clock: the sleep is given in clock cycles, and at any
# lower clock the same cycles last longer, which keeps the queue ahead.
SLEEP_CLOCK_HZ = 1.98e9


def device_time_ms(fn: Callable[[], object], min_total_s: float = 0.25,
                   max_iters: int = 50) -> float:
    """Mean device time of fn() in ms over n calls (3 <= n <= max_iters, about
    min_total_s of work), after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t0
    n = max(3, min(max_iters, int(min_total_s / max(once, 1e-6))))
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(1.5 * enqueue_s * SLEEP_CLOCK_HZ) + 100_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def card_line() -> str:
    """The first card's `name, power.limit` as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
