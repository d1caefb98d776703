"""Device time of a piece of GPU work, from CUDA events.

`device_time_ms(fn)` times n back-to-back calls of fn() on the card. The
calls are queued behind a sleep kernel that outlasts the host's enqueueing of
them (checked on each timed loop, which is repeated behind a longer sleep
where the card may have waited), so the card runs them without gaps and the
events measure the card, also where one call's host work (Python, argument
checks, the launch) takes longer than its kernels -- which, without the
sleep, would make the events measure the host's launch rate. fn must not wait on the card (no
`.item()`, no synchronize); otherwise the result includes that wait.

`host_call_us(fn)` is the host time of one call, the launch's share of a
host-bound path. `card_line()` is the card's name and power limit, to print
beside every time: a card set below its top power limit runs slower under
load.
"""

from __future__ import annotations

import subprocess
import time
import warnings
from typing import Callable

import torch

# The H100's top SM clock: the sleep is given in clock cycles, and at any
# lower clock the same cycles last longer, which keeps the queue ahead.
SLEEP_CLOCK_HZ = 1.98e9


def device_time_ms(fn: Callable[[], object], min_total_s: float = 0.25,
                   max_iters: int = 50, attempts: int = 2) -> float:
    """Mean device time of fn() in ms over n calls (3 <= n <= max_iters, about
    min_total_s of work), after a warm-up call.

    A timed loop is taken when the host finished enqueueing it before the
    sleep ended, or when the card still had more than 1.5 calls of queued
    work once the host finished (a full launch queue held the host back, so
    the card ran without gaps). Otherwise the card may have waited for the
    host, and the loop is timed again behind a sleep twice as long as that
    enqueueing, up to `attempts` loops; the last reading is returned with a
    warning if none qualified."""
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
    sleep_s = 1.5 * (time.perf_counter() - t0) + 5e-5
    torch.cuda.synchronize()
    for _ in range(attempts):
        before, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        before.record()
        torch.cuda._sleep(int(sleep_s * SLEEP_CLOCK_HZ))
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        slept_s = before.elapsed_time(start) / 1e3
        loop_s = start.elapsed_time(end) / 1e3
        if enqueue_s < slept_s or slept_s + loop_s - enqueue_s > 1.5 * loop_s / n:
            return loop_s * 1e3 / n
        sleep_s = 2 * enqueue_s
    warnings.warn(f"device_time_ms: the card may have waited for the host in each of "
                  f"{attempts} loops of {n} calls; the reading may include host time")
    return loop_s * 1e3 / n


def host_call_us(fn: Callable[[], object], calls: int = 50) -> float:
    """Mean host time of one call of fn() in microseconds: for a wrapper
    that launches one kernel, its checks and the launch. The card drains
    before and after, outside the timed loop."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def card_line() -> str:
    """The first card's `name, power.limit` as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
