"""Profiling and device-memory observability (PyTorch).

Counterpart of `magicdance_tpu.utils.profiling`: `trace` records a
`torch.profiler` trace (host and, when there is a GPU, device activity) and
writes it as a Chrome trace; `span` names a region of the program in it;
`top_ops` ranks the device kernels by total time and
`device_busy_ms` gives the device's busy time within its span;
`device_memory_stats` reads the CUDA caching allocator's counters (an empty
dict on the CPU, as the JAX package's on a backend without stats).

The program's spans (`md.` names) nest as: `md.request` (one
`MagicPosePipeline.sample_frames` call) > `md.clip`, `md.vae.encode`,
`md.ddim.step` > `md.pass.{bank_write, controlnet, unet_cond, unet_uncond,
unet_fused}` > `md.attn`, and `md.vae.decode` a decode chunk; in training
`md.train.step` > `md.train.{encode, forward, backward, optimizer}`, with
`md.remat` around each recomputed block (in the forward and again in the
backward's recompute) and `md.attn.bwd` in the attention Functions'
backward, both on autograd's device thread. Attention spans carry their
shapes in the name (`CrossAttention.span_detail`, `flash_vjp.bwd_detail`).
"""

from __future__ import annotations

import contextlib
import os

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


_OFF = contextlib.nullcontext()


def span(name: str, detail=None, *args):
    """A named region of the program in the profiler's trace, entered with
    `with`: a `torch.profiler.record_function` (a host event on the device
    trace's clock, also on autograd's device thread, which inherits the
    caller's profiler state) while a profiler records (`torch.profiler`,
    `trace`, `emit_nvtx`), else one shared null context, at the cost of one
    check. `detail(*args)`, called only while recording, is appended to the
    name: " key=value" fields such as shapes or an index."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name if detail is None else name + detail(*args))


def dims(t: torch.Tensor) -> str:
    """A tensor's shape as a span field value: "2x4096x320"."""
    return "x".join(map(str, t.shape))


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
