"""Spans and the device trace, from the benchmark's side of the program.

`Spans` puts named ranges around the program's calls with forward hooks and
instance wrappers (nothing inside the program changes): the passes of a
request or step (`pb.<pass>`), and every attention module's call
(`pb.attn#<n>`, with the least time of its work from its shapes). CUDA
events around the VAE calls give their device time over a whole window.

`profile_segment` runs a short segment under `torch.profiler` and reduces
its raw trace (Kineto events): the device's busy time (the union of its
kernel, copy and set intervals, the arithmetic of the program's
`utils/profiling.py::device_busy_ms`, copied) against the segment's span,
the device operations with the most time, the idle gaps between them by the
span whose host code launched the kernel that ended the gap, and the device
time of the kernels each attention call launched (a kernel belongs to the
span in which its launch ran on the host).
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch

from port_bench.harness.yardstick import attention_module_bound_s

def _user_annotation(e) -> bool:
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if callable(flag) else e.name().startswith("pb.")


def classify(events) -> tuple[list, dict, list]:
    """(device, launches, spans) of raw Kineto events, by what every
    PyTorch version's events carry: device activity (kernels, copies,
    sets) as (name, start, end, correlation); host launch calls (the
    runtime or driver calls, `cu*`, that share a device activity's
    correlation id) as {correlation: (thread, start)}; the benchmark's `pb.`
    spans as (start, end, thread, name). A device event's linked id names
    the PyTorch op around its launch, 0 for a launch outside any op (the
    port's own kernels), and op ids share numbers with launch ids: only the
    launch call's own correlation ties a kernel to its host time."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if not _user_annotation(e):
                start = e.start_ns()
                device.append((e.name(), start, start + e.duration_ns(), e.correlation_id()))
        else:
            host.append(e)
    wanted = {d[3] for d in device}
    launches, spans = {}, []
    for e in host:
        name = e.name()
        if name.startswith("pb."):
            start = e.start_ns()
            spans.append((start, start + e.duration_ns(), e.start_thread_id(), name))
        elif name.startswith("cu") and e.correlation_id() in wanted:
            launches[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
    return device, launches, spans


class Spans:
    """Hooks that name the program's passes and attention calls while
    `active`; VAE call timing with CUDA events while `timing`."""

    def __init__(self):
        self.handles = []
        self.active = False
        self.timing = False
        self.attn_bounds: list[float] = []
        self.vae_events: list = []   # (start event, end event, frames)
        self._open: dict = {}

    # -- passes and attention --------------------------------------------------
    def _enter(self, key, name):
        if self.active:
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            self._open.setdefault(key, []).append(rf)

    def _exit(self, key):
        stack = self._open.get(key)
        if stack:
            stack.pop().__exit__(None, None, None)

    def name_pass(self, module: torch.nn.Module, name):
        """A span around every forward of `module`; `name(args, kwargs)` or a
        string names it."""
        key = ("pass", id(module))

        def pre(mod, args, kwargs):
            self._enter(key, name(args, kwargs) if callable(name) else name)

        def post(mod, args, kwargs, out):
            self._exit(key)

        self.handles.append(module.register_forward_pre_hook(pre, with_kwargs=True))
        self.handles.append(module.register_forward_hook(post, with_kwargs=True))

    def name_attention(self, module: torch.nn.Module):
        """A span around every call of an attention module (q from x, k/v
        from the context or x, plus an optional bank), with its bound. A
        context is the traffic's one prompt, shared by the batch."""
        key = ("attn", id(module))

        def pre(mod, args, kwargs):
            if not self.active:
                return
            x = args[0]
            ctx = kwargs.get("context", args[1] if len(args) > 1 else None)
            bank = kwargs.get("kv_extra", args[2] if len(args) > 2 else None)
            b, sq, cq = x.shape
            inner = mod.to_q.out_features
            src = ctx if ctx is not None else x
            bound = attention_module_bound_s(
                b, sq, cq, inner, src.shape[1], src.shape[2], ctx is not None,
                bank_rows=0 if bank is None else bank.shape[1],
                bank_batch=0 if bank is None else bank.shape[0])
            self._enter(key, f"pb.attn#{len(self.attn_bounds)}")
            self.attn_bounds.append(bound)

        def post(mod, args, kwargs, out):
            if self.active:
                self._exit(key)

        self.handles.append(module.register_forward_pre_hook(pre, with_kwargs=True))
        self.handles.append(module.register_forward_hook(post, with_kwargs=True))

    def wrap(self, owner, attr: str, name: str, frames_of=None):
        """Replace `owner.attr` (a bound method) on the instance by one that
        opens a span while `active` and records CUDA events while `timing`;
        `frames_of(args, result)` counts the frames it handled."""
        inner = getattr(owner, attr)
        key = ("wrap", id(owner), attr)

        def call(*args, **kwargs):
            self._enter(key, name)
            ev = None
            if self.timing and frames_of is not None:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            try:
                out = inner(*args, **kwargs)
            finally:
                self._exit(key)
            if ev is not None and frames_of is not None:
                ev[1].record()
                self.vae_events.append((ev[0], ev[1], frames_of(args, out)))
            return out

        setattr(owner, attr, call)

    def vae_ms_per_frame(self):
        """Device time of the timed calls per frame, or None without any."""
        if not self.vae_events:
            return None
        torch.cuda.synchronize()
        ms = sum(a.elapsed_time(b) for a, b, _ in self.vae_events)
        return ms / sum(n for *_, n in self.vae_events)

    def remove(self):
        for h in self.handles:
            h.remove()
        self.handles = []


@dataclass
class Segment:
    wall_s: float
    busy_s: float
    span_s: float
    device_ops: list = field(default_factory=list)   # [[name, seconds]], most time first
    idle_gaps: list = field(default_factory=list)    # [[host span, seconds]]
    attn_bound_s: float = 0.0
    attn_device_s: float = 0.0
    attn_calls: int = 0


def busy_union_ns(intervals) -> tuple[int, list]:
    """(busy, merged) of [(start, end)] intervals: the length of their union
    and the merged intervals (`utils/profiling.py::device_busy_ms`'s loop)."""
    busy, end, merged = 0, None, []
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            merged.append([a, b])
            end = b
        elif b > end:
            busy += b - end
            merged[-1][1] = b
            end = b
    return busy, merged


class _Ranges:
    """Host spans of one kind, non-overlapping within a thread, searchable
    by thread and time."""

    def __init__(self, spans):
        self.by_thread: dict = {}
        for start, end, tid, name in sorted(spans):
            self.by_thread.setdefault(tid, []).append((start, end, name))
        self.starts = {tid: [s[0] for s in v] for tid, v in self.by_thread.items()}

    def at(self, thread, t):
        spans = self.by_thread.get(thread)
        if not spans:
            return None
        i = bisect.bisect_right(self.starts[thread], t) - 1
        if i >= 0 and spans[i][1] >= t:
            return spans[i][2]
        return None


def reduce_trace(events, bounds) -> Segment:
    """The segment's numbers from its raw profiler events."""
    dev, launch, ann = classify(events)
    if not dev:
        return Segment(0.0, 0.0, 0.0)
    busy, merged = busy_union_ns([(a, b) for _, a, b, _ in dev])
    span = merged[-1][1] - merged[0][0]
    per_op: dict = {}
    for name, a, b, _ in dev:
        per_op[name] = per_op.get(name, 0) + (b - a)
    attn = _Ranges([a for a in ann if a[3].startswith("pb.attn#")])
    passes = _Ranges([a for a in ann if not a[3].startswith("pb.attn#")
                      and a[3] != "pb.segment"])
    main = next((a[2] for a in ann if a[3] == "pb.segment"), None)
    attn_dev = [0] * len(bounds)
    first_after: dict = {}
    for _, a, b, corr in sorted(dev, key=lambda d: d[1]):
        where = launch.get(corr)
        if where is None:
            continue
        tid, t = where
        name = attn.at(tid, t)
        if name is not None:
            n = int(name.split("#")[1])
            if n < len(attn_dev):
                attn_dev[n] += b - a
        first_after.setdefault(a, (tid, t))
    gaps: dict = {}
    for (_, a1), (b0, _) in zip(merged, merged[1:]):
        tid, t = first_after.get(b0, (None, None))
        label = passes.at(tid, t) if tid is not None else None
        if label is None:
            label = ("host:" + ("main thread" if tid == main else "other thread")
                     if tid is not None else "host:unattributed")
        gaps[label] = gaps.get(label, 0) + (b0 - a1)
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    counted = [i for i, d in enumerate(attn_dev) if d > 0]
    return Segment(
        wall_s=0.0, busy_s=busy / 1e9, span_s=span / 1e9,
        device_ops=[[k, v / 1e9] for k, v in top],
        idle_gaps=[[k, v / 1e9] for k, v in top_gaps],
        attn_bound_s=sum(bounds[i] for i in counted),
        attn_device_s=sum(attn_dev[i] for i in counted) / 1e9,
        attn_calls=len(counted))


def profile_segment(fn, spans: Spans) -> Segment:
    """fn() under the profiler with the spans on, reduced in memory: no
    trace file is written."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    spans.attn_bounds = []
    spans.active = True
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with torch.profiler.record_function("pb.segment"):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        spans.active = False
    seg = reduce_trace(prof.profiler.kineto_results.events(), spans.attn_bounds)
    seg.wall_s = wall
    return seg
