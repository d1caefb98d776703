"""The program's own spans in a profiled segment's raw trace.

The port names its work with `md.` spans (`magicdance_tpu_torch/utils/
profiling.py::span`, on only while a profiler records): `md.request` >
`md.ddim.step` > `md.pass.*` > `md.attn`, `md.clip`, `md.vae.*`, and in
training `md.train.step` > `md.train.{encode,forward,backward,optimizer}`,
with `md.remat` and `md.attn.bwd` on autograd's device thread. Attention
spans carry their shapes in the name (" key=value" fields). `reduce` reads
them from the same raw Kineto events `tracing.reduce_trace` reads, and
changes none of its numbers:

- each device operation (kernel, copy, set) is put down to the innermost
  `md.` span around its launch on the launching thread; failing that, on
  autograd's thread, to the span around the forward op whose node the
  backward was running (the profiler's sequence number and forward thread of
  the enclosing `autograd::engine::evaluate_function` op), as
  `<span>.bwd`; failing both, to `host:main thread` / `host:other thread`
  (no program span: `unnamed`);
- idle gaps go to the label of the operation that ended them (as
  `reduce_trace` labels them by its `pb.` spans);
- launches a step: the device operations launched, from any thread, inside
  an `md.ddim.step` or `md.train.step` interval, over the number of steps;
- per span kind: host time, and the device time and launches of the
  operations launched, from any thread, inside its intervals;
- attention: each `md.attn` call's least time from its shapes
  (`attention_module_bound_s`, forward and remat's recompute alike) and each
  `md.attn.bwd` call's (`training_bound_ms` for dQ plus dK/dV of each key
  source, `grouped_bound_ms("bwd")` for the grouped kernel), against the
  device time of the operations launched inside each call.

`port_bench/trace_spans.py` prints these for a cell. The benchmark's result
line does not carry them: `run.py` and `tracing.py` do not call this module.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from port_bench.harness.tracing import busy_union_ns
from port_bench.harness.yardstick import (
    attention_module_bound_s,
    grouped_bound_ms,
    training_bound_ms,
)

STEP_SPANS = ("md.ddim.step", "md.train.step")
ROOT_SPANS = ("md.request", "md.train.step")
EVALUATE = "autograd::engine::evaluate_function"


def kind(name: str) -> str:
    """A span's kind: its name without the " key=value" fields."""
    return name.split(" ", 1)[0]


def fields(name: str) -> dict:
    return dict(kv.split("=", 1) for kv in name.split(" ")[1:])


def _ints(value: str) -> list:
    return [int(v) for v in value.split("x")]


def attention_bound_s(name: str) -> float:
    """The least time of one `md.attn` or `md.attn.bwd` call from the shapes
    its span carries (the frozen yardstick)."""
    f = fields(name)
    if kind(name) == "md.attn":
        b, sq, cq = _ints(f["q"])
        bk, sk, ck = _ints(f["kv"])
        bb, sb, _ = _ints(f["bank"])
        return attention_module_bound_s(b, sq, cq, int(f["inner"]), sk, ck, f["cross"] == "1",
                                        bank_rows=sb, bank_batch=bb)
    if "grouped" in f:
        n, s, c = _ints(f["grouped"])
        return grouped_bound_ms("bwd", n, s, c)[0] / 1e3
    b, sq, h, d = _ints(f["q"])
    sources = [tuple(_ints(f["kv"]))]
    if _ints(f["bank"])[1]:
        sources.append(tuple(_ints(f["bank"])))
    ms = training_bound_ms("dq", b, sq, h, d, sources)[0]
    ms += sum(training_bound_ms("dkv", b, sq, h, d, [src])[0] for src in sources)
    return ms / 1e3


class Nested:
    """Properly nested host ranges per thread, (start, end, thread, payload):
    the innermost one around a time, by the last range started no later and
    its chain of enclosing ranges."""

    def __init__(self, ranges):
        self.by_thread: dict = {}
        for r in sorted(ranges, key=lambda r: (r[0], -r[1])):
            self.by_thread.setdefault(r[2], []).append(r)
        self.starts, self.parents = {}, {}
        for tid, rs in self.by_thread.items():
            self.starts[tid] = [r[0] for r in rs]
            parents, stack = [], []
            for i, r in enumerate(rs):
                while stack and rs[stack[-1]][1] < r[0]:
                    stack.pop()
                parents.append(stack[-1] if stack else -1)
                stack.append(i)
            self.parents[tid] = parents

    def chain(self, tid, t):
        """The ranges around time t on thread tid, innermost first."""
        rs = self.by_thread.get(tid)
        if not rs:
            return
        i = bisect.bisect_right(self.starts[tid], t) - 1
        while i >= 0:
            if rs[i][1] >= t:
                yield rs[i]
            i = self.parents[tid][i]

    def at(self, tid, t):
        return next(self.chain(tid, t), None)


class Intervals:
    """The union of some host ranges of any thread, for membership tests."""

    def __init__(self, ranges):
        _, merged = busy_union_ns([(r[0], r[1]) for r in ranges])
        self.starts = [m[0] for m in merged]
        self.merged = merged

    def __contains__(self, t) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and self.merged[i][1] >= t


@dataclass
class ProgramSpans:
    idle_s: float = 0.0
    unnamed_idle_s: float = 0.0     # idle ended by an operation with no program name
    idle_gaps: list = field(default_factory=list)   # [[label, seconds]], most first
    steps: int = 0                  # md.ddim.step or md.train.step spans
    step_launches: int = 0          # operations launched inside them, any thread
    per_kind: dict = field(default_factory=dict)    # kind -> {spans, host_s, device_s, launches}
    threads: dict = field(default_factory=dict)     # kind -> spans off the root spans' thread
    attn_bound_s: float = 0.0
    attn_device_s: float = 0.0
    attn_calls: int = 0
    linked_ops: int = 0             # operations named through a .bwd link

    @property
    def launches_per_step(self):
        return self.step_launches / self.steps if self.steps else None

    @property
    def attention_roofline(self):
        return 100.0 * self.attn_bound_s / self.attn_device_s if self.attn_device_s else None


def _annotation(e) -> bool:
    """A device-side range of a host span, never busy time."""
    flag = getattr(e, "is_user_annotation", None)
    return (callable(flag) and bool(flag())) or e.name().startswith(("pb.", "md."))


def reduce(events) -> ProgramSpans:
    """The program's spans of a segment from its raw profiler events."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if not _annotation(e):
                start = e.start_ns()
                device.append((start, start + e.duration_ns(), e.correlation_id()))
        else:
            host.append(e)
    wanted = {d[2] for d in device}
    launches, spans, evaluations, creators = {}, [], [], {}
    for e in host:
        name = e.name()
        start, tid = e.start_ns(), e.start_thread_id()
        if name.startswith("md."):
            spans.append((start, start + e.duration_ns(), tid, name))
        elif name.startswith("cu") and e.correlation_id() in wanted:
            launches[e.correlation_id()] = (tid, start)
        elif e.sequence_nr() >= 0:
            fwd = getattr(e, "fwd_thread_id", lambda: 0)()
            if name.startswith(EVALUATE) and fwd:
                evaluations.append((start, start + e.duration_ns(), tid, (fwd, e.sequence_nr())))
            elif not fwd:
                key = (tid, e.sequence_nr())   # the latest op to start with the number
                creators[key] = max(start, creators.get(key, start))
    out = ProgramSpans()
    if not device:
        return out
    md, nodes = Nested(spans), Nested(evaluations)
    roots = [s for s in spans if kind(s[3]) in ROOT_SPANS]
    main = roots[0][2] if roots else None

    def label(tid, t):
        """(label, named by a .bwd link) of an operation launched at t on tid."""
        span = md.at(tid, t)
        if span is not None:
            return kind(span[3]), False
        node = nodes.at(tid, t)
        if node is not None:
            fwd_tid, seq = node[3]
            start = creators.get((fwd_tid, seq))
            span = None if start is None else md.at(fwd_tid, start)
            if span is not None:
                return kind(span[3]) + ".bwd", True
        return None, False

    ops = []
    for a, b, corr in sorted(device):
        where = launches.get(corr)
        ops.append((a, b, where) + (label(*where) if where else (None, False)))
    busy, merged = busy_union_ns([(a, b) for a, b, *_ in ops])
    first_at = {}
    for op in ops:
        first_at.setdefault(op[0], op)
    gaps = {}
    for (_, a1), (b0, _) in zip(merged, merged[1:]):
        _, _, where, name, _ = first_at[b0]
        if name is None:
            out.unnamed_idle_s += (b0 - a1) / 1e9
            name = ("host:unattributed" if where is None else
                    "host:" + ("main thread" if where[0] == main else "other thread"))
        gaps[name] = gaps.get(name, 0) + (b0 - a1)
    out.idle_s = (merged[-1][1] - merged[0][0] - busy) / 1e9
    out.idle_gaps = [[k, v / 1e9] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])]
    out.linked_ops = sum(1 for op in ops if op[4])

    launched = [(where[1], b - a) for a, b, where, *_ in ops if where]
    for k in sorted({kind(s[3]) for s in spans}):
        of_kind = [s for s in spans if kind(s[3]) == k]
        inside = Intervals(of_kind)
        hit = [d for t, d in launched if t in inside]
        out.per_kind[k] = {"spans": len(of_kind),
                           "host_s": sum(s[1] - s[0] for s in of_kind) / 1e9,
                           "device_s": sum(hit) / 1e9, "launches": len(hit)}
        away = sum(1 for s in of_kind if s[2] != main)
        if away:
            out.threads[k] = away
    steps = [s for s in spans if kind(s[3]) in STEP_SPANS]
    if steps:
        inside = Intervals(steps)
        out.steps = len(steps)
        out.step_launches = sum(1 for t, _ in launched if t in inside)

    attn: dict = {}
    for a, b, where, *_ in ops:
        if where is None:
            continue
        for span in md.chain(*where):
            if kind(span[3]) in ("md.attn", "md.attn.bwd"):
                attn[span] = attn.get(span, 0) + (b - a)
                break
    out.attn_calls = len(attn)
    out.attn_bound_s = sum(attention_bound_s(s[3]) for s in attn)
    out.attn_device_s = sum(attn.values()) / 1e9
    return out
