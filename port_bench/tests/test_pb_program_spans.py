"""The reading of the program's `md.` spans (`harness.program_spans`) on a
synthetic trace: a training step whose backward runs on autograd's thread.
The segment reducer's own numbers (`tracing.reduce_trace`) do not move when
the program's spans and their device-side ranges are added."""

from __future__ import annotations

import pytest
from torch.autograd import DeviceType

from port_bench.harness import program_spans as ps
from port_bench.harness.tracing import reduce_trace
from port_bench.harness.yardstick import attention_module_bound_s

MAIN, AUTOGRAD = 1, 2
ATTN = "md.attn q=8x4096x320 kv=8x4096x320 cross=0 bank=8x4096x320 inner=320 heads=8"


class Ev:
    """The part of a Kineto event the reducers read."""

    def __init__(self, name, start, dur, tid=MAIN, corr=0, cuda=False, ann=False, seq=-1,
                 fwd=0):
        self._name, self._start, self._dur, self._tid = name, start, dur, tid
        self._corr, self._cuda, self._ann, self._seq, self._fwd = corr, cuda, ann, seq, fwd

    def name(self):
        return self._name

    def device_type(self):
        return DeviceType.CUDA if self._cuda else DeviceType.CPU

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def start_thread_id(self):
        return self._tid

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._ann

    def sequence_nr(self):
        return self._seq

    def fwd_thread_id(self):
        return self._fwd


def kernel(corr, start, dur):
    return Ev(f"kernel_{corr}", start, dur, corr=corr, cuda=True)


def launch(corr, t, tid=MAIN):
    return Ev("cudaLaunchKernel", t, 2, tid=tid, corr=corr)


BASE = [
    Ev("pb.segment", 0, 1000),
    Ev("pb.unet", 15, 335),
    Ev("aten::linear", 60, 10, seq=7),
    launch(1, 65), kernel(1, 100, 20),
    Ev(f"{ps.EVALUATE}: MmBackward0", 410, 90, tid=AUTOGRAD, seq=7, fwd=MAIN),
    launch(2, 420, AUTOGRAD), kernel(2, 200, 60),
    launch(3, 520, AUTOGRAD), kernel(3, 300, 10),
    launch(4, 700, AUTOGRAD), kernel(4, 400, 10),
]
PROGRAM = [
    Ev("md.train.step i=0", 10, 890),
    Ev("md.train.forward", 20, 280),
    Ev(ATTN, 50, 100),
    Ev("md.train.backward", 400, 400),
    Ev("md.remat block=ResBlock", 510, 90, tid=AUTOGRAD),
    # device-side ranges of the host spans
    Ev("md.train.step i=0", 100, 310, cuda=True, ann=True),
    Ev("md.attn", 100, 20, cuda=True, ann=True),
]


def test_reduce_trace_is_unchanged_by_program_spans():
    before, after = reduce_trace(BASE, []), reduce_trace(BASE + PROGRAM, [])
    assert after == before
    assert before.busy_s == pytest.approx(100e-9)
    assert dict(before.idle_gaps) == pytest.approx({"host:other thread": 210e-9})


def test_program_spans_label_launches_and_gaps():
    out = ps.reduce(BASE + PROGRAM)
    # 120 -> 200 ends at a kernel of the backward of a node created under
    # md.attn; 260 -> 300 at the recompute in md.remat; 310 -> 400 at a
    # launch under no span and no node
    assert dict(out.idle_gaps) == pytest.approx(
        {"md.attn.bwd": 80e-9, "md.remat": 40e-9, "host:other thread": 90e-9})
    assert out.idle_s == pytest.approx(210e-9)
    assert out.unnamed_idle_s == pytest.approx(90e-9)
    assert out.linked_ops == 1
    assert (out.steps, out.step_launches, out.launches_per_step) == (1, 4, 4.0)
    assert out.threads == {"md.remat": 1}
    assert out.per_kind["md.train.backward"] == pytest.approx(
        {"spans": 1, "host_s": 400e-9, "device_s": 80e-9, "launches": 3})
    assert out.attn_calls == 1 and out.attn_device_s == pytest.approx(20e-9)
    bound = attention_module_bound_s(8, 4096, 320, 320, 4096, 320, False, bank_rows=4096,
                                     bank_batch=8)
    assert out.attn_bound_s == pytest.approx(bound)
    assert out.attention_roofline == pytest.approx(100 * bound / 20e-9)


def test_device_ranges_of_spans_are_not_busy_without_the_flag():
    """Where events carry no user-annotation flag, the `md.` and `pb.`
    device ranges are known by name."""
    events = BASE + PROGRAM
    for e in events:
        e.is_user_annotation = None
    assert ps.reduce(events).idle_s == pytest.approx(210e-9)


def test_attention_bounds_from_span_names():
    from port_bench.harness.yardstick import grouped_bound_ms, training_bound_ms

    two = ps.attention_bound_s("md.attn.bwd q=8x4096x8x40 kv=8x4096 bank=1x4096")
    want = (training_bound_ms("dq", 8, 4096, 8, 40, [(8, 4096), (1, 4096)])[0]
            + training_bound_ms("dkv", 8, 4096, 8, 40, [(8, 4096)])[0]
            + training_bound_ms("dkv", 8, 4096, 8, 40, [(1, 4096)])[0]) / 1e3
    assert two == pytest.approx(want)
    one = ps.attention_bound_s("md.attn.bwd q=2x64x8x160 kv=2x77 bank=0x0")
    assert one == pytest.approx((training_bound_ms("dq", 2, 64, 8, 160, [(2, 77)])[0]
                                 + training_bound_ms("dkv", 2, 64, 8, 160, [(2, 77)])[0]) / 1e3)
    grouped = ps.attention_bound_s("md.attn.bwd grouped=65536x16x320 heads=8")
    assert grouped == pytest.approx(grouped_bound_ms("bwd", 65536, 16, 320)[0] / 1e3)
    cross = ps.attention_bound_s(
        "md.attn q=16x4096x320 kv=16x77x768 cross=1 bank=0x0x0 inner=320 heads=8")
    assert cross == pytest.approx(attention_module_bound_s(16, 4096, 320, 320, 77, 768, True,
                                                           bank_rows=0, bank_batch=0))
