"""The FLOP count, the bounds and the trace arithmetic against hand counts
at tiny sizes."""

from __future__ import annotations

import pytest
import torch

from port_bench.harness import tracing, yardstick
from port_bench.harness.weights import materialize, seeded_state
from port_bench.reference.model import Attention, Numerics, ResBlock


def test_attention_flops_match_a_hand_count():
    b, s, c, heads, ctx, sk = 2, 16, 32, 4, 24, 7
    att = Attention(Numerics(), c, ctx, heads, c // heads)
    x = torch.empty(b, s, c, device="meta")
    context = torch.empty(1, sk, ctx, device="meta")
    got = yardstick.count_flops(att, x, context)
    hand = (2 * b * s * c * c            # q
            + 2 * 2 * 1 * sk * ctx * c   # k, v of the one shared context
            + 2 * 2 * b * s * sk * c     # QK^T and PV
            + 2 * b * s * c * c)         # output
    assert got == hand


def test_resblock_flops_match_a_hand_count():
    b, cin, cout, hw, emb = 2, 32, 64, 8, 16
    blk = ResBlock(Numerics(), cin, cout, emb)
    got = yardstick.count_flops(blk, torch.empty(b, cin, hw, hw, device="meta"),
                                torch.empty(b, emb, device="meta"))
    conv = lambda ci, co, k: 2 * b * hw * hw * ci * co * k * k  # noqa: E731
    hand = conv(cin, cout, 3) + conv(cout, cout, 3) + conv(cin, cout, 1) + 2 * b * emb * cout
    assert got == hand


def test_attention_module_bound_by_hand():
    # one self-attention call at 4096 tokens, 320 channels, with a batch-1 bank
    b, s, c = 16, 4096, 320
    t = yardstick.attention_module_bound_s(b, s, c, c, s, c, False, bank_rows=s, bank_batch=1)
    flops = 2 * b * s * c * c + 4 * b * s * c * c + 4 * s * c * c + 4 * b * s * 2 * s * c \
        + 2 * b * s * c * c
    assert t == pytest.approx(flops / 989e12)
    # tiny: the memory bound wins
    t = yardstick.attention_module_bound_s(1, 4, 8, 8, 4, 8, False)
    nbytes = 2 * (2 * 4 * 8 + 8 * (2 * 8 + 2 * 8) + 8)
    assert t == pytest.approx(nbytes / 3.35e12)


def test_copied_bounds_agree_with_their_formulas():
    ms, kind = yardstick.attention_bound_ms(2, 4096, 8, 40, [(2, 4096)])
    assert kind == "operations"
    assert ms == pytest.approx(4 * 2 * 8 * 4096 * 4096 * 40 / 989e12 * 1e3)
    ms, kind = yardstick.grouped_bound_ms("fwd", 4096, 16, 320)
    assert kind == "bytes"
    assert ms == pytest.approx(2 * 4 * 4096 * 16 * 320 / 3.35e12 * 1e3)


def test_busy_union():
    busy, merged = tracing.busy_union_ns([(0, 10), (5, 12), (20, 30), (25, 26)])
    assert busy == 22 and merged == [[0, 12], [20, 30]]


class _Ev:
    def __init__(self, kind, name, start, end, tid=1, corr=0, linked=0):
        self.k, self.n, self.s, self.e, self.tid, self.c, self.lc = (
            kind, name, start, end, tid, corr, linked)

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self.k == "kernel" else DeviceType.CPU

    def is_user_annotation(self):
        return self.k == "user_annotation"

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.e - self.s

    def start_thread_id(self):
        return self.tid

    def correlation_id(self):
        return self.c

    def linked_correlation_id(self):
        return self.lc


def test_reduce_trace_attributes_kernels_and_gaps():
    ev = [
        _Ev("user_annotation", "pb.segment", 0, 1000),
        _Ev("user_annotation", "pb.unet.cond", 0, 400),
        _Ev("user_annotation", "pb.attn#0", 100, 200),
        _Ev("cuda_runtime", "cudaLaunchKernel", 110, 115, corr=7),
        _Ev("cuda_runtime", "cudaLaunchKernel", 300, 305, corr=8),
        _Ev("cuda_runtime", "cudaLaunchKernel", 600, 605, corr=9),
        _Ev("cpu_op", "aten::mm", 290, 310, corr=3),   # op ids share numbers with launches
        _Ev("cuda_runtime", "cudaStreamIsCapturing", 291, 292, corr=3),
        _Ev("kernel", "attn_kernel", 120, 170, corr=7),          # the port's: no op around it
        _Ev("kernel", "conv", 310, 330, corr=8, linked=3),       # linked: the op
        _Ev("kernel", "update", 700, 720, corr=9, linked=3),
    ]
    seg = tracing.reduce_trace(ev, bounds=[20e-9])
    assert seg.busy_s == pytest.approx(90e-9) and seg.span_s == pytest.approx(600e-9)
    assert seg.attn_calls == 1 and seg.attn_device_s == pytest.approx(50e-9)
    assert seg.attn_bound_s == pytest.approx(20e-9)
    assert seg.device_ops[0] == ["attn_kernel", pytest.approx(50e-9)]
    gaps = dict(seg.idle_gaps)
    assert gaps["pb.unet.cond"] == pytest.approx(140e-9)     # 170 -> 310, launched in cond
    assert gaps["host:main thread"] == pytest.approx(370e-9)  # 330 -> 700, outside any pass


def test_seeded_weights_repeat_and_differ_by_seed():
    shapes = [(k, p.shape) for k, p in ResBlock(Numerics(), 32, 32, 16).named_parameters()]
    a = seeded_state(shapes, 5, 0, "cpu")
    b = seeded_state(shapes, 5, 0, "cpu")
    c = seeded_state(shapes, 2**31 + 5, 0, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv_in.weight"], c["conv_in.weight"])
    assert all(v.dtype == torch.bfloat16 for v in a.values())
    net = materialize(ResBlock(Numerics(), 32, 32, 16), a, "cpu")
    assert net.conv_in.weight.dtype == torch.float32
    assert float(net.conv_in.weight.detach().std()) == pytest.approx(0.02, rel=0.1)


def test_layout_cache_matches_the_reference(tmp_path):
    from port_bench.harness import weights as W
    from port_bench.tests.tiny import tiny_cell

    cfg = tiny_cell("sd15-pose-mm.serve-video16").config
    fresh = W.layout(cfg)
    assert W.layout(cfg, tmp_path) == fresh
    assert len(list(tmp_path.rglob("*.json"))) == 1
    assert W.layout(cfg, tmp_path) == fresh   # read back
    nets = W.reference_networks(cfg)
    assert fresh["model"] == [(k, tuple(p.shape)) for k, p in nets["model"].named_parameters()]
