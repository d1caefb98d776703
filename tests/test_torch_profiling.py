"""The port's profiling utilities (`utils.profiling`) on the CPU, as
tests/test_misc_features.py:57 checks the JAX package's: the memory stats
(empty without a GPU) and a torch.profiler trace with a named region,
written as a Chrome trace; and the program's own spans (`span`): off without
a profiler, nested as the module docstring says in a tiny request and a tiny
training step, its backward tied to them by autograd's sequence numbers.
The kernel libraries' build record (`ops.kernels.build.BUILDS`) with a
stand-in compiler."""

import json
import os
import stat
import sys

import torch
from torch.profiler import ProfilerActivity, profile

from magicdance_tpu_torch.config import SampleConfig
from magicdance_tpu_torch.ops.kernels import build
from magicdance_tpu_torch.ops.kernels.flash_vjp import mha, mha_grouped, mha_two_source
from magicdance_tpu_torch.pipeline import MagicPosePipeline
from magicdance_tpu_torch.train.trainer import Trainer
from magicdance_tpu_torch.utils import profiling as P
from torch_port_util import (  # noqa: F401  (torch_single_thread: autouse fixture)
    jax_train_cfg,
    make_train_batch,
    port_batch,
    port_cfg,
    port_train_cfg,
    tiny_model_cfg_jax,
    torch_single_thread,
)


def test_step_timer_and_memory_stats():
    stats = P.device_memory_stats()
    assert isinstance(stats, dict)
    assert P.device_memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        assert stats == {}


def test_trace_writes_chrome_trace_with_regions(tmp_path):
    """The trace file holds the named region and the host operators; the
    device rankings are empty without a GPU."""
    a = torch.randn(64, 64)
    with P.trace(str(tmp_path), name="step") as prof:
        with P.span("matmul_region"):
            for _ in range(3):
                a = a @ a / 8
    with open(os.path.join(tmp_path, "step.json")) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert "matmul_region" in names and names.count("aten::mm") == 3
    assert {e.key: e.count for e in prof.key_averages()}["aten::mm"] == 3
    if not torch.cuda.is_available():
        assert P.top_ops(prof) == [] and P.device_busy_ms(prof) == (0.0, 0.0)


def test_span_is_off_without_a_profiler(monkeypatch):
    """No profiler: one shared null context, no record_function entered and
    the name's detail never computed."""
    def refuse(*a, **kw):
        raise AssertionError("entered record_function with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first = P.span("md.attn", refuse, 1)
    assert first is P.span("md.request")
    with first:
        pass


class Host:
    """A finished CPU profile's host events (the raw Kineto ones: building
    the profiler's event tree costs seconds at these sizes), with the
    program's `md.` spans nested by their intervals on their thread."""

    def __init__(self, prof):
        self.events = sorted(
            ((e.start_ns(), -(e.start_ns() + e.duration_ns()), e.name(), e.start_thread_id(),
              e.sequence_nr(), e.fwd_thread_id())
             for e in prof.profiler.kineto_results.events()), key=lambda e: e[:2])
        self.md = [e for e in self.events if e[2].startswith("md.")]

    def parent(self, e):
        """The innermost md. span around e (one started no later, ending no
        earlier, on e's thread), or None."""
        around = [s for s in self.md if s is not e and s[3] == e[3]
                  and s[0] <= e[0] and -s[1] >= -e[1]]
        return around[-1] if around else None

    def under(self, span):
        return [e for e in self.md if self.parent(e) is span]


def _name(e):
    return e[2]


def _kind(e):
    return e[2].split(" ")[0]


def _fields(e):
    return dict(kv.split("=") for kv in e[2].split(" ")[1:])


def test_request_spans_nest():
    """md.request > md.clip, md.vae.encode, md.ddim.step x2, md.vae.decode;
    each step > its four passes; each pass > md.attn with its shapes."""
    pipe = MagicPosePipeline(port_cfg(tiny_model_cfg_jax()), device="cpu")
    pipe.init_params(seed=0, scale=0.1)
    gen = torch.Generator().manual_seed(0)
    pose = torch.rand(2, 64, 64, 3, generator=gen)
    ref = torch.rand(1, 64, 64, 3, generator=gen) * 2 - 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.sample_frames(pose, ref, SampleConfig(steps=2))
    host = Host(prof)
    (request,) = host.under(None)
    assert _name(request) == "md.request i=0"
    parts = host.under(request)
    assert [_name(e) for e in parts] == [
        "md.clip", "md.clip", "md.vae.encode", "md.ddim.step i=0", "md.ddim.step i=1",
        "md.vae.decode"]
    for step in parts[3:5]:
        passes = host.under(step)
        assert [_name(e) for e in passes] == ["md.pass.bank_write", "md.pass.controlnet",
                                              "md.pass.unet_cond", "md.pass.unet_uncond"]
        for p in passes:
            assert {_kind(e) for e in host.under(p)} == {"md.attn"}
    cond = [_fields(e) for e in host.under(host.under(parts[3])[2])]
    # the first block of the cond pass: self-attention over the 8x8 latent
    # reading the batch-1 bank, then cross-attention over the 77-token prompt
    assert cond[0] == {"q": "2x64x32", "kv": "2x64x32", "cross": "0", "bank": "1x64x32",
                       "inner": "32", "heads": "2"}
    assert cond[1] == {"q": "2x64x32", "kv": "2x77x16", "cross": "1", "bank": "0x0x0",
                       "inner": "32", "heads": "2"}


def test_train_step_spans_and_backward_links():
    """md.train.step > encode, forward, backward, optimizer; remat's blocks
    show in the forward and again in the backward's recompute, with their
    attention calls; the backward's nodes name a forward op (the same
    sequence number) that lies under md.attn, md.remat or a pass."""
    tr = Trainer(port_train_cfg(jax_train_cfg()), device="cpu")
    tr.init_random(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train_step(port_batch(make_train_batch()))
    host = Host(prof)
    (step,) = host.under(None)
    assert _name(step) == "md.train.step i=0"
    phases = host.under(step)
    assert [_name(e) for e in phases] == ["md.train.encode", "md.train.forward",
                                          "md.train.backward", "md.train.optimizer"]
    fwd, bwd = phases[1], phases[2]

    def within(e, span):
        return span[0] <= e[0] <= -span[1]

    for phase in (fwd, bwd):
        inside = [e for e in host.md if within(e, phase)]
        assert {_name(e) for e in inside if _kind(e) == "md.remat"} == {
            "md.remat block=ResBlock", "md.remat block=SpatialTransformer"}
        assert any(_kind(e) == "md.attn" and _kind(host.parent(e)) == "md.remat"
                   for e in inside)
    creators = {}   # sequence number -> the latest forward op to start with it
    for e in host.events:
        if e[4] >= 0 and e[5] == 0 and within(e, fwd):
            creators[e[4]] = e
    linked = set()
    for e in host.events:
        if e[2].startswith("autograd::engine::evaluate_function") and within(e, bwd):
            span = host.parent(creators[e[4]]) if e[4] in creators else None
            if span is not None:
                linked.add(_kind(span))
    assert {"md.attn", "md.remat", "md.pass.unet_cond"} <= linked, linked


def test_attention_backward_spans():
    """The attention Functions' backward runs inside md.attn.bwd with its
    shapes: q, the self keys' and the bank's (batch x rows); the grouped
    one its packed q and heads."""
    gen = torch.Generator().manual_seed(0)

    def leaf(*shape):
        return torch.randn(*shape, generator=gen).requires_grad_()

    q, k, v = leaf(2, 16, 2, 8), leaf(2, 16, 2, 8), leaf(2, 16, 2, 8)
    kb, vb = leaf(1, 24, 2, 8), leaf(1, 24, 2, 8)
    gq, gk, gv = leaf(8, 16, 16), leaf(8, 16, 16), leaf(8, 16, 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mha(q, k, v).sum().backward()
        mha_two_source(q, k, v, kb, vb).sum().backward()
        mha_grouped(gq, gk, gv, None, 2).sum().backward()
    assert [e.name for e in prof.events() if e.name.startswith("md.")] == [
        "md.attn.bwd q=2x16x2x8 kv=2x16 bank=0x0",
        "md.attn.bwd q=2x16x2x8 kv=2x16 bank=1x24",
        "md.attn.bwd grouped=8x16x16 heads=2"]
    assert all(t.grad is not None for t in (q, k, v, kb, vb, gq, gk, gv))


def test_builds_records_each_compile(tmp_path, monkeypatch):
    """A build through a stand-in compiler counts one build of the library,
    with its seconds; an up-to-date library is not built again."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').close()\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "libs")
    monkeypatch.setattr(build, "BUILDS", {})
    build.build(("self_attention",))
    build.build(("self_attention",))
    entry = build.BUILDS["self_attention"]
    assert entry["builds"] == 1 and entry["build_s"] > 0 and entry["loaded"] is False
    assert list(build.BUILDS) == ["self_attention"]
