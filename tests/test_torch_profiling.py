"""The port's profiling utilities (`utils.profiling`) on the CPU, as
tests/test_misc_features.py:57 checks the JAX package's: the step timer,
the memory stats (empty without a GPU), and a torch.profiler trace with a
named region, written as a Chrome trace."""

import json
import os

import torch

from magicdance_tpu_torch.utils import profiling as P
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)


def test_step_timer_and_memory_stats():
    t = P.StepTimer()
    assert t.steps_per_sec is None
    t.tick()
    t.tick()
    assert t.steps_per_sec is not None and t.steps_per_sec > 0
    stats = P.device_memory_stats()
    assert isinstance(stats, dict)
    assert P.device_memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        assert stats == {} and P.log_peak_memory("test") == {}


def test_trace_writes_chrome_trace_with_regions(tmp_path):
    """The trace file holds the named region and the host operators; the
    device rankings are empty without a GPU."""
    a = torch.randn(64, 64)
    with P.trace(str(tmp_path), name="step") as prof:
        with P.annotate("matmul_region"):
            for _ in range(3):
                a = a @ a / 8
    with open(os.path.join(tmp_path, "step.json")) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert "matmul_region" in names and names.count("aten::mm") == 3
    assert {e.key: e.count for e in prof.key_averages()}["aten::mm"] == 3
    if not torch.cuda.is_available():
        assert P.top_ops(prof) == [] and P.device_busy_ms(prof) == (0.0, 0.0)
