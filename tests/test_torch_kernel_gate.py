"""The port's kernel gate (`ops.kernel_gate.run_gate`) on the CPU: its cases
go through the same dispatch as on the card (the wrappers and autograd
Functions take their plain versions here) and are held against the gate's
own fp32 reference. Small shapes of every case kind, S = 256 so the
attention reaches the kernel sites; a deliberately wrong kernel output makes
the gate raise, naming the case. The production cases need the card
(tests/test_torch_kernels_cuda.py)."""

import pytest
import torch

from magicdance_tpu_torch.ops import attention as A
from magicdance_tpu_torch.ops import kernel_gate as G
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

SMALL = [G.Case("bsnh", "bsnh", (2, 256, 2, 8), grads=True),
         G.Case("bsnh32", "bsnh", (1, 256, 2, 16), grads=True, dtype="float32"),
         G.Case("packed", "packed", (2, 256, 2, 8)),
         G.Case("two_source", "two_source", (2, 256, 2, 8), bank=256, grads=True),
         G.Case("two_source32", "two_source", (2, 256, 2, 8), bank=256, grads=True,
                dtype="float32"),
         G.Case("two_source_packed", "two_source_packed", (2, 256, 2, 8), bank=256),
         G.Case("gated", "gated", (2, 256, 2, 8), bank=256),
         G.Case("grouped", "grouped", (8, 16, 2, 8), grads=True),
         G.Case("grouped32", "grouped", (8, 16, 2, 8), grads=True, dtype="float32"),
         G.Case("groupnorm", "groupnorm", (2, 256, 64, 32)),
         G.Case("groupnorm32", "groupnorm", (2, 256, 64, 32), dtype="float32")]


def test_gate_passes_on_cpu(capsys):
    assert G.run_gate(device="cpu", cases=SMALL, verbose=True) == "ok"
    out = capsys.readouterr().out
    for name in ("bsnh_dq", "two_source_dkb", "gated_plain", "grouped32_dv", "groupnorm_fwd"):
        assert name in out


def test_gate_covers_every_jax_case_and_the_main_path():
    """GATE_CASES: the JAX gate's cases (kernel_gate.py:52-160), the main
    path's shapes at H = 8 (D = 40 included) and K8."""
    names = {c.label for c in G.GATE_CASES}
    assert {"bsnh", "packed", "two_source", "two_source_packed", "two_source_gated",
            "grouped"} <= names
    shapes = {(c.kind, c.shape[1:]) for c in G.GATE_CASES}
    for s, d in ((4096, 40), (1024, 80), (256, 160)):
        assert ("bsnh", (s, 8, d)) in shapes and ("two_source", (s, 8, d)) in shapes
    assert ("grouped", (16, 8, 40)) in shapes
    assert any(c.kind == "groupnorm" and c.shape[:3] == (2, 4096, 320) for c in G.GATE_CASES)
    assert all(c.grads for c in G.GATE_CASES if c.kind in ("bsnh", "two_source", "grouped"))


@pytest.mark.parametrize("case", ["bsnh_fwd", "gated_read"])
def test_gate_raises_on_a_wrong_kernel(monkeypatch, case):
    """A kernel wrapper whose output is off by 1e-2 fails the gate, which
    names the worst case and its deviation."""
    name, real = {"bsnh_fwd": ("self_attention", A.self_attention),
                  "gated_read": ("two_source_attention", A.two_source_attention)}[case]

    def wrong(*a, **kw):
        return real(*a, **kw) + 1e-2
    monkeypatch.setattr(A, name, wrong)
    cases = [c for c in SMALL if c.label == case.split("_")[0]]
    with pytest.raises(AssertionError, match=rf"\[{case}\]: max\|diff\|=1\.\d+e-02"):
        G.run_gate(device="cpu", cases=cases)


def test_gate_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        G.run_gate(cases=SMALL[:1])
