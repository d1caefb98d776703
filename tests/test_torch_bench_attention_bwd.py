"""The backward-kernel timing script (`scripts/bench_attention_bwd.py`): its
cases cover every stage-2 and stage-3 call of kernels C and D, each with the
launch counter it moves on the card, and it refuses to time without a GPU.
On the CPU the wrappers take their plain versions, at tiny sizes here."""

import pytest
import torch

from magicdance_tpu_torch.ops import kernels as K
from magicdance_tpu_torch.scripts import bench_attention_bwd as B


def test_cases_cover_both_training_stages(monkeypatch):
    monkeypatch.setattr(B, "SITES", ((64, 8), (16, 16)))
    seen = []
    for label, counter, fn in B.cases(torch.device("cpu")):
        assert counter in K.LAUNCHES
        out = fn()
        for t in out if isinstance(out, tuple) else (out,):
            assert t.dtype == torch.bfloat16 and torch.isfinite(t.float()).all()
        seen.append((label.split(" stage")[0], label.split(")")[0].split("(")[1]))
    # per site: stage 2 C one source, C two sources, D; stage 3 C two sources, D
    assert len(seen) == 2 * 5
    assert seen[:5] == [("C one source", "2, 64, 8"), ("C two sources", "2, 64, 8"),
                        ("D self source", "2, 64, 8"), ("C one source", "2, 16, 16"),
                        ("C two sources", "2, 16, 16")]
    assert ("C two sources", "16, 64, 8") in seen and ("D self source", "16, 16, 16") in seen


def test_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        B.main([])
