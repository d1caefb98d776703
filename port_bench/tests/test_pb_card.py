"""The controls at the cells' own sizes, on a CUDA card (each skips here
without one): the program within every limit of its cell, the reference
one precision lower beyond at least one. About three minutes a case."""

from __future__ import annotations

import pytest
import torch

from port_bench import control
from port_bench.harness.spec import load_cell


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return "cuda"


@pytest.mark.parametrize("cell", ["sd15-pose.serve-f16", "sd15-pose-mm.serve-video16"])
def test_serving_control_fails_where_the_program_passes(cuda, cell):
    c = load_cell(cell)
    r = control.serve_readings(c, 61, cuda)
    limits = c.traffic["limits"]
    assert all(v <= limits[k] for k, v in r["program"].items()), r
    assert any(v > limits[k] for k, v in r["control"].items()), r


@pytest.mark.parametrize("cell", ["sd15-pose.train-stage2-b8", "sd15-pose-mm.train-stage3"])
def test_training_control_and_half_batch_fail(cuda, cell):
    c = load_cell(cell)
    r = control.train_readings(c, 62, cuda, fault="half_batch")
    limits = c.traffic["limits"]
    assert all(v <= limits[k] for k, v in r["program"].items()), r
    for name in ("control", "half_batch"):
        assert any(v > limits[k] for k, v in r[name].items()), (name, r)
