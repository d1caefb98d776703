"""The body-timing script of kernels A, B, C and D
(`scripts/bench_attention_hopper.py`): its grids cover every head width of
the model over query lengths up to the width's image length and key counts
that include the text encoder's 77 (the backward's also the temporal 16, at
a stage-2 and a stage-3 step's rows), keep K and V under its memory cap, and
the script refuses to time without a GPU."""

import pytest
import torch

from magicdance_tpu_torch.scripts import bench_attention_hopper as B


def test_grid_covers_every_width_within_the_memory_cap():
    shapes = list(B.grid())
    assert {d for d, *_ in shapes} == {40, 80, 160}
    for d, s in B.SITES:
        mine = [(sq, sk, b) for dd, sq, sk, b in shapes if dd == d]
        assert {sq for sq, _, _ in mine} == {x for x in B.QUERY_LENGTHS if x <= s}
        assert 77 in {sk for _, sk, _ in mine} and s in {sk for _, sk, _ in mine}
        for sq, sk, b in mine:
            assert b * sk * B.HEADS * d * 2 <= B.KV_BYTES or b == 1
            assert b == 16 * s // sq or b * sk * B.HEADS * d * 2 * 2 > B.KV_BYTES


def test_backward_grid_covers_every_width_at_both_frame_counts():
    shapes = list(B.bwd_grid())
    assert {d for d, *_ in shapes} == {40, 80, 160}
    assert len(shapes) == len({(d, sq, sk, b) for d, sq, sk, b, _ in shapes})
    for d, s in B.SITES:
        mine = [(sq, sk, b, f) for dd, sq, sk, b, f in shapes if dd == d]
        assert {sq for sq, *_ in mine} == {x for x in B.BWD_QUERY_LENGTHS if x <= s}
        assert {16, 77, s} <= {sk for _, sk, _, _ in mine}
        for sq, sk, b, frames in mine:
            assert frames in B.BWD_FRAMES
            assert b * sk * B.HEADS * d * 2 <= B.KV_BYTES or b == 1
            assert b == frames * s // sq or b * sk * B.HEADS * d * 2 * 2 > B.KV_BYTES
        full = [(sq, sk) for sq, sk, b, f in mine if b == f * s // sq]
        for frames in B.BWD_FRAMES:  # both step sizes where the cap allows
            assert any(f == frames for sq, sk, b, f in mine if (sq, sk) in full)


def test_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        B.main([])


def test_backward_sweep_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        B.main(["--kernels", "CD"])
