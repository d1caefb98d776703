"""The body-timing script of kernels A and B
(`scripts/bench_attention_hopper.py`): its grid covers every head width of
the model over query lengths up to the width's image length and key counts
that include the text encoder's 77, keeps K and V under its memory cap, and
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


def test_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        B.main([])
