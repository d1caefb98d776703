"""The frozen reference agrees with the program at a tiny size on the CPU,
and its precision control does not."""

from __future__ import annotations

import copy

import pytest
import torch

from port_bench.harness import check
from port_bench.harness.serve import ServeCell
from port_bench.harness.train import TrainCell
from port_bench.reference.model import Numerics
from port_bench.tests.tiny import tiny_cell

SEED = 2**31 + 77


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("cell", ["sd15-pose.serve-f16", "sd15-pose-mm.serve-video16"])
def test_served_request_matches_reference(cell):
    c = tiny_cell(cell, frames=3, steps=3)
    drv = ServeCell(c.config, c.traffic, SEED, "cpu")
    drv.setup()
    images = drv.request(0, c.traffic["steps"]).float()
    latents = drv._latents.float()
    ref_lat, ref_img, rows = drv.reference(0, Numerics(), latents)
    assert rows is None, "no check_frames: every frame is checked"
    gap = check.serve_numbers([(images, latents, ref_lat, ref_img, rows)])
    c_lat, _, _ = drv.reference(0, Numerics("fp8"))
    assert gap["latent_gap"] < 1e-4, "the fp32 program is the reference's arithmetic"
    assert gap["decode_gap"] < 1e-5
    assert check.frame_gap(c_lat, ref_lat) > 10 * gap["latent_gap"], "fp8 operands must show"


@pytest.mark.parametrize("cell", ["sd15-pose.train-stage2-b8", "sd15-pose-mm.train-stage3"])
def test_training_steps_match_reference(cell):
    c = tiny_cell(cell, frames=3)
    drv = TrainCell(c.config, c.traffic, SEED, "cpu")
    drv.setup()
    want = drv.reference(Numerics(remat=True))
    got = check.train_numbers(drv.readings, want)
    assert got["loss_gap"] < 1e-5
    control = check.train_numbers(drv.reference(Numerics("fp8", remat=True)), want)
    assert control["loss_gap"] > 10 * max(got["loss_gap"], 1e-7)


def test_reference_takes_the_bf16_weights_in_fp32():
    c = tiny_cell("sd15-pose.serve-f16")
    drv = ServeCell(c.config, c.traffic, SEED, "cpu")
    from port_bench.harness import weights as W

    nets = W.reference_on(drv.config, SEED, "cpu")
    w = nets["model"].unet.conv_in.weight
    assert w.dtype == torch.float32
    assert torch.equal(w, w.bfloat16().float())
    cfg = copy.deepcopy(drv.config)
    assert W.reference_networks(cfg)["model"].unet.conv_in.weight.is_meta
