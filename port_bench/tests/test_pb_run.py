"""A whole run on the CPU at a tiny size (everything but the look for a
card), the refusal without a card, and runs whose timed path is broken
underneath, each of which must come out not correct."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from port_bench import run
from port_bench.harness import spec
from port_bench.tests.tiny import tiny_cell

SEED = 2**31 + 1234


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload",
                           "sd15-pose.serve-f16", "--seed", "1", "--seconds", "1"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "needs 1 CUDA card" in proc.stderr


def complete(out):
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert "setup_s" in out["metrics"]
    assert list(out)[-1] == "check"
    json.dumps(out)


def test_tiny_serving_run_is_correct_and_complete():
    out = run.measure(tiny_cell("sd15-pose.serve-f16"), SEED, 0.2, trace=False, device="cpu")
    assert out["correct"], out["check"]
    complete(out)


def test_tiny_training_run_is_complete():
    """The tiny model's gradients are near-cancelling sums (every leaf,
    norms included, drawn from N(0, 0.02^2) over two levels), so a leaf's
    gradient norm at this size is rounding noise between two fp32 summation
    orders; the loss and the change are held here, the gradients at the
    cell's size on the card."""
    out = run.measure(tiny_cell("sd15-pose.train-stage2-b8"), SEED, 0.2, trace=False,
                      device="cpu")
    complete(out)
    for name in ("loss_gap", "change_gap"):
        assert out["check"][name]["value"] <= out["check"][name]["limit"], out["check"]


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "magicdance_tpu_torch_x", sys)
    assert "magicdance_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.forbidden_modules()


def test_an_altered_answer_is_caught(monkeypatch):
    from magicdance_tpu_torch.pipeline import MagicPosePipeline

    sample = MagicPosePipeline.sample_frames

    def altered(self, *a, **kw):
        out = sample(self, *a, **kw).clone()
        out[-1] = out[-1] * 0.9   # the last frame of every request, where it is produced
        return out

    monkeypatch.setattr(MagicPosePipeline, "sample_frames", altered)
    out = run.measure(tiny_cell("sd15-pose.serve-f16"), SEED, 0.2, trace=False, device="cpu")
    assert not out["correct"], out["check"]


TRAINING = ["sd15-pose.train-stage2-b8", "sd15-pose-mm.train-stage3"]


@pytest.mark.parametrize("cell", TRAINING)
def test_a_step_that_keeps_its_state_is_caught(monkeypatch, cell):
    from magicdance_tpu_torch.train import trainer

    monkeypatch.setattr(trainer.Optimizer, "update", lambda self, params, grads: True)
    out = run.measure(tiny_cell(cell, frames=4), SEED, 0.2, trace=False, device="cpu")
    assert not out["correct"]
    assert out["check"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAINING)
def test_half_a_batch_is_caught(monkeypatch, cell):
    """Half the clips (stage 2: images) left out, or of stage 3's one clip
    the second half of its frames, the mean taken over the rest."""
    from magicdance_tpu_torch.train import trainer

    loss_and_grads = trainer.Trainer.loss_and_grads

    def half(self, batch, draws):
        f = self.num_frames
        clips = batch["image"].shape[0] // f
        if clips > 1:
            clips //= 2
        else:
            f = self.num_frames = f // 2
        n = clips * f
        batch = {k: v[:clips if k == "reference" else n] for k, v in batch.items()}
        draws = trainer.Draws(draws.t[:n], draws.noise[:n], draws.vae_image[:n],
                              draws.vae_reference[:clips])
        return loss_and_grads(self, batch, draws)

    monkeypatch.setattr(trainer.Trainer, "loss_and_grads", half)
    out = run.measure(tiny_cell(cell, frames=4), SEED, 0.2, trace=False, device="cpu")
    assert not out["correct"], out["check"]
