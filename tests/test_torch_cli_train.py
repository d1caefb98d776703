"""The port's training CLI end to end on the CPU: the synthetic TikTok-v4
tree and tiny stage-2 config of tests/test_cli_train.py, 2 steps: a
checkpoint, a finite loss in metrics.jsonl, the sample grid, and no loader
thread left behind; then a resume to step 3. Plus the prefetch loader's
close() on its own."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from magicdance_tpu_torch.cli.train import main
from magicdance_tpu_torch.data.loader import PrefetchLoader
from test_cli_train import make_dataset, tiny_config_json
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)


def _args(tmp_path, out, steps):
    return ["--config", str(tmp_path / "cfg.json"), "--data", str(tmp_path),
            "--output", str(out), "--steps", str(steps), "--image_size", "32",
            "--device", "cpu"]


def test_cli_train_end_to_end_and_resume(tmp_path):
    make_dataset(tmp_path)
    tiny_config_json(tmp_path / "cfg.json", steps=2)
    out = tmp_path / "run"
    threads_before = threading.active_count()

    main(_args(tmp_path, out, 2))

    assert sorted(os.listdir(out / "checkpoints")) == ["step_00000002"]
    lines = [json.loads(line) for line in open(out / "tb" / "metrics.jsonl")]
    assert [rec["step"] for rec in lines] == [1, 2]
    assert all(np.isfinite(rec["loss"]) for rec in lines)
    assert os.listdir(out / "samples") == ["step_00000002.png"]
    deadline = time.time() + 5
    while threading.active_count() > threads_before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= threads_before, "loader threads left running"
    state = torch.load(out / "checkpoints" / "step_00000002" / "state.pt",
                       weights_only=False)
    assert state["step"] == 2

    main(_args(tmp_path, out, 3))  # resumes from step 2
    lines = [json.loads(line) for line in open(out / "tb" / "metrics.jsonl")]
    assert [rec["step"] for rec in lines] == [1, 2, 3]
    assert "step_00000003" in os.listdir(out / "checkpoints")


@pytest.mark.parametrize("flag", [["--init_checkpoint", "x.th"],
                                  ["--motion_module_checkpoint", "mm.ckpt"]])
def test_cli_train_refuses_other_slices(tmp_path, flag):
    with pytest.raises(NotImplementedError):
        main(["--data", str(tmp_path), "--output", str(tmp_path / "o"),
              "--device", "cpu", *flag])


def test_prefetch_loader_close_joins_threads():
    """close() terminates every worker and transfer thread, even with an
    infinite producer, and is safe to call twice."""
    def factory(worker):
        def gen():
            while True:
                yield {"x": np.zeros((2, 4), np.float32)}
        return gen()

    before = threading.active_count()
    loader = PrefetchLoader(factory, workers=2, host_depth=1, device_depth=1)
    batch = next(loader)
    assert isinstance(batch["x"], torch.Tensor) and batch["x"].shape == (2, 4)
    loader.close()
    for t in loader._threads:
        assert not t.is_alive(), "loader thread survived close()"
    loader.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
