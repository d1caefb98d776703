"""Stage-3 training across two processes (gloo on the CPU) and the training
CLI as torchrun starts it.

Stage 3: two clips of F = 4 frames, one a rank, each rank with its clip's
rows of the global draws (one timestep a clip), against the JAX trainer's
step on both clips (tests/test_torch_trainer_video.py's config and
tolerances: loss 1e-5 relative, updates to 2% of the learning rate). The CLI:
two ranks of `cli.train --device cpu` for two steps write one checkpoint and
one metrics log, from rank 0 only. Stage 2 on two ranks:
tests/test_torch_distributed.py.
"""

import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from magicdance_tpu_torch import config as T
from test_cli_train import make_dataset, tiny_config_json
from test_torch_trainer_video import clip_batch, temporal_train_cfg
from test_torch_trainer_video import draws as clip_draws
from torch_port_util import JaxReference, Ranks, port_trainer, to_port
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

LR = 1e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ref3 = JaxReference(temporal_train_cfg(), seed=11)
    tr3 = port_trainer(ref3)
    batch3, rng3 = clip_batch(3), jax.random.PRNGKey(5)
    job = dict(kind="train", name="stage3", cfg=T.to_dict(tr3.cfg), steps=1, batches=[batch3],
               draws=[clip_draws(ref3.cfg, rng3)], state=tr3.state_dict())
    ranks = Ranks(tmp_path_factory.mktemp("clips"), [job])
    want = {"stage3": [ref3.step(batch3, rng3)]}
    return dict(out=ranks.join(), want=want, ref3=ref3,
                before3={k: p.detach().clone() for k, p in tr3.train_params.items()})


def test_stage3_clips_over_two_ranks_match_jax(runs):
    got = runs["out"][0]["stage3"]
    np.testing.assert_allclose(got["metrics"][0]["loss"], runs["want"]["stage3"][0], rtol=1e-5)
    assert got["params"] and all("motion" in k for k in got["params"])
    want = to_port(runs["ref3"].state.train_params)
    for k, p in got["params"].items():
        np.testing.assert_allclose((p - runs["before3"][k]).numpy(),
                                   (want[k] - runs["before3"][k]).numpy(), atol=0.02 * LR,
                                   err_msg=k)


def test_stage3_ranks_agree(runs):
    a, b = runs["out"][0]["stage3"], runs["out"][1]["stage3"]
    assert a["metrics"] == b["metrics"]
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k


def test_cli_on_two_ranks_writes_one_checkpoint_and_one_log(tmp_path):
    """`cli.train --device cpu` as torchrun starts it (RANK, WORLD_SIZE,
    LOCAL_RANK), the rendezvous through a file: two steps, one checkpoint
    and one metrics log, written by rank 0, one sample grid."""
    make_dataset(tmp_path)
    tiny_config_json(tmp_path / "cfg.json", steps=2)
    out = tmp_path / "run"
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT")}
    env.update(WORLD_SIZE="2", OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "magicdance_tpu_torch.cli.train", "--config",
           str(tmp_path / "cfg.json"), "--data", str(tmp_path), "--output", str(out),
           "--steps", "2", "--image_size", "32", "--device", "cpu",
           "--init_method", f"file://{tmp_path / 'rdzv'}"]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=REPO, env={**env, "RANK": str(r), "LOCAL_RANK": str(r)})
             for r in range(2)]
    outs, t0 = [], time.time()
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, 180 - (time.time() - t0)))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{text[-4000:]}"
    assert "mesh={'data': 2} global_batch=2" in outs[0]
    assert "[train]" not in outs[1]  # rank 1 prints nothing of its own
    assert sorted(os.listdir(out / "checkpoints")) == ["step_00000002"]
    assert len([f for f in os.listdir(out / "tb") if f.startswith("events")]) <= 1
    lines = [json.loads(line) for line in open(out / "tb" / "metrics.jsonl")]
    assert [rec["step"] for rec in lines] == [1, 2]
    assert os.listdir(out / "samples") == ["step_00000002.png"]
    state = torch.load(out / "checkpoints" / "step_00000002" / "state.pt", weights_only=False)
    assert state["step"] == 2
