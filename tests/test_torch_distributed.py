"""The port's trainer across two processes (gloo on the CPU) against the JAX
package's `Trainer` on the global batch.

Two ranks at B = 2 each take their rows of a global B = 4 batch and their
rows of the global batch's draws (the JAX trainer's rng splits, reproduced
as in tests/test_torch_trainer.py); the JAX reference computes the same
steps on the whole B = 4 batch in this process (its `_loss` and optax chain,
`torch_port_util.JaxReference`), as one device computes what XLA shards.
Tolerances are tests/test_torch_trainer.py's: loss 1e-5 relative, EMA 2e-4,
parameter updates to 2% of the learning rate. Also: ZeRO-1 on and off give
the same bits, each rank holds half of the sharded moments, both ranks
report the global loss, a ("data", "model") mesh trains data parallel, and
checkpoints move between one and two ranks. Stage 3 and the CLI on two ranks:
tests/test_torch_distributed_clips.py.

The two ranks run `tests/torch_dist_worker.py` (torch and the port only)
while the JAX reference computes here.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from magicdance_tpu import config as J
from magicdance_tpu_torch import config as T
from magicdance_tpu_torch.parallel.mesh import zero1_sharding
from magicdance_tpu_torch.train.checkpoint import CheckpointManager
from magicdance_tpu_torch.train.trainer import Trainer
from torch_port_util import (
    JaxReference,
    Ranks,
    jax_draws,
    jax_train_cfg,
    make_train_batch,
    port_batch,
    port_train_cfg,
    port_trainer,
    to_port,
)
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

LR = 1e-3


def global_batch(seed: int) -> dict:
    """B = 4: two of make_train_batch's B = 2 batches."""
    a, b = make_train_batch(seed), make_train_batch(1000 + seed)
    return {k: np.concatenate([a[k], b[k]]) for k in a}


def stage2_cfg(**optim) -> J.TrainConfig:
    base = dict(learning_rate=LR, warmup_steps=1, adam_eps=1e-4, frozen_dtype="float32")
    base.update(optim)
    return jax_train_cfg(optim=J.OptimConfig(**base), vae_encode_chunk=1)


def train_job(name, cfg: T.TrainConfig, steps: int, batches, draws=None, state=None, **kw):
    return dict(kind="train", name=name, cfg=T.to_dict(cfg), steps=steps, batches=batches,
                draws=draws, state=state, **kw)


def assert_updates_close(got: dict, want: dict, before: dict, lr: float = LR) -> None:
    moved = 0
    for k, p in got.items():
        d_want = want[k] - before[k]
        np.testing.assert_allclose((p - before[k]).numpy(), d_want.numpy(), atol=0.02 * lr,
                                   err_msg=k)
        moved += int((d_want.abs() > 0.5 * lr).sum())
    assert moved > 0


def one_rank_steps(cfg, state_or_seed, batches, resume_dir=None):
    """The same trainer in this process (no group), on the global batches
    with its own draws."""
    tr = Trainer(cfg, device="cpu")
    if resume_dir is not None:
        tr.load_state_dict(CheckpointManager(resume_dir).restore())
    else:
        tr.init_random(seed=state_or_seed, scale=0.1)
    for b in batches:
        tr.train_step(port_batch(b))
    return tr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("dist")
    # stage 2, ZeRO-1 on / off, a ("data", "model") mesh
    ref = JaxReference(stage2_cfg(ema_rate=0.5, weight_decay=0.01))
    tr = port_trainer(ref)
    state, cfg = tr.state_dict(), tr.cfg
    before = {k: p.detach().clone() for k, p in tr.train_params.items()}
    zero1 = zero1_sharding(tr.model, list(tr.train_params), 2)
    full_bytes = sum(2 * 4 * p.numel() for p in tr.train_params.values())
    want_bytes = sum(2 * 4 * (p.numel() // 2 if zero1[k] is not None else p.numel())
                     for k, p in tr.train_params.items())
    batches = [global_batch(i) for i in range(2)]
    rngs = [jax.random.PRNGKey(20 + i) for i in range(2)]
    draws = [jax_draws(ref.cfg, r, n_image=4, n_ref=4) for r in rngs]
    off = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, shard_opt_state=False))
    dm = dataclasses.replace(cfg, mesh_axes=("data", "model"))
    # grad_accum = 2
    ref_acc = JaxReference(stage2_cfg(grad_accum=2), seed=3, loss_from=ref)
    tr_acc = port_trainer(ref_acc)
    batches_acc = [global_batch(10 + i) for i in range(4)]
    rngs_acc = [jax.random.PRNGKey(30 + i) for i in range(4)]
    draws_acc = [jax_draws(ref_acc.cfg, r, n_image=4, n_ref=4) for r in rngs_acc]
    # checkpoints between one and two ranks: the trainer's own draws
    ck_cfg = port_train_cfg(stage2_cfg(ema_rate=0.9, frozen_dtype="bfloat16"))
    ck_batches = [global_batch(40 + i) for i in range(4)]
    saved_one = str(work / "saved_by_one")
    mgr = CheckpointManager(saved_one)
    mgr.save(2, one_rank_steps(ck_cfg, 5, ck_batches[:2]).state_dict())

    jobs = [train_job("zero1", cfg, 2, batches, draws, state),
            train_job("replicated", off, 2, batches, draws, state),
            train_job("data_model", dm, 2, batches, draws, state),
            train_job("accum", tr_acc.cfg, 4, batches_acc, draws_acc, tr_acc.state_dict()),
            train_job("save_two", ck_cfg, 2, ck_batches[:2], seed=5,
                      save=str(work / "saved_by_two")),
            train_job("resume_two", ck_cfg, 2, ck_batches[2:], resume=saved_one,
                      save=str(work / "resumed_by_two"))]
    ranks = Ranks(work / "ranks", jobs)
    # the JAX references, while the ranks run
    want = {"zero1": [ref.step(b, r) for b, r in zip(batches, rngs)]}
    want["accum"] = [ref_acc.step(b, r) for b, r in zip(batches_acc, rngs_acc)]
    straight = one_rank_steps(ck_cfg, 5, ck_batches)
    out = ranks.join()
    return dict(out=out, want=want, ref=ref, ref_acc=ref_acc, before=before,
                before_acc={k: p.detach().clone() for k, p in tr_acc.train_params.items()},
                full_bytes=full_bytes, want_bytes=want_bytes, straight=straight,
                ck_cfg=ck_cfg, ck_batches=ck_batches, work=work)


def test_two_ranks_match_jax_on_the_global_batch(runs):
    got = runs["out"][0]["zero1"]
    np.testing.assert_allclose([m["loss"] for m in got["metrics"]], runs["want"]["zero1"],
                               rtol=1e-5)
    ref = runs["ref"]
    assert_updates_close(got["params"], to_port(ref.state.train_params), runs["before"])
    want_ema = to_port(ref.state.ema_params)
    for k, v in got["ema"].items():
        np.testing.assert_allclose(v.numpy(), want_ema[k].numpy(), atol=2e-4, rtol=2e-4,
                                   err_msg=k)
    assert got["step"] == int(ref.state.step) == 2


def test_grad_accum_on_two_ranks_matches_jax(runs):
    got = runs["out"][0]["accum"]
    np.testing.assert_allclose([m["loss"] for m in got["metrics"]], runs["want"]["accum"],
                               rtol=1e-5)
    assert_updates_close(got["params"], to_port(runs["ref_acc"].state.train_params),
                         runs["before_acc"])


def test_zero1_on_and_off_give_the_same_bits(runs):
    on, off = runs["out"][0]["zero1"], runs["out"][0]["replicated"]
    assert on["metrics"] == off["metrics"]
    for k in on["params"]:
        assert torch.equal(on["params"][k], off["params"][k]), k
    for part in ("mu", "nu"):
        for k, t in on["opt"][part].items():
            assert torch.equal(t, off["opt"][part][k]), (part, k)


def test_zero1_rank_holds_half_the_moments(runs):
    for r in range(2):
        got = runs["out"][r]
        assert got["zero1"]["opt_bytes"] == runs["want_bytes"]
        assert got["zero1"]["full_opt_bytes"] == runs["full_bytes"]
        assert got["replicated"]["opt_bytes"] == runs["full_bytes"]
    assert runs["want_bytes"] < 0.52 * runs["full_bytes"]


def test_both_ranks_report_the_global_metrics(runs):
    for name in ("zero1", "accum"):
        assert runs["out"][0][name]["metrics"] == runs["out"][1][name]["metrics"]
        for k in runs["out"][0][name]["params"]:
            assert torch.equal(runs["out"][0][name]["params"][k],
                               runs["out"][1][name]["params"][k]), (name, k)


def test_data_model_mesh_trains_data_parallel(runs):
    dm, on = runs["out"][0]["data_model"], runs["out"][0]["zero1"]
    assert dm["mesh"] == {"data": 2, "model": 1}
    assert on["mesh"] == {"data": 2}
    assert dm["metrics"] == on["metrics"]
    for k in on["params"]:
        assert torch.equal(dm["params"][k], on["params"][k]), k


def assert_state_close(tr: Trainer, straight: Trainer) -> None:
    assert tr.step == straight.step == 4
    for k, p in straight.train_params.items():
        np.testing.assert_allclose(tr.train_params[k].detach().numpy(), p.detach().numpy(),
                                   atol=0.02 * LR, err_msg=k)
    for k, e in straight.ema_params.items():
        np.testing.assert_allclose(tr.ema_params[k].numpy(), e.numpy(), atol=0.02 * LR,
                                   err_msg=k)
    assert torch.equal(tr.generator.get_state(), straight.generator.get_state())


def test_checkpoint_saved_on_two_ranks_resumes_on_one(runs):
    saved = os.path.join(runs["work"], "saved_by_two")
    assert sorted(os.listdir(saved)) == ["step_00000002"]
    tr = one_rank_steps(runs["ck_cfg"], None, runs["ck_batches"][2:], resume_dir=saved)
    assert_state_close(tr, runs["straight"])


def test_checkpoint_saved_on_one_rank_resumes_on_two(runs):
    tr = Trainer(runs["ck_cfg"], device="cpu")
    tr.load_state_dict(CheckpointManager(os.path.join(runs["work"], "resumed_by_two")).restore())
    assert_state_close(tr, runs["straight"])
