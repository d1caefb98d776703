"""The port's trainer against the JAX package's `Trainer` on the tiny stage-2
config of tests/test_trainer.py (fp32 denoiser, fp32 frozen storage), B = 2.

Same weights: every leaf of the JAX parameter trees is drawn with numpy
(`torch_port_util.randomize`, so the zero-initialised output convs carry
gradient too), the JAX trainer partitions them (`create_state`) and
`convert.from_jax.load_train_state` carries its TrainState into the port.
Same draws: the JAX trainer's rng splits (trainer.py:233, diffusion.py:42)
are reproduced here and handed to the port as `Draws`.

The JAX reference of a step is the JAX trainer's own `_loss` and optax
chain (`torch_port_util.JaxReference`).

Tolerances. Loss: 1e-5 relative (fp32, summation order through two UNets).
Gradients and parameters: 2e-4 absolute and relative, the converter oracle's
fp32 bound for networks this deep. The parameter updates are compared
against the learning rate, to 2% of it: Adam normalizes each gradient
element, so an element whose gradient is near the fp32 noise of the
summation could move differently by up to 2 x lr; `adam_eps` 1e-4 in the
step tests bounds that sensitivity.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from magicdance_tpu import config as J
from magicdance_tpu.train.trainer import trainable_predicate as j_pred
from magicdance_tpu_torch import config as T
from magicdance_tpu_torch.convert.from_jax import flax_key
from magicdance_tpu_torch.train.checkpoint import CheckpointManager
from magicdance_tpu_torch.train.trainer import Trainer, param_path
from magicdance_tpu_torch.train.trainer import trainable_predicate as t_pred
from torch_port_util import (
    JaxReference,
    assert_tree_close,
    jax_draws,
    jax_params,
    jax_train_cfg,
    make_train_batch,
    port_batch,
    port_train_cfg,
    port_trainer,
    to_port,
)
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)


@pytest.fixture(scope="module")
def stage2_params():
    """`jax_params` of the stage-2 model (seed 0), built once: the trainable
    sets and the stage-2 reference read the same tree."""
    return jax_params(jax_train_cfg())


def test_trainable_sets_match_jax(stage2_params):
    (m, _, _), (mp, _, _) = stage2_params
    flat = jax.tree_util.tree_flatten_with_path(mp["params"])[0]
    paths = [tuple(p.key for p in path) for path, _ in flat]
    tr = Trainer(port_train_cfg(jax_train_cfg()), device="cpu")
    keys = list(tr.model.state_dict())
    assert {flax_key(p) for p in paths} == set(keys)
    for regime in T.FreezeRegime:
        for locked in (True, False):
            jp = j_pred(J.FreezeRegime(regime.value), locked)
            want = {".".join(p[:-1]) for p in paths if jp(p)}
            got = {k.rsplit(".", 1)[0] for k in keys if t_pred(regime, locked)(param_path(k))}
            assert got == want, (regime, locked)
    pred = t_pred(T.FreezeRegime.MOTION_ONLY)
    assert pred(("unet", "enc_motion_0", "attn_0", "to_q", "weight"))
    assert not pred(("unet", "enc_attn_0", "block_0", "attn1", "to_q", "weight"))
    # the trainer's own partition: stage 2 trains both control branches only
    assert tr.train_params and all(k.split(".")[0] in ("appearance_unet", "pose_control")
                                   for k in tr.train_params)
    assert all(not p.requires_grad for k, p in tr.model.named_parameters()
               if k not in tr.train_params)


@pytest.fixture(scope="module")
def stage2(stage2_params):
    jc = jax_train_cfg(optim=J.OptimConfig(learning_rate=1e-3, warmup_steps=1, adam_eps=1e-4,
                                     frozen_dtype="float32", ema_rate=0.5,
                                     weight_decay=0.01),
                 vae_encode_chunk=1)
    return JaxReference(jc, params=stage2_params)  # the model of jax_train_cfg(), seed 0


def test_loss_and_grads_match_jax(stage2):
    ref = stage2
    batch, rng = make_train_batch(0), jax.random.PRNGKey(11)
    (want_loss, want_m), want_g = ref.loss_and_grads(batch, rng)
    tr = port_trainer(ref)
    loss, metrics, grads = tr.loss_and_grads(port_batch(batch), jax_draws(ref.cfg, rng))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["t_mean"]), float(want_m["t_mean"]))
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert_tree_close(grads, want_g)
    # the loss reaches every trainable branch
    assert float(sum(g.abs().sum() for g in grads.values())) > 0


def test_two_steps_and_ema_match_jax(stage2):
    ref = stage2
    tr = port_trainer(ref)
    before = {k: p.detach().clone() for k, p in tr.train_params.items()}
    for i in range(2):
        batch, rng = make_train_batch(i), jax.random.PRNGKey(20 + i)
        metrics = tr.train_step(port_batch(batch), jax_draws(ref.cfg, rng))
        np.testing.assert_allclose(float(metrics["loss"]), ref.step(batch, rng), rtol=1e-5)
    lr = ref.cfg.optim.learning_rate
    want = to_port(ref.state.train_params)
    moved = 0
    for k, p in tr.train_params.items():
        d_got, d_want = p.detach() - before[k], want[k] - before[k]
        np.testing.assert_allclose(d_got.numpy(), d_want.numpy(), atol=0.02 * lr, err_msg=k)
        moved += int((d_want.abs() > 0.5 * lr).sum())
    assert moved > 0  # the second update (rate lr after a warm-up of 1) moved them
    assert_tree_close(tr.ema_params, ref.state.ema_params)
    assert tr.step == int(ref.state.step) == 2


def test_grad_accum_matches_jax(stage2):
    jc = dataclasses.replace(stage2.cfg, optim=J.OptimConfig(
        learning_rate=1e-3, warmup_steps=1, adam_eps=1e-4, frozen_dtype="float32",
        grad_accum=2))
    ref = JaxReference(jc, seed=3, loss_from=stage2)
    tr = port_trainer(ref)
    before = {k: p.detach().clone() for k, p in tr.train_params.items()}
    for i in range(4):
        batch, rng = make_train_batch(10 + i), jax.random.PRNGKey(30 + i)
        tr.train_step(port_batch(batch), jax_draws(jc, rng))
        ref.step(batch, rng)
        if i < 2:  # accumulating, then a rate-0 update: nothing moves yet
            for k, p in tr.train_params.items():
                assert torch.equal(p.detach(), before[k]), k
    want = to_port(ref.state.train_params)
    for k, p in tr.train_params.items():
        np.testing.assert_allclose((p.detach() - before[k]).numpy(),
                                   (want[k] - before[k]).numpy(), atol=0.02 * 1e-3, err_msg=k)
    assert any(not torch.equal(p.detach(), before[k]) for k, p in tr.train_params.items())


def test_checkpoint_resume_equals_straight_run(tmp_path):
    """Save at step 2, resume in a new trainer to step 4: the same state as
    4 steps straight (the trainer's own draws, generator state included)."""
    cfg = port_train_cfg(jax_train_cfg(optim=J.OptimConfig(learning_rate=1e-3, warmup_steps=1,
                                               frozen_dtype="bfloat16", ema_rate=0.9)))
    cfg = dataclasses.replace(cfg, save_total_limit=1)
    batches = [port_batch(make_train_batch(40 + i)) for i in range(4)]

    def fresh():
        tr = Trainer(cfg, device="cpu")
        tr.init_random(seed=5, scale=0.1)
        return tr

    straight = fresh()
    for b in batches:
        straight.train_step(b)
    first = fresh()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), cfg.save_total_limit)
    for b in batches[:2]:
        first.train_step(b)
    mgr.save(1, first.state_dict())
    mgr.save(2, first.state_dict())
    assert mgr.all_steps() == [2]  # rotation by save_total_limit
    resumed = fresh()
    resumed.load_state_dict(mgr.restore())
    assert resumed.step == 2
    for b in batches[2:]:
        resumed.train_step(b)
    for name in ("model", "vae", "clip"):
        a, b = getattr(straight, name).state_dict(), getattr(resumed, name).state_dict()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for k in straight.ema_params:
        assert torch.equal(straight.ema_params[k], resumed.ema_params[k])
