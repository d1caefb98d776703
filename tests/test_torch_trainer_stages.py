"""The port's trainer against the JAX package's `Trainer` on the other tiny
configurations of the slice: stage 1 (`APPEARANCE` variant,
`APPEARANCE_PRETRAIN` regime: the appearance UNet and the main UNet's attn1
train, no ControlNet) and stage 2 with the frozen weights stored in bf16.
Setup, draws and tolerances as in tests/test_torch_trainer.py: loss 1e-5
relative; gradients 2e-4 absolute and relative; parameter updates to 2% of
the learning rate. bf16 storage changes the weights both sides compute with
(bf16-rounded, then computed in fp32), not the arithmetic, so it keeps the
fp32 tolerances. Also: the loss variants, dropout refused in training as
JAX refuses it, bf16 compute with fp32 masters, and chip_smoke.py's launch
plan.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicdance_tpu import config as J
from magicdance_tpu_torch import config as T
from torch_port_util import (
    JaxReference,
    assert_tree_close,
    jax_draws,
    jax_train_cfg,
    make_train_batch,
    port_batch,
    port_train_cfg,
    port_trainer,
    to_port,
    to_t,
)
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)


def test_stage1_loss_grads_and_steps_match_jax():
    jc = jax_train_cfg(variant=J.ModelVariant.APPEARANCE,
                       freeze=J.FreezeRegime.APPEARANCE_PRETRAIN,
                       optim=J.OptimConfig(learning_rate=1e-3, warmup_steps=1,
                                           adam_eps=1e-4, frozen_dtype="float32"))
    ref = JaxReference(jc, seed=7)
    tr = port_trainer(ref)
    assert not hasattr(tr.model, "pose_control")
    assert any(k.startswith("unet.") and ".attn1." in k for k in tr.train_params)
    assert all(k.startswith("appearance_unet.") or ".attn1." in k for k in tr.train_params)
    batch, rng = make_train_batch(50, pose=False), jax.random.PRNGKey(51)
    (want_loss, _), want_g = ref.loss_and_grads(batch, rng)
    loss, _, grads = tr.loss_and_grads(port_batch(batch), jax_draws(jc, rng))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert_tree_close(grads, want_g)
    before = {k: p.detach().clone() for k, p in tr.train_params.items()}
    for i in range(2):
        batch, rng = make_train_batch(52 + i, pose=False), jax.random.PRNGKey(60 + i)
        metrics = tr.train_step(port_batch(batch), jax_draws(jc, rng))
        np.testing.assert_allclose(float(metrics["loss"]), ref.step(batch, rng), rtol=1e-5)
    want = to_port(ref.state.train_params)
    for k, p in tr.train_params.items():
        np.testing.assert_allclose((p.detach() - before[k]).numpy(),
                                   (want[k] - before[k]).numpy(), atol=0.02 * 1e-3, err_msg=k)
    assert any(not torch.equal(p.detach(), before[k]) for k, p in tr.train_params.items())


def test_stage2_bf16_frozen_loss_and_grads_match_jax():
    jc = jax_train_cfg(optim=J.OptimConfig(learning_rate=1e-3, warmup_steps=1,
                                           frozen_dtype="bfloat16"))
    ref = JaxReference(jc, seed=9)
    tr = port_trainer(ref)
    frozen = [p for k, p in tr.model.named_parameters() if k not in tr.train_params]
    assert frozen and all(p.dtype == torch.bfloat16 and not p.requires_grad for p in frozen)
    assert all(p.dtype == torch.bfloat16 for m in (tr.vae, tr.clip) for p in m.parameters())
    assert all(p.dtype == torch.float32 for p in tr.train_params.values())
    batch, rng = make_train_batch(70), jax.random.PRNGKey(71)
    (want_loss, _), want_g = ref.loss_and_grads(batch, rng)
    loss, _, grads = tr.loss_and_grads(port_batch(batch), jax_draws(jc, rng))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert_tree_close(grads, want_g)


def test_launch_plan_matches_counted_calls(monkeypatch):
    """chip_smoke.py holds the card to its launch plan for the training step;
    here the plan meets the calls the autograd Functions make in one narrow
    stage-2 step at 128x128 on the CPU (S = 256 sites take the Functions,
    which run their plain versions here): forwards twice under remat, no
    backward at the appearance UNet's last site, and only the bank's dK/dV
    at the frozen main UNet's first site."""
    import chip_smoke
    from magicdance_tpu_torch.ops.kernels import flash_vjp as V
    from magicdance_tpu_torch.train.trainer import Trainer

    calls = {m: 0 for m in chip_smoke.TRAIN_MODES}

    def counting(fn, mode_of):
        def wrapped(*a, **kw):
            calls[mode_of(a, kw)] += 1
            return fn(*a, **kw)
        return wrapped

    def dq_mode(a, kw):
        two = (a[7] if len(a) > 7 else kw.get("k_bank")) is not None
        return "attention_dq_two_source" if two else "attention_dq"

    monkeypatch.setattr(V, "self_attention_lse", counting(
        V.self_attention_lse, lambda a, kw: "self_attention_lse"))
    monkeypatch.setattr(V, "two_source_attention_lse", counting(
        V.two_source_attention_lse, lambda a, kw: "two_source_attention_lse"))
    monkeypatch.setattr(V, "attention_dq", counting(V.attention_dq, dq_mode))
    monkeypatch.setattr(V, "attention_dkv", counting(
        V.attention_dkv, lambda a, kw: "attention_dkv"))
    cfg = chip_smoke.narrow_train_config()
    tr = Trainer(cfg, device="cpu")
    tr.init_random(seed=0, scale=0.1)
    g = torch.Generator().manual_seed(0)
    batch = {"image": torch.rand(2, 128, 128, 3, generator=g) * 2 - 1,
             "reference": torch.rand(2, 128, 128, 3, generator=g) * 2 - 1,
             "pose": torch.rand(2, 128, 128, 3, generator=g),
             "input_ids": torch.zeros(2, 77, dtype=torch.long)}
    tr.train_step(batch)
    _, totals, _ = chip_smoke.training_launch_plan(cfg.model, 16)
    assert calls == totals
    assert totals == {"self_attention_lse": 14, "two_source_attention_lse": 10,
                      "attention_dq": 6, "attention_dq_two_source": 4, "attention_dkv": 15}


@pytest.mark.parametrize("param,loss_type,elbo,wonoise", [
    ("eps", "l2", 0.0, True), ("x0", "l1", 0.0, True), ("v", "l2", 0.5, True),
    ("eps", "l2", 0.5, False)])
def test_diffusion_loss_variants_match_jax(param, loss_type, elbo, wonoise):
    """`diffusion_loss` (eps / x0 / v targets, l2 / l1, the lvlb term, a
    noised reference) and `get_v` against the JAX functions, with a fixed
    elementwise denoiser and the same draws (fp32, 1e-6)."""
    from magicdance_tpu.models.diffusion import diffusion_loss as j_loss
    from magicdance_tpu.ops.schedules import get_v as j_get_v
    from magicdance_tpu.ops.schedules import make_schedule as j_sched
    from magicdance_tpu_torch.models.diffusion import diffusion_loss as t_loss
    from magicdance_tpu_torch.ops.schedules import get_v as t_get_v
    from magicdance_tpu_torch.ops.schedules import make_schedule as t_sched

    dj = J.DiffusionConfig(parameterization=J.Parameterization(param), loss_type=loss_type,
                           original_elbo_weight=elbo)
    dt = T.from_dict(T.DiffusionConfig, J.to_dict(dj))
    rng = jax.random.PRNGKey(3)
    rs = np.random.RandomState(4)
    x0, ref = rs.randn(3, 4, 4, 4).astype(np.float32), rs.randn(3, 4, 4, 4).astype(np.float32)
    ctx = rs.randn(3, 5, 8).astype(np.float32)
    rng_t, rng_noise, rng_ref = jax.random.split(rng, 3)
    t = jax.random.randint(rng_t, (3,), 0, dj.timesteps, dtype=jnp.int32)
    noise = jax.random.normal(rng_noise, x0.shape)

    def j_apply(x, tt, c, reference_noisy=None, pose_hint=None, num_frames=1):
        return 0.5 * x + 0.1 * reference_noisy + c.mean() + 1e-3 * tt[:, None, None, None]

    def t_apply(x, tt, c, reference_noisy=None, pose_hint=None, num_frames=1):
        return 0.5 * x + 0.1 * reference_noisy + c.mean() + 1e-3 * tt[:, None, None, None]

    ref_noise = jax.random.normal(rng_ref, ref.shape)
    want, want_m = j_loss(j_apply, j_sched(dj), dj, rng, jnp.asarray(x0), jnp.asarray(ctx),
                          reference_latent=jnp.asarray(ref), wonoise=wonoise)
    got, got_m = t_loss(t_apply, t_sched(dt), dt, to_t(x0), to_t(ctx), to_t(t).long(),
                        to_t(noise), reference_latent=to_t(ref), wonoise=wonoise,
                        ref_noise=to_t(ref_noise))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert set(got_m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(
        t_get_v(t_sched(dt), to_t(x0), to_t(noise), to_t(t).long()).numpy(),
        np.asarray(j_get_v(j_sched(dj), jnp.asarray(x0), noise, t)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("field,value", [("dropout", 0.1)])
def test_trainer_refuses_what_is_not_ported(field, value):
    """The one TrainConfig value neither package trains: dropout > 0. JAX's
    train step applies the model with deterministic=False and no "dropout"
    RNG, which Flax refuses (InvalidRngError); the port's step raises there
    too. (frozen_dtype="int8" and attention_impl "xla" / "flash" are ported:
    tests/test_torch_quant.py, tests/test_torch_attention_impl.py.)"""
    import flax

    from magicdance_tpu.train.trainer import Trainer as JTrainer
    from magicdance_tpu_torch.train.trainer import Trainer
    from torch_port_util import jax_params

    jc = jax_train_cfg()
    jc = dataclasses.replace(jc, model=dataclasses.replace(
        jc.model, unet=dataclasses.replace(jc.model.unet, **{field: value})))
    (m, v, c), (mp, vp, cp) = jax_params(jc)
    jt = JTrainer(jc, m, v, c)
    state = jt.create_state(mp, vp, cp)
    batch = jax.tree.map(jnp.asarray, make_train_batch(3))
    with pytest.raises(flax.errors.InvalidRngError):
        jax.eval_shape(jt._loss, state.train_params, state.frozen_params, batch,
                       jax.random.PRNGKey(0))
    tr = Trainer(port_train_cfg(jc), device="cpu")  # builds, as JAX's does
    tr.init_random(seed=0, scale=0.1)
    with pytest.raises(RuntimeError, match="InvalidRngError"):
        tr.train_step(port_batch(make_train_batch(3)))


def test_bf16_denoiser_trains_fp32_masters():
    """ModelConfig.dtype = bf16: the denoiser's products run in bf16 while
    the trainable masters, the gradients reaching the optimizer and its
    moments stay fp32 (weights cast at use), and frozen weights sit in bf16."""
    from magicdance_tpu_torch.models.layers import Linear
    from magicdance_tpu_torch.train.trainer import Trainer

    jc = jax_train_cfg(optim=J.OptimConfig(learning_rate=1e-3, warmup_steps=1))
    cfg = port_train_cfg(jc)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype="bfloat16"))
    tr = Trainer(cfg, device="cpu")
    tr.init_random(seed=1, scale=0.1)
    seen = set()
    hooks = [m.register_forward_pre_hook(lambda _, a: seen.add(a[0].dtype))
             for m in tr.model.modules() if isinstance(m, Linear)]
    batch = port_batch(make_train_batch(90))
    _, _, grads = tr.loss_and_grads(batch, tr.draw(batch))
    for h in hooks:
        h.remove()
    assert seen == {torch.bfloat16}
    assert all(p.dtype == torch.float32 for p in tr.train_params.values())
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads.values())
    assert any(g.abs().sum() > 0 for g in grads.values())
    tr.apply_update(grads)
    assert all(m.dtype == torch.float32 for m in tr.opt.mu.values())
    assert all(p.dtype == torch.bfloat16 for k, p in tr.model.named_parameters()
               if k not in tr.train_params)
