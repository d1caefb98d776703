"""`attention_impl` ("auto" / "xla" / "flash") and the
`MD_DISABLE_GROUPED_ATTN` switch in the port (`ops/attention.py`) against the
JAX package's dispatch and trainer.

* Routes: for every attention site of the full-width image and video models
  (self-attention, bank reads, cross-attention over the 77 context tokens,
  the temporal S = 16 sites) and the small grouped spatial sites, the port's
  `route` under each override and the switch equals JAX's
  `_pick_impl_packed` with its TPU term taken as true ("flash_fused" and
  "flash" are the port's kernel route, "flash_grouped" its grouped kernel,
  "xla" its plain math).
* Trainers: a tiny stage-2 step under "xla" and under "flash" against JAX's
  trainer loss traced under the same override (loss 1e-5 relative,
  gradients 2e-4, updates 2% of the learning rate, as
  tests/test_torch_trainer_stages.py). On the CPU JAX's "flash" sites run
  its XLA fallback (`ops/flash_attention.py`), so its loss under "xla" and
  "flash" is one program: the test shows the two traces are equal, then
  holds both port trainers to it.
* Launch plans: chip_smoke.py's `flash_launch_plan` meets the calls the
  port makes in one tiny stage-2 and one stage-3 step under "flash" (kernel
  wrappers and autograd Functions counted by shape); under "xla" no kernel
  wrapper and no Function is called.
"""

import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magicdance_tpu.ops.attention as JA
from magicdance_tpu import config as J
from magicdance_tpu_torch import config as C
from magicdance_tpu_torch.convert.from_jax import load_train_state
from magicdance_tpu_torch.ops import attention as TA
from magicdance_tpu_torch.train.trainer import Trainer
from torch_port_util import (
    JaxReference,
    assert_tree_close,
    jax_draws,
    jax_train_cfg,
    make_train_batch,
    port_batch,
    port_train_cfg,
    to_port,
)
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

LR = 1e-3
ROUTE = {"flash_fused": "kernel", "flash": "kernel", "flash_grouped": "grouped", "xla": "plain"}


def model_sites():
    """(sq, sk_total, d, bank, has_mask, batch) of every attention call of
    the full-width image and video models at 512x512, and of small spatial
    sites that the grouped rule takes at some batches."""
    import chip_smoke

    sites = set()
    for cfg, frames in ((C.ModelConfig(), 1), (chip_smoke.temporal_model_config(), 16)):
        ctx = cfg.clip.max_length
        for kind, s, x in chip_smoke.unet_sites(cfg.unet, 64):
            if kind == "motion":
                d = x // cfg.unet.motion_num_heads
                for clips in (1, 2):
                    sites.add((frames, frames, d, False, False, clips * s))
                continue
            for b in (1, 2, 16):
                sites.add((s, s, x, False, False, b))          # self-attention
                sites.add((s, 2 * s, x, True, False, b))       # bank read
                sites.add((s, 2 * s, x, True, True, b))        # gated bank read
                sites.add((s, ctx, x, False, False, b))        # cross-attention
    for s in (4, 8, 16, 32, 64):
        for b in (2, 8, 16, 32):
            sites.add((s, s, 32, False, False, b))
    return sorted(sites)


@pytest.mark.parametrize("impl,disable", [("auto", False), ("flash", False), ("xla", False),
                                          ("auto", True)])
def test_routes_match_jax_dispatch(impl, disable, monkeypatch):
    if disable:
        monkeypatch.setenv("MD_DISABLE_GROUPED_ATTN", "1")
    else:
        monkeypatch.delenv("MD_DISABLE_GROUPED_ATTN", raising=False)
    monkeypatch.setattr(JA.jax, "default_backend", lambda: "tpu")
    seen = Counter()
    with JA.attention_impl(impl), TA.attention_impl(impl):
        for sq, sk, d, bank, mask, b in model_sites():
            want = ROUTE[JA._pick_impl_packed(sq, sk, d, bank=bank, has_mask=mask,
                                              batch=0 if bank else b)]
            got = TA.route(sq, sk, d, bank=bank, batch=b)
            assert got == want, (impl, disable, sq, sk, d, bank, mask, b)
            seen[got] += 1
    if impl == "flash":
        assert set(seen) == {"kernel"}
    elif impl == "xla":
        assert set(seen) == {"plain"}
    else:
        assert seen["kernel"] and seen["plain"] and bool(seen["grouped"]) != disable


def test_override_is_scoped():
    assert TA.current_impl() == "auto"
    with TA.attention_impl("flash"):
        assert TA.route(16, 77, 40) == "kernel"
        with TA.attention_impl("xla"):
            assert TA.route(4096, 4096, 40) == "plain"
        assert TA.current_impl() == "flash"
    assert TA.route(16, 77, 40) == "plain" and TA.current_impl() == "auto"
    with pytest.raises(ValueError):
        with TA.attention_impl("pallas"):
            pass


# --------------------------------------------------------------------------
# trainers against JAX under the same override
# --------------------------------------------------------------------------


def jax_cfg(impl):
    return jax_train_cfg(attention_impl=impl,
                         optim=J.OptimConfig(learning_rate=LR, warmup_steps=1, adam_eps=1e-4,
                                             frozen_dtype="float32"))


def test_xla_and_flash_trainers_match_jax():
    ref = JaxReference(jax_cfg("flash"), seed=21)
    batch, rng = make_train_batch(150), jax.random.PRNGKey(151)
    args = (ref.state.train_params, ref.state.frozen_params,
            jax.tree.map(jnp.asarray, batch), rng)
    traced = {}
    for impl in ("xla", "flash"):
        with JA.attention_impl(impl):
            traced[impl] = str(jax.make_jaxpr(ref.trainer._loss)(*args))
    assert traced["xla"] == traced["flash"]
    with JA.attention_impl("flash"):
        (want_loss, _), want_g = ref.loss_and_grads(batch, rng)
    trainers = {}
    for impl in ("xla", "flash"):
        trainers[impl] = tr = Trainer(port_train_cfg(jax_cfg(impl)), device="cpu")
        load_train_state(tr, ref.state)
        loss, _, grads = tr.loss_and_grads(port_batch(batch), jax_draws(ref.cfg, rng))
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5, err_msg=impl)
        assert_tree_close(grads, want_g)
    before = {k: p.detach().clone() for k, p in trainers["xla"].train_params.items()}
    for i in range(2):
        batch, rng = make_train_batch(152 + i), jax.random.PRNGKey(160 + i)
        with JA.attention_impl("flash"):
            want = ref.step(batch, rng)
        for impl, tr in trainers.items():
            got = tr.train_step(port_batch(batch), jax_draws(ref.cfg, rng))
            np.testing.assert_allclose(float(got["loss"]), want, rtol=1e-5, err_msg=impl)
    want_p = to_port(ref.state.train_params)
    for impl, tr in trainers.items():
        for k, p in tr.train_params.items():
            np.testing.assert_allclose((p.detach() - before[k]).numpy(),
                                       (want_p[k] - before[k]).numpy(), atol=0.02 * LR,
                                       err_msg=f"{impl} {k}")


# --------------------------------------------------------------------------
# launch plans under the override (counted calls on the CPU)
# --------------------------------------------------------------------------


@pytest.fixture()
def counted(monkeypatch):
    """Count each kernel wrapper and autograd-Function call by (mode, B,
    S_q, S_kv, D), where the card launches the kernels."""
    from magicdance_tpu_torch.ops.kernels import flash_vjp as V

    calls = Counter()

    def counting(mod, name, key):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            calls[key(a, kw)] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    def k(mode, q, skv):
        return (mode, q.shape[0], q.shape[1], skv, q.shape[3])

    def dq(a, kw):
        kb = a[7] if len(a) > 7 else kw.get("k_bank")
        two = kb is not None
        return k("attention_dq_two_source" if two else "attention_dq", a[0],
                 a[1].shape[1] + (kb.shape[1] if two else 0))

    counting(V, "self_attention_lse", lambda a, kw: k("self_attention_lse", a[0], a[1].shape[1]))
    counting(V, "two_source_attention_lse", lambda a, kw: k(
        "two_source_attention_lse", a[0], a[1].shape[1] + a[3].shape[1]))
    counting(V, "attention_dq", dq)
    counting(V, "attention_dkv", lambda a, kw: k("attention_dkv", a[2], a[0].shape[1]))
    counting(TA, "self_attention", lambda a, kw: k("self_attention", a[0], a[1].shape[1]))
    counting(TA, "two_source_attention", lambda a, kw: k(
        "two_source_attention", a[0], a[1].shape[1] + a[3].shape[1]))
    counting(TA, "grouped_attention", lambda a, kw: ("grouped",))
    counting(V, "grouped_attention", lambda a, kw: ("grouped",))
    return calls


def tiny_cfg(impl, temporal=False):
    jc = jax_train_cfg(attention_impl=impl)
    cfg = port_train_cfg(jc)
    if temporal:
        m = cfg.model
        cfg = dataclasses.replace(
            cfg, freeze=C.FreezeRegime.MOTION_ONLY, video_frames=4,
            model=dataclasses.replace(m, variant=C.ModelVariant.APPEARANCE_POSE_TEMPORAL,
                                      unet=dataclasses.replace(m.unet, use_motion_modules=True,
                                                               motion_num_heads=2)))
    return cfg


def step_batch(images, refs, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"image": torch.rand(images, 16, 16, 3, generator=g) * 2 - 1,
            "reference": torch.rand(refs, 16, 16, 3, generator=g) * 2 - 1,
            "pose": torch.rand(images, 64, 64, 3, generator=g),
            "input_ids": torch.zeros(images, 5, dtype=torch.long)}


@pytest.mark.parametrize("temporal", [False, True], ids=["stage2", "stage3"])
def test_flash_launch_plan_matches_counted_calls(counted, temporal):
    import chip_smoke

    cfg = tiny_cfg("flash", temporal)
    tr = Trainer(cfg, device="cpu")
    tr.init_random(seed=0, scale=0.1)
    tr.train_step(step_batch(4, 1) if temporal else step_batch(2, 2))
    plan = chip_smoke.flash_launch_plan(cfg, 8, 1 if temporal else 2)
    assert dict(counted) == dict(plan)
    totals = chip_smoke.plan_totals(plan)
    assert "grouped" not in counted and totals["attention_dq"] and totals["attention_dkv"]
    if temporal:  # frozen branches and the sites before the first motion module
        assert totals["self_attention"] and totals["two_source_attention"]


@pytest.mark.parametrize("temporal", [False, True], ids=["stage2", "stage3"])
def test_xla_launches_nothing(counted, temporal):
    tr = Trainer(tiny_cfg("xla", temporal), device="cpu")
    tr.init_random(seed=0, scale=0.1)
    m = tr.train_step(step_batch(4, 1) if temporal else step_batch(2, 2))
    assert torch.isfinite(m["loss"]) and not counted


def test_disable_grouped_switch_in_a_stage3_step(counted, monkeypatch):
    """Under "auto" the tiny stage-3 step's motion sites (4 frames over 64
    positions) take the grouped kernel; with MD_DISABLE_GROUPED_ATTN=1 they
    take the plain math (below the kernel threshold), as in JAX."""
    tr = Trainer(tiny_cfg("auto", temporal=True), device="cpu")
    tr.init_random(seed=0, scale=0.1)
    batch = step_batch(4, 1)
    draws = tr.draw(batch)
    base = tr.loss_and_grads(batch, draws)[0]
    assert counted[("grouped",)] > 0
    counted.clear()
    monkeypatch.setenv("MD_DISABLE_GROUPED_ATTN", "1")
    off = tr.loss_and_grads(batch, draws)[0]
    assert not counted
    np.testing.assert_allclose(float(off), float(base), rtol=1e-5)


def test_remat_recompute_keeps_the_override_off_the_calling_thread():
    """On a GPU the backward pass, and so remat's recompute, runs on
    autograd's device thread, which does not see the caller's context: the
    recompute must still route as the forward did under "flash". A backward
    started from another thread shows it on the CPU; the gradients equal
    those of a backward on the calling thread."""
    import threading

    from magicdance_tpu_torch.ops.attention import attention_impl

    tr = Trainer(tiny_cfg("flash"), device="cpu")
    tr.init_random(seed=0, scale=0.1)
    batch = step_batch(2, 2)
    draws = tr.draw(batch)
    grads = []
    for elsewhere in (False, True):
        for p in tr.train_params.values():
            p.grad = None
        lat = tr.encode(batch, draws)
        with attention_impl("flash"):
            loss = tr.loss_from_latents(*lat, batch, draws)[0]
            if not elsewhere:
                loss.backward()
        if elsewhere:
            errors = []

            def backward():
                try:
                    loss.backward()
                except Exception as e:  # noqa: BLE001 (re-raised below)
                    errors.append(e)
            t = threading.Thread(target=backward)
            t.start()
            t.join()
            assert not errors, errors[0]
        grads.append({k: p.grad.clone() for k, p in tr.train_params.items()
                      if p.grad is not None})
    assert grads[0].keys() == grads[1].keys() and grads[0]
    for k, g in grads[0].items():
        assert torch.equal(g, grads[1][k]), k
