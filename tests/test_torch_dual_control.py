"""The DUAL_CONTROL variant of the port against the JAX package: a second
ControlNet (`image_control_model`) on an image hint whose 13 residuals sum
position by position with the pose ControlNet's. Same weights (every leaf
random, carried by `convert.from_jax`) and the same numpy inputs: the
composite forward (tests/test_misc_features.py:113), and DDIM sampling with
image hints (tests/test_sampling.py:565-644), exact and under the turbo
`pose_every` cache, which must hold the summed tuple. Tolerances: 2e-4 for
one forward, 2e-3 for CFG-7 sampling (tests/test_torch_pipeline.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magicdance_tpu.config as jcfg
import magicdance_tpu_torch.config as tcfg
from magicdance_tpu.ops import schedules as js
from magicdance_tpu.sampling.ddim import ddim_sample as j_ddim
from magicdance_tpu_torch.ops import schedules as ts
from magicdance_tpu_torch.pipeline import MagicPosePipeline
from magicdance_tpu_torch.sampling.ddim import ddim_sample
from torch_port_util import (
    assert_close,
    jit_apply,
    make_models,
    micro_model_cfg_jax,
    np_rand,
    port_cfg,
    to_t,
)
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

STEPS = 3
SAMPLE_TOL = 2e-3


def dual_cfg_jax() -> jcfg.ModelConfig:
    """The micro config on the DUAL_CONTROL variant, with its own (equal)
    image-ControlNet config."""
    c = micro_model_cfg_jax()
    return dataclasses.replace(c, variant=jcfg.ModelVariant.DUAL_CONTROL,
                               image_control=c.pose_control)


@pytest.fixture(scope="module")
def models():
    jc = dual_cfg_jax()
    jm, params, tm = make_models(jc)
    inputs = dict(x_T=np_rand((2, 8, 8, 4), 1), ctx=np_rand((1, 77, 16), 2),
                  uctx=np_rand((1, 77, 16), 3), hint=np_rand((2, 64, 64, 3), 4, 0.0, 1.0),
                  img=np_rand((2, 64, 64, 3), 5, 0.0, 1.0))
    return jc, jm, params, tm, inputs


def test_port_config_and_model(models):
    """The port builds the variant (it raised before) with the second
    ControlNet from `image_control`, which survives the JSON round trip."""
    jc, _, _, tm, _ = models
    pc = port_cfg(jc)
    assert isinstance(pc.image_control, tcfg.ControlNetConfig) and pc.has_image_control
    assert not pc.has_appearance and not hasattr(tm, "appearance_unet")
    assert tm.image_control_model.cfg == pc.image_control


def test_composition_matches_jax_and_summed_residuals(models):
    jc, jm, params, tm, inp = models
    x, hint, img = np_rand((2, 8, 8, 4), 6), inp["hint"], inp["img"]
    t = np.array([100, 500])
    ctx = np_rand((2, 77, 16), 7)
    want = jit_apply(jm)(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                         pose_hint=jnp.asarray(hint), image_hint=jnp.asarray(img))
    tx, tt, tc = to_t(x), torch.tensor(t), to_t(ctx)
    with torch.no_grad():
        both = tm(tx, tt, tc, pose_hint=to_t(hint), image_hint=to_t(img))
        assert_close(both, np.asarray(want), 2e-4, 2e-4)
        # both branches contribute
        for kw in (dict(pose_hint=to_t(hint)), dict(image_hint=to_t(img))):
            assert not torch.allclose(tm(tx, tt, tc, **kw), both, atol=1e-5)
        # the composite == the two residual tuples summed by hand
        r_pose = tm.compute_pose_residuals(tx, to_t(hint), tt, tc)
        r_img = tm.image_control_model(tx, to_t(img), tt, tc)
        summed = tuple(a + b for a, b in zip(r_pose, r_img))
        torch.testing.assert_close(tm(tx, tt, tc, pose_residuals=summed), both,
                                   atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(
            tm.compute_control_residuals(tx, to_t(hint), tt, tc, image_hint=to_t(img)), summed,
            atol=0, rtol=0)


def sample(models, scfg_kw, image=True, pose=True, jax_too=True):
    """(port, JAX or None) latents of ddim_sample with the fixture's inputs."""
    jc, jm, params, tm, inp = models
    hints = dict(pose_hint=inp["hint"] if pose else None, image_hint=inp["img"] if image else None)
    got = ddim_sample(tm, ts.make_schedule(port_cfg(jc).diffusion),
                      ts.make_ddim_schedule(ts.make_schedule(port_cfg(jc).diffusion), STEPS),
                      tcfg.SampleConfig(steps=STEPS, **scfg_kw),
                      *(to_t(inp[k]) for k in ("x_T", "ctx", "uctx")),
                      **{k: to_t(v) if v is not None else None for k, v in hints.items()})
    if not jax_too:
        return got, None
    jsched = js.make_schedule(jc.diffusion)
    jddim = js.make_ddim_schedule(jsched, STEPS)  # host arrays: the turbo masks read them
    # one compiled program (an eager call compiles each small op on its own)
    want = jax.jit(lambda p, x, c, u, h, i: j_ddim(
        jm, p, jsched, jddim,
        jcfg.SampleConfig(steps=STEPS, **scfg_kw), jax.random.PRNGKey(0), x, c, u,
        pose_hint=h, image_hint=i))(
        params, *(jnp.asarray(inp[k]) for k in ("x_T", "ctx", "uctx")),
        *(jnp.asarray(v) if v is not None else None for v in hints.values()))
    return got, np.asarray(want)


@pytest.mark.parametrize("mode", ["exact", "turbo"])
def test_sampling_matches_jax(models, mode):
    """CFG 7, pose and image hints; `turbo`: the control residuals refreshed
    every second step (the cached tuple is the sum of both ControlNets')."""
    kw = dict(pose_every=2) if mode == "turbo" else {}
    got, want = sample(models, kw)
    assert np.isfinite(want).all()
    assert_close(got, want, SAMPLE_TOL, SAMPLE_TOL)
    if mode == "turbo":
        exact, _ = sample(models, {}, jax_too=False)
        assert not torch.allclose(got, exact, atol=1e-4)


def test_sampling_branches_agree(models):
    """As the JAX test: the image branch steers the trajectory, image hints
    alone run, a residual refresh at every step equals the exact sampler,
    and fused CFG threads the image hint."""
    exact, _ = sample(models, {}, jax_too=False)
    pose_only, _ = sample(models, {}, image=False, jax_too=False)
    img_only, _ = sample(models, {}, pose=False, jax_too=False)
    assert torch.isfinite(img_only).all()
    assert not torch.allclose(exact, pose_only, atol=1e-4)
    assert not torch.allclose(exact, img_only, atol=1e-4)
    every, _ = sample(models, dict(cfg_interval=(0.0, 1.0), pose_every=1), jax_too=False)
    torch.testing.assert_close(every, exact, atol=1e-5, rtol=1e-5)
    fused, _ = sample(models, dict(fused_cfg=True), jax_too=False)
    torch.testing.assert_close(fused, exact, atol=3e-5, rtol=3e-5)


def test_pipeline_image_hints():
    """`sample_frames(image_hints=...)` on the CPU pipeline: seeded random
    weights for every module of the variant, the hints reach the sampler."""
    pipe = MagicPosePipeline(port_cfg(dual_cfg_jax()), device="cpu")
    pipe.init_params(seed=0, scale=0.1)
    g = torch.Generator().manual_seed(0)
    pose, img = torch.rand(2, 64, 64, 3, generator=g), torch.rand(2, 64, 64, 3, generator=g)
    x_T = torch.randn(2, 8, 8, 4, generator=g)
    scfg = tcfg.SampleConfig(steps=2)
    out = pipe.sample_frames(pose, None, scfg, x_T=x_T, image_hints=img, decode=False)
    ctx = pipe.encode_empty(1)
    direct = ddim_sample(pipe.model, pipe.sched, ts.make_ddim_schedule(pipe.sched, 2), scfg,
                         x_T, ctx, ctx, pose_hint=pose, image_hint=img)
    torch.testing.assert_close(out, direct, atol=0, rtol=0)
    without = pipe.sample_frames(pose, None, scfg, x_T=x_T, decode=False)
    assert not torch.allclose(out, without, atol=1e-4)
