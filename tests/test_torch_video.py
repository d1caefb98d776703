"""The port's video path against the JAX package at the tiny temporal config:
`window_starts`, the exact overlap-window sampler `ddim_sample_video`
(F = 10 frames, windows of 4, stride 3: overlapping, rotated windows, as
tests/test_sampling.py) and `MagicPosePipeline.sample_frames(video=True)`
against the JAX pipeline. The per-step window offsets are JAX's, replayed
from the key the JAX sampler receives. Same weights (every leaf random,
through convert.from_jax) and the same numpy inputs. Tolerance 2e-3 abs/rel,
the image sampler's (tests/test_torch_pipeline.py): CFG 7 amplifies the
~1e-6 per-pass fp32 differences at every step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magicdance_tpu.config as jcfg
import magicdance_tpu_torch.config as tcfg
from magicdance_tpu.ops import schedules as js
from magicdance_tpu.sampling.overlap import ddim_sample_video as j_video
from magicdance_tpu.sampling.overlap import window_starts as j_starts
from magicdance_tpu_torch.ops import schedules as ts
from magicdance_tpu_torch.parallel.mesh import MeshAxis
from magicdance_tpu_torch.sampling.overlap import ddim_sample_video, window_starts
from torch_port_util import (
    assert_close,
    make_pipelines,
    np_rand,
    port_cfg,
    tiny_temporal_cfg_jax,
    to_t,
)
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

TOL = dict(atol=2e-3, rtol=2e-3)
F, W, STRIDE = 10, 4, 3


def jax_offsets(rng, steps: int, frames: int) -> list[int]:
    """The offsets `ddim_sample_video` draws from `rng`, step by step."""
    out = []
    for _ in range(steps):
        rng, rng_off, _, _ = jax.random.split(rng, 4)
        out.append(int(jax.random.randint(rng_off, (), 0, frames)))
    return out


def test_window_starts_match_jax():
    for frames in (1, 4, 10, 16, 17, 40, 64):
        for window, stride in ((4, 3), (16, 12), (16, 16), (8, 5)):
            np.testing.assert_array_equal(window_starts(frames, window, stride),
                                          j_starts(frames, window, stride))


@pytest.fixture(scope="module")
def pipelines():
    return make_pipelines(tiny_temporal_cfg_jax())


def test_ddim_sample_video_matches_jax(pipelines):
    """3 DDIM steps, CFG 7, a reference bank and pose hints, on the latents."""
    jp, tp = pipelines
    steps = 3
    scfg_j = jcfg.SampleConfig(steps=steps, window=W, stride=STRIDE)
    scfg_t = tcfg.SampleConfig(steps=steps, window=W, stride=STRIDE)
    x_T = np_rand((F, 8, 8, 4), 1)
    ctx, uctx = np_rand((1, 77, 16), 2), np_rand((1, 77, 16), 3)
    ref, hint = np_rand((1, 8, 8, 4), 4), np_rand((F, 64, 64, 3), 5, 0.0, 1.0)
    rng = jax.random.PRNGKey(6)
    want = j_video(jp.model, jp.params["model"], jp.sched, js.make_ddim_schedule(jp.sched, steps),
                   scfg_j, rng, jnp.asarray(x_T), jnp.asarray(ctx), jnp.asarray(uctx),
                   reference_latent=jnp.asarray(ref), pose_hint=jnp.asarray(hint))
    offsets = jax_offsets(rng, steps, F)
    got = ddim_sample_video(tp.model, tp.sched, ts.make_ddim_schedule(tp.sched, steps), scfg_t,
                            to_t(x_T), to_t(ctx), to_t(uctx), reference_latent=to_t(ref),
                            pose_hint=to_t(hint), window_offsets=offsets)
    assert got.shape == (F, 8, 8, 4)
    assert_close(got, want, **TOL)


def test_sample_frames_video_matches_jax_pipeline(pipelines):
    """The whole request (CLIP, reference encode, overlap sampling, decode in
    chunks of 8) against the JAX pipeline's, 2 steps, shared x_T."""
    jp, tp = pipelines
    scfg_j = jcfg.SampleConfig(steps=2, window=W, stride=STRIDE)
    scfg_t = tcfg.SampleConfig(steps=2, window=W, stride=STRIDE)
    pose = np_rand((F, 64, 64, 3), 10, 0.0, 1.0)
    ref = np_rand((1, 64, 64, 3), 11, -1.0, 1.0)
    rng = jax.random.PRNGKey(12)
    want = jp.sample_frames(rng, jnp.asarray(pose), jnp.asarray(ref), scfg_j, video=True)
    rng_noise, rng_sampler = jax.random.split(rng)
    x_T = np.broadcast_to(np.asarray(jax.random.normal(rng_noise, (1, 8, 8, 4))),
                          (F, 8, 8, 4)).copy()
    got = tp.sample_frames(to_t(pose), to_t(ref), scfg_t, video=True, x_T=to_t(x_T),
                           window_offsets=jax_offsets(rng_sampler, 2, F))
    assert got.shape == (F, 64, 64, 3)
    assert_close(got, want, **TOL)


def test_video_offsets_rotate_even_one_window(pipelines):
    """With F <= window there is one window, but the offset still permutes
    its frames (the frame PE makes that matter); offsets drawn from a
    generator are reproducible."""
    _, tp = pipelines
    scfg = tcfg.SampleConfig(steps=2, window=W, stride=STRIDE)
    pose = to_t(np_rand((W, 64, 64, 3), 20, 0.0, 1.0))
    ref = to_t(np_rand((1, 64, 64, 3), 21, -1.0, 1.0))
    x_T = to_t(np_rand((W, 8, 8, 4), 22))

    def run(**kw):
        return tp.sample_frames(pose, ref, scfg, decode=False, video=True, x_T=x_T, **kw)

    a, b = run(window_offsets=[0, 0]), run(window_offsets=[1, 3])
    assert not torch.allclose(a, b, atol=1e-4)
    g1, g2 = run(generator=torch.Generator().manual_seed(5)), run(
        generator=torch.Generator().manual_seed(5))
    assert torch.equal(g1, g2)
    # a temporal pipeline asked for images runs the image sampler, F = 1 clips
    img = tp.sample_frames(pose, ref, scfg, decode=False, video=False, x_T=x_T)
    assert img.shape == (W, 8, 8, 4) and not torch.allclose(img, a, atol=1e-4)


def test_video_sampler_refuses_what_is_not_ported(pipelines):
    _, tp = pipelines
    ddim = ts.make_ddim_schedule(tp.sched, 2)
    x = torch.zeros(F, 8, 8, 4)
    ctx = torch.zeros(1, 77, 16)
    two_ranks = MeshAxis.single()
    two_ranks.size = 2  # one window of 16 frames cannot cover two ranks
    for scfg, kw in ((tcfg.SampleConfig(steps=2, deepcache_every=2),
                      {"window_sharding": two_ranks}),
                     (tcfg.SampleConfig(steps=2), {"window_sharding": two_ranks}),
                     (tcfg.SampleConfig(steps=2), {"window_offsets": [0]})):
        with pytest.raises((NotImplementedError, ValueError)):
            ddim_sample_video(tp.model, tp.sched, ddim, scfg, x, ctx, **kw)
    img_cfg = dataclasses.replace(port_cfg(tiny_temporal_cfg_jax()),
                                  variant=tcfg.ModelVariant.APPEARANCE_POSE)
    assert not img_cfg.has_temporal
