"""The window-parallel video sampler across two processes (gloo on the CPU),
as tests/test_sharded_inference.py shards the JAX package's windows.

`ddim_sample_video(window_sharding=)` on two ranks at the tiny temporal
config: F = 8 frames in windows of 4, stride 2 (four windows, two a rank),
3 DDIM steps, CFG 7, the exact recipe and the `turbo` stack of
tests/test_torch_turbo_video.py (its frame-space caches of the uncond eps,
the pose residuals and the DeepCache features are all-reduced too), with
JAX's per-step window offsets, against JAX's single-device
`ddim_sample_video` within 1e-4, and against the port's one-process run
within 1e-4.
"""

import jax
import numpy as np
import pytest

import magicdance_tpu_torch.config as tcfg
from magicdance_tpu_torch.ops import schedules as ts
from magicdance_tpu_torch.sampling.overlap import ddim_sample_video
from torch_port_util import (
    Ranks,
    make_pipelines,
    np_rand,
    sample_both,
    tiny_temporal_cfg_jax,
    to_t,
)
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

F, W, STRIDE, STEPS = 8, 4, 2, 3
TOL = dict(atol=1e-4, rtol=1e-4)
TURBO = dict(deepcache_every=3, pose_every=3, uncond_every=2, cfg_interval=(0.15, 0.85),
             bank_every=3, bank_downsample=2, self_kv_downsample=2,
             bank_downsample_min_seq=64, self_kv_min_seq=64)
INPUTS = dict(x_T=np_rand((F, 8, 8, 4), 1), ctx=np_rand((1, 77, 16), 2),
              uctx=np_rand((1, 77, 16), 3), ref=np_rand((1, 8, 8, 4), 4),
              hint=np_rand((F, 64, 64, 3), 5, 0.0, 1.0))
RECIPES = {"exact": {}, "turbo": TURBO}


def jax_offsets(steps: int, frames: int) -> list[int]:
    """The offsets JAX's `ddim_sample_video` draws from sample_both's key."""
    rng, out = jax.random.PRNGKey(6), []
    for _ in range(steps):
        rng, rng_off, _, _ = jax.random.split(rng, 4)
        out.append(int(jax.random.randint(rng_off, (), 0, frames)))
    return out


@pytest.fixture(scope="module")
def sampled(tmp_path_factory):
    jp, tp = make_pipelines(tiny_temporal_cfg_jax())
    offsets = jax_offsets(STEPS, F)
    jobs = [dict(kind="video", name=name, cfg=tcfg.to_dict(tp.cfg),
                 weights=tp.model.state_dict(),
                 scfg=tcfg.to_dict(tcfg.SampleConfig(steps=STEPS, window=W, stride=STRIDE,
                                                     **kw)),
                 x_T=to_t(INPUTS["x_T"]), ctx=to_t(INPUTS["ctx"]), uctx=to_t(INPUTS["uctx"]),
                 ref=to_t(INPUTS["ref"]), hint=to_t(INPUTS["hint"]), offsets=offsets)
            for name, kw in RECIPES.items()]
    ranks = Ranks(tmp_path_factory.mktemp("video"), jobs)
    one, want = {}, {}
    for name, kw in RECIPES.items():
        one[name], want[name] = sample_both(jp, tp, STEPS, INPUTS, video=True, window=W,
                                            stride=STRIDE, **kw)
    return ranks.join(), want, one


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_window_parallel_video_matches_jax_single_device(sampled, recipe):
    out, want, _ = sampled
    for r in range(2):
        got = out[r][recipe]["out"]
        assert got.shape == (F, 8, 8, 4)
        np.testing.assert_allclose(got.numpy(), want[recipe], **TOL)


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_window_parallel_video_matches_one_process(sampled, recipe):
    out, _, one = sampled
    for r in range(2):
        np.testing.assert_allclose(out[r][recipe]["out"].numpy(), one[recipe].numpy(), **TOL)


def test_window_sharding_needs_a_window_per_rank():
    """Fewer windows than ranks: the sampler refuses before any pass."""
    from magicdance_tpu_torch.parallel.mesh import MeshAxis

    axis = MeshAxis.single()
    axis.size = 2
    sched = ts.make_schedule(tcfg.DiffusionConfig())
    with pytest.raises(ValueError, match="cannot cover 2 ranks"):
        ddim_sample_video(None, sched, ts.make_ddim_schedule(sched, 2),
                          tcfg.SampleConfig(steps=2, window=16), to_t(INPUTS["x_T"]),
                          to_t(INPUTS["ctx"]), window_sharding=axis)
