"""The overlap-window (video) sampler's turbo path in the port against the JAX
package at the tiny temporal config: `ddim_sample_video` under bench.py's
`turbo` stack (frame-space caches of the uncond eps, the pose residuals and
the DeepCache features, gathered back through each step's rotated windows),
F = 10 frames in windows of 4, stride 3, 4 steps, JAX's window offsets
replayed. The pooling thresholds are lowered to the tiny model's 64-token
first level. Same weights (every leaf random) and numpy inputs. Tolerance
2e-3 abs/rel on the latents (tests/test_torch_video.py's)."""

import numpy as np
import pytest
import torch

import magicdance_tpu_torch.config as tcfg
from magicdance_tpu_torch.ops import schedules as ts
from magicdance_tpu_torch.parallel.mesh import MeshAxis
from magicdance_tpu_torch.sampling.overlap import ddim_sample_video
from torch_port_util import (
    assert_close,
    make_pipelines,
    np_rand,
    sample_both,
    tiny_temporal_cfg_jax,
    to_t,
)
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

F, W, STRIDE = 10, 4, 3
TURBO = dict(deepcache_every=3, pose_every=3, uncond_every=2, cfg_interval=(0.15, 0.85),
             bank_every=3, bank_downsample=2, self_kv_downsample=2,
             bank_downsample_min_seq=64, self_kv_min_seq=64)
INPUTS = dict(x_T=np_rand((F, 8, 8, 4), 1), ctx=np_rand((1, 77, 16), 2),
              uctx=np_rand((1, 77, 16), 3), ref=np_rand((1, 8, 8, 4), 4),
              hint=np_rand((F, 64, 64, 3), 5, 0.0, 1.0))


@pytest.fixture(scope="module")
def pipelines():
    return make_pipelines(tiny_temporal_cfg_jax())


def test_ddim_sample_video_turbo_matches_jax(pipelines):
    jp, tp = pipelines
    got, want = sample_both(jp, tp, 4, INPUTS, video=True, window=W, stride=STRIDE, **TURBO)
    assert got.shape == (F, 8, 8, 4)
    assert_close(got, want, atol=2e-3, rtol=2e-3)


def test_video_turbo_quirks(pipelines):
    """As in JAX: fused_cfg does nothing on the video path (no refusal, also
    with self-KV pooling); window_sharding over more ranks than windows
    raises."""
    _, tp = pipelines
    ddim = ts.make_ddim_schedule(tp.sched, 2)
    kw = dict(reference_latent=to_t(INPUTS["ref"]), pose_hint=to_t(INPUTS["hint"]),
              window_offsets=[3, 8])

    def run(**s):
        return ddim_sample_video(tp.model, tp.sched, ddim, tcfg.SampleConfig(
            steps=2, window=W, stride=STRIDE, **s), to_t(INPUTS["x_T"]), to_t(INPUTS["ctx"]),
            to_t(INPUTS["uctx"]), **kw)

    base = run(uncond_every=2, self_kv_downsample=2, self_kv_min_seq=64)
    assert torch.equal(run(uncond_every=2, self_kv_downsample=2, self_kv_min_seq=64,
                           fused_cfg=True), base)
    assert not torch.allclose(run(), base, atol=1e-4)
    five_ranks = MeshAxis.single()
    five_ranks.size = 5  # F = 10 in windows of 4, stride 3: four windows
    with pytest.raises(ValueError, match="cannot cover 5 ranks"):
        ddim_sample_video(tp.model, tp.sched, ddim, tcfg.SampleConfig(
            steps=2, window=W, stride=STRIDE, **TURBO), to_t(INPUTS["x_T"]),
            to_t(INPUTS["ctx"]), window_sharding=five_ranks)
    assert np.isfinite(base.numpy()).all()
