"""The image sampler's turbo levers in the port against the JAX package at the
tiny config with attention at its first level (`micro_model_cfg_jax`): the
host masks `build_turbo_schedules` (equal arrays over a grid of strides,
intervals and endpoint settings) and `ddim_sample` with each of
`cfg_interval`, `uncond_every` and `pose_every` alone (the other levers:
tests/test_torch_turbo_reuse.py, test_torch_turbo_pooling.py), with the
same weights (every leaf random) and the same numpy inputs. 4 DDIM steps:
every stride reuses at least once.
Tolerance 2e-3 abs/rel for sampled latents (CFG 7 amplifies the per-pass
fp32 differences, tests/test_torch_pipeline.py); the masks are equal."""

import itertools

import numpy as np
import pytest

import magicdance_tpu.config as jcfg
import magicdance_tpu_torch.config as tcfg
from magicdance_tpu.sampling.ddim import build_turbo_schedules as j_schedules
from magicdance_tpu_torch.sampling.ddim import build_turbo_schedules
from torch_port_util import (
    assert_close,
    make_pipelines,
    micro_model_cfg_jax,
    np_rand,
    sample_both,
)
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

SAMPLE_TOL = dict(atol=2e-3, rtol=2e-3)


def test_build_turbo_schedules_equal_jax():
    """All six mask arrays, over strides, CFG intervals, endpoint settings,
    step counts and with and without CFG."""
    timesteps = {s: np.linspace(981, 1, s).round().astype(np.int64) for s in (4, 7, 20, 50)}
    grid = itertools.product((1, 2, 3), (1, 2, 5), (1, 3, 4), (None, (0.15, 0.85), (0.5, 1.0)),
                             ((0, 0), (2, 2), (1, 0)))
    n = 0
    for (uncond, deep, pose, interval, (first, last)), (s, ts_), use_cfg in itertools.product(
            grid, timesteps.items(), (True, False)):
        kw = dict(uncond_every=uncond, deepcache_every=deep, pose_every=pose, bank_every=deep + 1,
                  cfg_interval=interval, reuse_exact_first=first, reuse_exact_last=last)
        want = j_schedules(jcfg.SampleConfig(**kw), 1000, ts_, use_cfg)
        got = build_turbo_schedules(tcfg.SampleConfig(**kw), 1000, ts_, use_cfg)
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g, w)
        n += 1
    assert n == 3 * 3 * 3 * 3 * 3 * 4 * 2


@pytest.fixture(scope="module")
def pipelines():
    return make_pipelines(micro_model_cfg_jax())


INPUTS = dict(x_T=np.broadcast_to(np_rand((1, 8, 8, 4), 20), (2, 8, 8, 4)).copy(),
              ctx=np_rand((1, 77, 16), 21), uctx=np_rand((1, 77, 16), 22),
              ref=np_rand((1, 8, 8, 4), 23), hint=np_rand((2, 64, 64, 3), 24, 0.0, 1.0))


@pytest.mark.parametrize("lever", [dict(cfg_interval=(0.3, 0.8)), dict(uncond_every=2),
                                   dict(pose_every=3)],
                         ids=["cfg_interval", "uncond_every", "pose_every"])
def test_ddim_sample_one_lever_matches_jax(pipelines, lever):
    jp, tp = pipelines
    got, want = sample_both(jp, tp, 4, INPUTS, **lever)
    assert got.shape == (2, 8, 8, 4)
    assert_close(got, want, **SAMPLE_TOL)
