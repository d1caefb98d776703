"""The turbo stacks the JAX package's bench serves (bench.py:229-231 `turbo`,
:254-259 `turbo_max`) through the port's `ddim_sample` against JAX's, at the
tiny config with attention at its first level (`micro_model_cfg_jax`), with
the same weights (every leaf random) and the same numpy inputs. The pooling
thresholds are lowered to the 64-token first level, the counterpart of the
4096-token sites at full size. `turbo` at 4 DDIM steps, `turbo_max` at 6
(its first and last two steps are exact, so the middle two reuse).
Tolerance 2e-3 abs/rel on the latents (tests/test_torch_pipeline.py)."""

import numpy as np
import pytest

from torch_port_util import assert_close, make_pipelines, micro_model_cfg_jax, np_rand, sample_both
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

POOL = dict(bank_downsample_min_seq=64, self_kv_min_seq=64)
TURBO = dict(deepcache_every=3, pose_every=3, uncond_every=2, cfg_interval=(0.15, 0.85),
             bank_every=3, bank_downsample=2, self_kv_downsample=2, **POOL)
TURBO_MAX = dict(deepcache_every=5, pose_every=5, uncond_every=4, cfg_interval=(0.15, 0.85),
                 bank_every=8, bank_downsample=4, self_kv_downsample=4,
                 reuse_exact_first=2, reuse_exact_last=2, **POOL)
INPUTS = dict(x_T=np.broadcast_to(np_rand((1, 8, 8, 4), 50), (2, 8, 8, 4)).copy(),
              ctx=np_rand((1, 77, 16), 51), uctx=np_rand((1, 77, 16), 52),
              ref=np_rand((1, 8, 8, 4), 53), hint=np_rand((2, 64, 64, 3), 54, 0.0, 1.0))


@pytest.fixture(scope="module")
def pipelines():
    return make_pipelines(micro_model_cfg_jax())


@pytest.mark.parametrize("steps,kw", [(4, TURBO), (6, TURBO_MAX)], ids=["turbo", "turbo_max"])
def test_ddim_sample_stack_matches_jax(pipelines, steps, kw):
    jp, tp = pipelines
    got, want = sample_both(jp, tp, steps, INPUTS, **kw)
    assert got.shape == (2, 8, 8, 4)
    assert_close(got, want, atol=2e-3, rtol=2e-3)
