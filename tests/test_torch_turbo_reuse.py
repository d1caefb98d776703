"""The image sampler's cache-reuse levers in the port against JAX's
`ddim_sample`, each alone, at the tiny config with attention at its first
level (`micro_model_cfg_jax`): `deepcache_every` (cond and uncond DeepCache)
and `bank_every`, with the same weights (every leaf random) and the same
numpy inputs. 4 DDIM steps: every stride reuses at least once. Tolerance
2e-3 abs/rel on the latents (CFG 7 amplifies the per-pass fp32 differences,
tests/test_torch_pipeline.py)."""

import numpy as np
import pytest

from torch_port_util import assert_close, make_pipelines, micro_model_cfg_jax, np_rand, sample_both
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

TOL = dict(atol=2e-3, rtol=2e-3)
INPUTS = dict(x_T=np.broadcast_to(np_rand((1, 8, 8, 4), 40), (2, 8, 8, 4)).copy(),
              ctx=np_rand((1, 77, 16), 41), uctx=np_rand((1, 77, 16), 42),
              ref=np_rand((1, 8, 8, 4), 43), hint=np_rand((2, 64, 64, 3), 44, 0.0, 1.0))


@pytest.fixture(scope="module")
def pipelines():
    return make_pipelines(micro_model_cfg_jax())


@pytest.mark.parametrize("kw", [dict(deepcache_every=3), dict(bank_every=3)],
                         ids=["deepcache_every", "bank_every"])
def test_ddim_sample_one_lever_matches_jax(pipelines, kw):
    jp, tp = pipelines
    got, want = sample_both(jp, tp, 4, INPUTS, **kw)
    assert got.shape == (2, 8, 8, 4)
    assert_close(got, want, **TOL)
