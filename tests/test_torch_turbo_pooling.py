"""The image sampler's pooling levers in the port against the JAX package at
the tiny config with attention at its first level (`micro_model_cfg_jax`):
`downsample_bank` on a real bank, the self-KV pooling of the composite model
on a non-square latent (token order, F = 2 frames), and `ddim_sample` with
`bank_downsample` and with
`self_kv_downsample` alone, with the same weights (every leaf random) and
the same numpy inputs. The pooling thresholds are lowered to the 64-token
first level, the counterpart of the 4096-token sites at full size.
Tolerances: 5e-4 abs/rel for one network pass (tests/test_torch_models.py),
2e-3 for sampled latents (tests/test_torch_pipeline.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicdance_tpu.sampling.ddim import downsample_bank as j_downsample_bank
from magicdance_tpu_torch.sampling.ddim import downsample_bank
from torch_port_util import (
    assert_close,
    make_pipelines,
    micro_model_cfg_jax,
    np_rand,
    sample_both,
    to_t,
)
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

NET_TOL = dict(atol=5e-4, rtol=5e-4)
POOL = dict(bank_downsample_min_seq=64, self_kv_min_seq=64)
INPUTS = dict(x_T=np.broadcast_to(np_rand((1, 8, 8, 4), 60), (2, 8, 8, 4)).copy(),
              ctx=np_rand((1, 77, 16), 61), uctx=np_rand((1, 77, 16), 62),
              ref=np_rand((1, 8, 8, 4), 63), hint=np_rand((2, 64, 64, 3), 64, 0.0, 1.0))


@pytest.fixture(scope="module")
def pipelines():
    return make_pipelines(micro_model_cfg_jax())


def test_downsample_bank_matches_jax(pipelines):
    """A real bank (tokens as the write pass orders them) pooled 2x2 and 4x4
    over its 8x8 site; the 4x4 sites and a non-square entry pass exact."""
    jp, tp = pipelines
    jm = jp.model
    ref, t, ctx = np_rand((1, 8, 8, 4), 1), np.array([300]), np_rand((1, 77, 16), 2)
    jbank = jax.jit(lambda p, r, tt, c: jm.apply(p, r, tt, c, method=jm.compute_bank))(
        jp.params["model"], jnp.asarray(ref), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        tbank = tp.model.compute_bank(to_t(ref), torch.tensor(t), to_t(ctx))
    odd = np_rand((2, 24, 8), 3)
    for factor, min_seq in ((2, 16), (4, 64), (2, 4096)):
        want = j_downsample_bank(tuple(jbank) + (jnp.asarray(odd),), factor, min_seq)
        got = downsample_bank(tuple(tbank) + (to_t(odd),), factor, min_seq)
        assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
        for g, w in zip(got, want):
            assert_close(g, w, **NET_TOL)
    assert downsample_bank(tbank, 1) is tbank and downsample_bank(None, 2) is None


def test_self_kv_pool_matches_jax_on_a_non_square_latent(pipelines):
    """The composite (bank read, ControlNet) with self keys/values pooled 2x2
    at its 8x16 sites, F = 2 frames: a wrong token order changes the pooled
    keys."""
    jp, tp = pipelines
    jm = jp.model
    x, t = np_rand((2, 8, 16, 4), 10), np.array([400, 400])
    ctx, ref = np_rand((2, 77, 16), 11), np_rand((1, 8, 16, 4), 12)
    hint = np_rand((2, 64, 128, 3), 13, 0.0, 1.0)

    def jax_eps(p, x_, t_, c_, r_, h_):
        bank = jm.apply(p, r_, t_[:1], c_[:1], method=jm.compute_bank)
        return jm.apply(p, x_, t_, c_, bank=bank, pose_hint=h_, self_kv_pool=2,
                        self_kv_min_seq=16)

    want = jax.jit(jax_eps)(jp.params["model"], *(jnp.asarray(a) for a in (x, t, ctx, ref, hint)))
    m = tp.model
    with torch.no_grad():
        bank = m.compute_bank(to_t(ref), torch.tensor(t[:1]), to_t(ctx[:1]))
        got = m(to_t(x), torch.tensor(t), to_t(ctx), bank=bank, pose_hint=to_t(hint),
                self_kv_pool=2, self_kv_min_seq=16)
        exact = m(to_t(x), torch.tensor(t), to_t(ctx), bank=bank, pose_hint=to_t(hint))
    assert_close(got, want, **NET_TOL)
    assert float((got - exact).abs().max()) > 1e-3  # the pooling did something


@pytest.mark.parametrize("kw", [dict(bank_downsample=2, **POOL),
                                dict(self_kv_downsample=2, **POOL)],
                         ids=["bank_downsample", "self_kv_downsample"])
def test_ddim_sample_one_lever_matches_jax(pipelines, kw):
    jp, tp = pipelines
    got, want = sample_both(jp, tp, 4, INPUTS, **kw)
    assert got.shape == (2, 8, 8, 4)
    assert_close(got, want, atol=2e-3, rtol=2e-3)
