"""DeepCache in the port against the JAX package, on a three-level tiny
config (channel_mult (1, 2, 2)) so that both split points exist: the deep
feature `collect_deep` returns and the shallow pass fed a cached feature
(`deep_cache_in`, bank slicing, the 13 residual indices), at deep_level 0 and
1; the identity that a shallow pass fed the deep feature of the same (x, t)
reproduces the full forward (models/unet.py:188-190 in JAX); and
`ddim_sample` with `deepcache_every` at `deepcache_level=1`, cond and uncond
caches. Same weights (every leaf random) and numpy inputs on both sides.
Tolerances: 5e-4 abs/rel for one network pass (tests/test_torch_models.py),
1e-6 for the port's own identity (the same arithmetic, reordered calls),
2e-3 for sampled latents (tests/test_torch_pipeline.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (
    assert_close,
    make_pipelines,
    np_rand,
    sample_both,
    tiny_model_cfg_jax,
    to_t,
)
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

NET_TOL = dict(atol=5e-4, rtol=5e-4)


def three_level_cfg():
    cfg = tiny_model_cfg_jax()
    return dataclasses.replace(
        cfg, unet=dataclasses.replace(cfg.unet, channel_mult=(1, 2, 2)),
        pose_control=dataclasses.replace(cfg.pose_control, channel_mult=(1, 2, 2)))


@pytest.fixture(scope="module")
def pipelines():
    return make_pipelines(three_level_cfg())


X, T = np_rand((2, 8, 8, 4), 0), np.array([640, 640])
CTX, REF = np_rand((2, 77, 16), 1), np_rand((1, 8, 8, 4), 2)
HINT = np_rand((2, 64, 64, 3), 3, 0.0, 1.0)


def _port(tp, level, uc=False, deep_in=None):
    m = tp.model
    with torch.no_grad():
        kw = dict(uc=True) if uc else dict(
            bank=m.compute_bank(to_t(REF), torch.tensor(T[:1]), to_t(CTX[:1])),
            pose_hint=to_t(HINT))
        if deep_in is None:
            return m(to_t(X), torch.tensor(T), to_t(CTX), collect_deep=True, deep_level=level,
                     **kw)
        return m(to_t(X), torch.tensor(T), to_t(CTX), deep_cache_in=deep_in, deep_level=level,
                 **kw)


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("uc", [False, True], ids=["cond", "uncond"])
def test_shallow_pass_reproduces_the_full_forward(pipelines, level, uc):
    _, tp = pipelines
    eps, deep = _port(tp, level, uc)
    with torch.no_grad():
        plain = (tp.model(to_t(X), torch.tensor(T), to_t(CTX), uc=True) if uc else None)
    assert_close(_port(tp, level, uc, deep_in=deep), eps.numpy(), atol=1e-6, rtol=1e-6)
    if plain is not None:  # collect_deep leaves the output as it was
        assert_close(eps, plain.numpy(), atol=1e-6, rtol=1e-6)
    # the deep feature enters the decoder's level `level` (upsampled to it)
    assert deep.shape[2:] == (8 // 2 ** level,) * 2


def test_deep_feature_and_shallow_pass_match_jax(pipelines):
    """At the second split point (deep_level 1; the first is held to JAX
    through the sampler, tests/test_torch_turbo_reuse.py): JAX's deep feature
    (NHWC) against the port's (NCHW), and both shallow passes fed the same
    perturbed feature (so the cached input, not the shallow levels alone,
    must agree)."""
    level = 1
    jp, tp = pipelines
    jm = jp.model
    j_in = [jnp.asarray(a) for a in (X, T, CTX, REF, HINT)]

    def jax_pass(p, x, t, c, r, h, deep_in):
        bank = jm.apply(p, r, t[:1], c[:1], method=jm.compute_bank)
        full = jm.apply(p, x, t, c, bank=bank, pose_hint=h, collect_deep=True, deep_level=level)
        shallow = jm.apply(p, x, t, c, bank=bank, pose_hint=h, deep_cache_in=deep_in,
                           deep_level=level)
        return full, shallow

    eps, deep = _port(tp, level)
    noise = 0.1 * np_rand(tuple(deep.permute(0, 2, 3, 1).shape), 4)
    deep_in = deep.permute(0, 2, 3, 1).numpy() + noise
    (j_eps, j_deep), j_shallow = jax.jit(jax_pass)(jp.params["model"], *j_in,
                                                    jnp.asarray(deep_in))
    assert_close(eps, j_eps, **NET_TOL)
    assert_close(deep.permute(0, 2, 3, 1), j_deep, **NET_TOL)
    got = _port(tp, level, deep_in=to_t(deep_in).permute(0, 3, 1, 2))
    assert_close(got, j_shallow, **NET_TOL)
    assert float(np.abs(np.asarray(j_shallow) - np.asarray(j_eps)).max()) > 1e-3


def test_ddim_sample_deepcache_level1_matches_jax(pipelines):
    jp, tp = pipelines
    inputs = dict(x_T=X, ctx=CTX[:1], uctx=np_rand((1, 77, 16), 5), ref=REF, hint=HINT)
    got, want = sample_both(jp, tp, 4, inputs, deepcache_every=2, deepcache_level=1,
                            uncond_every=2)
    assert_close(got, want, atol=2e-3, rtol=2e-3)


def test_deepcache_arguments_are_checked(pipelines):
    _, tp = pipelines
    m, x, t, c = tp.model, to_t(X), torch.tensor(T), to_t(CTX)
    with torch.no_grad():
        with pytest.raises(ValueError, match="deep_level"):
            m(x, t, c, uc=True, collect_deep=True, deep_level=2)
        deep = m(x, t, c, uc=True, collect_deep=True)[1]
        with pytest.raises(ValueError, match="shallow"):
            m.unet(x, t, c, deep_cache_in=deep, collect_deep=True)
        with pytest.raises(ValueError, match="shallow"):
            m.unet(x, t, c, deep_cache_in=deep, collect_bank=True)
