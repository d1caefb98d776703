"""Port building blocks (magicdance_tpu_torch.models.layers) against the Flax
layers of the JAX package: same numpy inputs, the same randomised weights
carried across by convert.from_jax. fp32; tolerance 2e-4 abs/rel (the
converter oracle's, tests/test_convert.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicdance_tpu.models import layers as jl
from magicdance_tpu_torch.convert.from_jax import load_flax_params
from magicdance_tpu_torch.models import layers as tl
from torch_port_util import assert_close, np_rand, shaped_random, to_t
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

TOL = dict(atol=2e-4, rtol=2e-4)


def flax_run(module, args, seed, **kw):
    """Randomise every leaf of a Flax module's variables (shapes from
    jax.eval_shape of its init) and apply it, compiled once. Returns (numpy
    params, numpy output(s)). Arguments that are not arrays (None, flags)
    stay Python values."""
    params = shaped_random(lambda: module.init(jax.random.PRNGKey(0), *args, **kw), seed)
    dyn = [i for i, a in enumerate(args) if isinstance(a, jax.Array)]

    def apply(p, *arrays):
        full = list(args)
        for i, a in zip(dyn, arrays):
            full[i] = a
        return module.apply(p, *full, **kw)

    out = jax.jit(apply)(jax.tree.map(jnp.asarray, params), *(args[i] for i in dyn))
    return params, jax.tree.map(np.asarray, out)


def port(module, params):
    load_flax_params(module, params)
    return module.eval()


def nchw(a):
    return to_t(a).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1)


@pytest.mark.parametrize("c,eps,act", [(64, 1e-5, True), (48, 1e-6, False)])
def test_group_norm32(c, eps, act):
    """c=48 is not a multiple of 32: groups = gcd(48, 32) = 16."""
    x = np_rand((2, 4, 4, c), 0) * 3 + 1
    params, want = flax_run(jl.GroupNorm32(epsilon=eps, act=act), (jnp.asarray(x),), 1)
    mod = port(tl.GroupNorm32(c, eps=eps, act=act), params)
    assert mod.norm.num_groups == (32 if c % 32 == 0 else 16)
    with torch.no_grad():
        assert_close(nhwc(mod(nchw(x))), want, **TOL)


@pytest.mark.parametrize("cin,cout", [(32, 32), (32, 64)])
def test_resblock(cin, cout):
    x = np_rand((2, 8, 8, cin), 2)
    emb = np_rand((2, 128), 3)
    params, want = flax_run(jl.ResBlock(cout, dtype=jnp.float32),
                            (jnp.asarray(x), jnp.asarray(emb)), 4)
    mod = port(tl.ResBlock(cin, cout, 128), params)
    with torch.no_grad():
        assert_close(nhwc(mod(nchw(x), to_t(emb))), want, **TOL)


def test_timestep_embed_mlp():
    t = np_rand((3, 32), 5)
    params, want = flax_run(jl.TimestepEmbedMLP(32, dtype=jnp.float32), (jnp.asarray(t),), 6)
    mod = port(tl.TimestepEmbedMLP(32), params)
    with torch.no_grad():
        assert_close(mod(to_t(t)), want, **TOL)


@pytest.mark.parametrize("kind", ["down", "up"])
def test_down_upsample(kind):
    x = np_rand((2, 8, 8, 32), 7)
    if kind == "down":
        jmod, tmod = jl.Downsample(32, dtype=jnp.float32), tl.Downsample(32)
    else:
        jmod, tmod = jl.Upsample(32, dtype=jnp.float32), tl.Upsample(32)
    params, want = flax_run(jmod, (jnp.asarray(x),), 8)
    mod = port(tmod, params)
    with torch.no_grad():
        got = nhwc(mod(nchw(x)))
    assert got.shape == want.shape
    assert_close(got, want, **TOL)


def test_geglu_uses_tanh_gelu():
    x = np_rand((2, 16, 32), 9) * 2
    params, want = flax_run(jl.GEGLUFeedForward(dim=32, dtype=jnp.float32),
                            (jnp.asarray(x),), 10)
    mod = port(tl.GEGLUFeedForward(32), params)
    with torch.no_grad():
        assert_close(mod(to_t(x)), want, **TOL)


@pytest.mark.parametrize("mode", ["self", "cross", "bank1", "bankB"])
def test_cross_attention(mode):
    b, s, dim, heads = 2, 64, 32, 2
    x = np_rand((b, s, dim), 11)
    kw, tkw = {}, {}
    ctx_dim = dim
    if mode == "cross":
        ctx_dim = 16
        ctx = np_rand((b, 77, 16), 12)
        kw["context"], tkw["context"] = jnp.asarray(ctx), to_t(ctx)
    elif mode.startswith("bank"):
        bank = np_rand((1 if mode == "bank1" else b, 48, dim), 13)
        kw["kv_extra"], tkw["kv_extra"] = jnp.asarray(bank), to_t(bank)
    params, want = flax_run(jl.CrossAttention(num_heads=heads, head_dim=16,
                                              dtype=jnp.float32),
                            (jnp.asarray(x),), 14, **kw)
    mod = port(tl.CrossAttention(dim, ctx_dim, heads, 16), params)
    with torch.no_grad():
        assert_close(mod(to_t(x), **tkw), want, **TOL)


@pytest.mark.parametrize("mode", ["plain", "write", "read"])
def test_basic_transformer_block(mode):
    b, s, dim = 2, 64, 32
    x = np_rand((b, s, dim), 15)
    ctx = np_rand((b, 77, 16), 16)
    bank = np_rand((1, s, dim), 17)
    kw = dict(collect=mode == "write",
              bank_entry=jnp.asarray(bank) if mode == "read" else None)
    params, (want, want_w) = flax_run(
        jl.BasicTransformerBlock(num_heads=2, head_dim=16, dtype=jnp.float32),
        (jnp.asarray(x), jnp.asarray(ctx)), 18, **kw)
    mod = port(tl.BasicTransformerBlock(dim, 16, 2, 16), params)
    with torch.no_grad():
        got, got_w = mod(to_t(x), to_t(ctx), collect=mode == "write",
                         bank_entry=to_t(bank) if mode == "read" else None)
    assert_close(got, want, **TOL)
    if mode == "write":
        assert_close(got_w, want_w, **TOL)
    else:
        assert got_w is None and want_w is None


@pytest.mark.parametrize("mode", ["plain", "write", "read"])
def test_spatial_transformer(mode):
    b, hh, c, depth = 2, 8, 32, 2
    x = np_rand((b, hh, hh, c), 19)
    ctx = np_rand((b, 77, 16), 20)
    bank = tuple(np_rand((1, hh * hh, c), 21 + i) for i in range(depth))
    jbank = tuple(jnp.asarray(e) for e in bank) if mode == "read" else None
    params, (want, want_w) = flax_run(
        jl.SpatialTransformer(num_heads=2, head_dim=16, depth=depth, dtype=jnp.float32),
        (jnp.asarray(x), jnp.asarray(ctx), jbank, mode == "write"), 23)
    mod = port(tl.SpatialTransformer(c, 2, 16, depth, 16), params)
    with torch.no_grad():
        got, got_w = mod(nchw(x), to_t(ctx),
                         tuple(to_t(e) for e in bank) if mode == "read" else None,
                         mode == "write")
    assert_close(nhwc(got), want, **TOL)
    assert len(got_w) == len(want_w) == (depth if mode == "write" else 0)
    for g, w in zip(got_w, want_w):
        assert_close(g, w, **TOL)
