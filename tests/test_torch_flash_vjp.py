"""The port's training attention against the JAX package's custom-VJP Pallas
kernels (magicdance_tpu/ops/pallas/flash_vjp.py), run in interpret mode on
the CPU as tests/test_flash_attention.py:242-321 runs them.

  * the plain versions of the training kernels -- the LSE forward
    (`_fwd_lse_kernel`, `_fwd2_lse_kernel`), dQ (`_dq_kernel`,
    `_dq2_kernel`) and dK/dV (`_dkv_kernel`) -- against the JAX core
    functions that launch them, on the (B*H, S, D) core layout, with bank
    batch 1 and B;
  * the port's autograd Functions (`mha`, `mha_packed`, `mha_two_source`,
    `mha_two_source_packed`) against jax.grad of the JAX custom-VJP entry
    points, on the loss sum(sin(out)).

Inputs drawn with numpy from a seed, S 64-128, D 32 and 40. Tolerance 2e-4
abs/rel in fp32, as the JAX package's own gradient tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from magicdance_tpu.ops.pallas import flash_vjp as JV
from magicdance_tpu_torch.ops.kernels import flash_vjp as V
from torch_port_util import assert_close, np_rand, to_t
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

TOL = dict(atol=2e-4, rtol=2e-4)


def core(t: torch.Tensor) -> np.ndarray:
    """(B, S, H, D) -> the JAX core layout (B*H, S, D)."""
    b, s, h, d = t.shape
    return t.detach().permute(0, 2, 1, 3).reshape(b * h, s, d).numpy()


def rows(t: torch.Tensor) -> np.ndarray:
    """(B, H, S) -> the JAX (B*H, 1, S) row layout."""
    b, h, s = t.shape
    return t.reshape(b * h, 1, s).numpy()


@pytest.mark.parametrize("s,d,bank", [(128, 32, None), (64, 40, None),
                                      (64, 32, 1), (128, 40, 1), (64, 40, "B")])
def test_plain_versions_match_pallas_core(s, d, bank):
    b, h, sb = 2, 2, 64
    scale = d ** -0.5
    q, k, v, dout = (to_t(np_rand((b, s, h, d), i)) for i in range(4))
    j = lambda t: jnp.asarray(core(t))  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        if bank is None:
            o, lse = JV._core_fwd_lse(j(q), j(k), j(v), scale=scale)
            got_o, got_lse = V.self_attention_lse_ref(q, k, v, scale)
        else:
            bb = b if bank == "B" else 1
            kb, vb = (to_t(np_rand((bb, sb, h, d), 10 + i)) for i in range(2))
            o, lse = JV._core2_fwd_lse(j(q), j(k), j(v), j(kb), j(vb), scale=scale)
            got_o, got_lse = V.two_source_attention_lse_ref(q, k, v, kb, vb, scale)
        assert_close(torch.from_numpy(core(got_o)), o, **TOL)
        assert_close(torch.from_numpy(rows(got_lse)), lse, **TOL)

        # backward from the JAX forward's statistics: delta = rowsum(dO o O)
        lse_t = to_t(lse).reshape(b, h, s)
        o_t = to_t(o).reshape(b, h, s, d).permute(0, 2, 1, 3)
        delta = V.attention_delta(dout, o_t)
        jdelta = jnp.asarray(rows(delta))
        if bank is None:
            want_dq = JV._core_dq(j(q), j(k), j(v), j(dout), scale=scale)
            got_dq = V.attention_dq_ref(q, k, v, dout, lse_t, delta, scale)
            sources = [(k, v)]
        else:
            want_dq = JV._core2_dq(j(q), j(k), j(v), j(kb), j(vb), j(dout), scale=scale)
            got_dq = V.attention_dq_ref(q, k, v, dout, lse_t, delta, scale, kb, vb)
            sources = [(k, v), (kb, vb)]
        assert_close(torch.from_numpy(core(got_dq)), want_dq, **TOL)
        for kk, vv in sources:
            dk, dv = JV._core_dkv(j(kk), j(vv), j(q), j(dout), jnp.asarray(rows(lse_t)),
                                  jdelta, scale=scale)
            if kk.shape[0] != b:  # batch-1 bank: JAX sums its per-frame result
                dk = dk.reshape(b, h, *dk.shape[1:]).sum(0)
                dv = dv.reshape(b, h, *dv.shape[1:]).sum(0)
            got_dk, got_dv = V.attention_dkv_ref(kk, vv, q, dout, lse_t, delta, scale)
            assert got_dk.shape == kk.shape
            assert_close(torch.from_numpy(core(got_dk)), dk, **TOL)
            assert_close(torch.from_numpy(core(got_dv)), dv, **TOL)


def _jax_grads(fn, args):
    loss = lambda *a: jnp.sum(jnp.sin(fn(*a)))  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        return jax.grad(loss, argnums=tuple(range(len(args))))(*args)


def _port_grads(fn, args):
    ts = [to_t(a).requires_grad_() for a in args]
    out = fn(*ts)
    return out, torch.autograd.grad(out.sin().sum(), ts)


@pytest.mark.parametrize("s,d", [(128, 32), (64, 40)])
def test_mha_grads_match_jax(s, d):
    b, h = 2, 2
    scale = d ** -0.5
    args = [np_rand((b, s, h, d), i) for i in range(3)]
    want = _jax_grads(lambda q, k, v: JV.mha(q, k, v, scale), [jnp.asarray(a) for a in args])
    _, got = _port_grads(lambda q, k, v: V.mha(q, k, v, scale), args)
    for g, w in zip(got, want):
        assert_close(g, w, **TOL)


@pytest.mark.parametrize("bb", [1, 2])
def test_mha_two_source_grads_match_jax(bb):
    b, h, s, sb, d = 2, 2, 64, 32, 32
    scale = d ** -0.5
    args = ([np_rand((b, s, h, d), i) for i in range(3)]
            + [np_rand((bb, sb, h, d), 3 + i) for i in range(2)])
    want = _jax_grads(lambda *a: JV.mha_two_source(*a, scale), [jnp.asarray(a) for a in args])
    _, got = _port_grads(lambda *a: V.mha_two_source(*a, scale), args)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert_close(g, w, **TOL)


def test_packed_grads_match_jax():
    b, s, sb, h, d = 2, 64, 64, 2, 32
    scale = d ** -0.5
    args = [np_rand((b, s, h * d), 20 + i) for i in range(3)]
    want = _jax_grads(lambda q, k, v: JV.mha_packed(q, k, v, scale, h),
                      [jnp.asarray(a) for a in args])
    _, got = _port_grads(lambda q, k, v: V.mha_packed(q, k, v, scale, h), args)
    for g, w in zip(got, want):
        assert_close(g, w, **TOL)
    args += [np_rand((1, sb, h * d), 23 + i) for i in range(2)]
    want = _jax_grads(lambda *a: JV.mha_two_source_packed(*a, scale, h),
                      [jnp.asarray(a) for a in args])
    _, got = _port_grads(lambda *a: V.mha_two_source_packed(*a, scale, h), args)
    for g, w in zip(got, want):
        assert_close(g, w, **TOL)


def test_backward_skips_grads_nobody_needs(monkeypatch):
    """`needs_input_grad` is respected: with only the bank requiring grad,
    no dQ and no self-source dK/dV are computed."""
    calls = {"dq": 0, "dkv": 0}
    dq, dkv = V.attention_dq, V.attention_dkv

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(V, "attention_dq", count("dq", dq))
    monkeypatch.setattr(V, "attention_dkv", count("dkv", dkv))
    q, k, v = (to_t(np_rand((2, 64, 2, 32), i)) for i in range(3))
    kb = to_t(np_rand((1, 64, 2, 32), 5)).requires_grad_()
    out = V.mha_two_source(q, k, v, kb, kb)
    (g,) = torch.autograd.grad(out.sin().sum(), [kb])
    assert torch.isfinite(g).all()
    assert calls == {"dq": 0, "dkv": 1}
