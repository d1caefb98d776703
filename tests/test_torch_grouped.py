"""Grouped (temporal) attention: the plain versions of kernel G's forward and
backward against the JAX package's Pallas grouped kernels run in interpret
mode on the CPU (`flash_attention_grouped` and the custom VJP of
`mha_grouped`), the port's grouped-site rule against JAX's
`_pick_impl_packed`, and the CPU dispatch. fp32 throughout; tolerance 2e-5
abs/rel for the forward and the gradients: the same products summed in
another order (the Pallas kernel adds the masked block's exact zeros)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from magicdance_tpu.ops import attention as jattn
from magicdance_tpu.ops.pallas.flash import flash_attention_grouped as j_grouped
from magicdance_tpu_torch.ops import attention as tattn
from magicdance_tpu_torch.ops import kernels as K
from magicdance_tpu_torch.ops.kernels import flash_vjp as V
from magicdance_tpu_torch.ops.kernels.grouped import (
    grouped_attention_bwd_ref,
    grouped_attention_ref,
)
from torch_port_util import np_rand, to_t
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

TOL = dict(atol=2e-5, rtol=2e-5)
# (B sequences, S, H, D): S in {1, 4, 16, 32, 64}, head dims 8-160
SHAPES = [(128, 1, 2, 8), (32, 4, 2, 24), (16, 16, 4, 8), (8, 16, 2, 40),
          (4, 32, 2, 80), (4, 32, 1, 160), (2, 64, 2, 32)]


def _qkv(b, s, h, d, seed):
    return [np_rand((b, s, h * d), seed + i) for i in range(3)]


@pytest.mark.parametrize("b,s,h,d", SHAPES)
def test_forward_ref_matches_pallas(b, s, h, d):
    q, k, v = _qkv(b, s, h, d, 10)
    with pltpu.force_tpu_interpret_mode():
        want = j_grouped(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         scale=d ** -0.5, num_heads=h)
    got = grouped_attention_ref(to_t(q), to_t(k), to_t(v), None, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("b,s,h,d", SHAPES)
def test_grads_match_pallas_vjp(b, s, h, d):
    """mha_grouped's backward (the plain version on the CPU) against the
    gradients of the Pallas kernel's custom VJP, for a random cotangent."""
    q, k, v = _qkv(b, s, h, d, 20)
    g = np_rand((b, s, h * d), 30)

    def loss(q, k, v):
        return jnp.sum(j_grouped(q, k, v, scale=d ** -0.5, num_heads=h) * g)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (to_t(a).requires_grad_() for a in (q, k, v))
    out = V.mha_grouped(tq, tk, tv, None, h)
    out.backward(to_t(g))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL)
    # the plain backward on its own gives the same three gradients
    direct = grouped_attention_bwd_ref(to_t(q), to_t(k), to_t(v), to_t(g), None, h)
    for got, w in zip(direct, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL)


def test_grouped_site_rule_matches_jax(monkeypatch):
    """The port's rule is `_pick_impl_packed`'s `flash_grouped` decision with
    the TPU backend forced, over a grid of (sq, sk, d, batch, bank)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.delenv("MD_DISABLE_GROUPED_ATTN", raising=False)
    seen = set()
    for sq, sk, d, batch, bank in itertools.product(
            (1, 3, 4, 16, 24, 32, 64), (1, 4, 16, 32, 77), (40, 160, 256, 320),
            (0, 1, 8, 64, 4096), (False, True)):
        want = jattn._pick_impl_packed(sq, sk, d, bank=bank, has_mask=False,
                                       batch=batch) == "flash_grouped"
        got = not bank and tattn._grouped_site(sq, sk, d, batch)
        assert got == want, (sq, sk, d, batch, bank)
        seen.add(want)
    assert seen == {True, False}


def test_cpu_dispatch_of_grouped_sites(monkeypatch):
    """A grouped site on a CPU tensor takes kernel G's plain version without
    a gradient and `mha_grouped` with one; other sites keep their paths; the
    kernels are never launched."""
    calls = []
    real_g, real_m = tattn.grouped_attention, tattn.mha_grouped
    monkeypatch.setattr(tattn, "grouped_attention",
                        lambda *a, **kw: calls.append("plain") or real_g(*a, **kw))
    monkeypatch.setattr(tattn, "mha_grouped",
                        lambda *a, **kw: calls.append("grad") or real_m(*a, **kw))
    K.reset_launches()
    q, k, v = (to_t(a) for a in _qkv(64, 16, 2, 40, 40))
    want = grouped_attention_ref(q, k, v, None, 2)
    np.testing.assert_allclose(tattn.attention_packed(q, k, v, num_heads=2).numpy(),
                               want.numpy(), **TOL)
    qg = q.clone().requires_grad_()
    tattn.attention_packed(qg, k, v, num_heads=2).sum().backward()
    assert qg.grad is not None and torch.isfinite(qg.grad).all()
    # 8 sequences of 16 rows: 128 rows in all; 4 x 16 = 64 rows are not a tile
    tattn.attention_packed(q[:8], k[:8], v[:8], num_heads=2)
    tattn.attention_packed(q[:4], k[:4], v[:4], num_heads=2)
    assert calls == ["plain", "grad", "plain"]
    assert not any(K.LAUNCHES.values())
    # the middle-block-like S = 64 and cross-attention shapes are not grouped
    assert not tattn._grouped_site(64, 64, 160, 64)
    assert not tattn._grouped_site(16, 77, 40, 4096)


def test_grouped_refuses_what_the_kernel_refuses():
    q = torch.zeros(2, 24, 16)  # S = 24 does not divide 128
    with pytest.raises(ValueError, match="S | 128"):
        grouped_attention_ref(q, q, q, None, 2)
    q = torch.zeros(4, 16, 16)  # 64 rows: not a whole 128-row tile
    with pytest.raises(ValueError):
        K.grouped_attention(q, q, q, None, 2)
    with pytest.raises(ValueError):
        grouped_attention_bwd_ref(q, q, q, q, None, 2)


def test_mha_grouped_honours_needs_input_grad(monkeypatch):
    """One backward launch serves q, k and v; with no input needing a
    gradient there is none, and only the gradients asked for come back."""
    calls = []
    real = V.grouped_attention_bwd
    monkeypatch.setattr(V, "grouped_attention_bwd",
                        lambda *a: calls.append(1) or real(*a))
    q, k, v = (to_t(a) for a in _qkv(8, 16, 2, 8, 50))
    vg = v.clone().requires_grad_()
    (V.mha_grouped(q, k, vg, None, 2) * 2).sum().backward()
    assert calls == [1] and vg.grad is not None
    want = grouped_attention_bwd_ref(q, k, v, torch.full_like(q, 2.0), None, 2)[2]
    np.testing.assert_allclose(vg.grad.numpy(), want.numpy(), **TOL)
    qg = q.clone().requires_grad_()
    out = V.mha_grouped(qg, k, v, None, 2)
    (dq,) = torch.autograd.grad(out.sum(), [qg])
    assert calls == [1, 1] and dq.shape == q.shape
