"""The port's attention (plain versions of kernels A and B, and the packed /
BSNH dispatch entry points) against the JAX package's Pallas kernels, run in
interpret mode on the CPU at the shapes tests/test_flash_attention.py uses.
Tolerance 2e-5 abs/rel in fp32 (summation order only)."""

import pytest

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from magicdance_tpu.ops.attention import _xla_attention, bank_read_attention
from magicdance_tpu.ops.pallas.flash import (
    _flash_attention_fused_impl,
    _flash_attention_impl,
    _flash_attention_two_source_fused_impl,
    _flash_attention_two_source_impl,
)
from magicdance_tpu_torch.ops import attention as tattn
from magicdance_tpu_torch.ops import kernels as K
from torch_port_util import assert_close, np_rand, to_t
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("s,d", [(128, 32), (64, 40)])
def test_self_attention_ref_matches_pallas_bsnh(s, d):
    b, h = 2, 2
    q, k, v = (np_rand((b, s, h, d), i) for i in range(3))
    scale = d ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want = _flash_attention_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     scale=scale)
    assert_close(K.self_attention_ref(to_t(q), to_t(k), to_t(v), scale), want, **TOL)
    # the wrapper takes the plain version for a CPU tensor, without a launch
    K.reset_launches()
    assert_close(K.self_attention(to_t(q), to_t(k), to_t(v)), want, **TOL)
    assert K.LAUNCHES == {"self_attention": 0, "two_source_attention": 0}


def test_self_attention_ref_matches_pallas_packed():
    b, s, h, d = 2, 64, 2, 32
    q, k, v = (np_rand((b, s, h * d), 20 + i) for i in range(3))
    with pltpu.force_tpu_interpret_mode():
        want = _flash_attention_fused_impl(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), scale=d ** -0.5,
                                           num_heads=h)
    got = tattn.attention_packed(to_t(q), to_t(k), to_t(v), num_heads=h)
    assert_close(got, want, **TOL)
    split = lambda a: to_t(a).reshape(b, s, h, d)  # noqa: E731
    assert_close(K.self_attention_ref(split(q), split(k), split(v)).reshape(b, s, h * d),
                 want, **TOL)


@pytest.mark.parametrize("bank_batch", [1, 2])
def test_two_source_ref_matches_pallas_packed(bank_batch):
    b, s, sb, h, d = 2, 64, 64, 2, 32
    q, k, v = (np_rand((b, s, h * d), 20 + i) for i in range(3))
    kb, vb = (np_rand((bank_batch, sb, h * d), 23 + i) for i in range(2))
    with pltpu.force_tpu_interpret_mode():
        want = _flash_attention_two_source_fused_impl(
            *(jnp.asarray(a) for a in (q, k, v, kb, vb)), scale=d ** -0.5,
            num_heads=h)
    got = tattn.bank_read_attention_packed(*(to_t(a) for a in (q, k, v, kb, vb)),
                                           num_heads=h)
    assert_close(got, want, **TOL)


@pytest.mark.parametrize("bank_batch", [1, 3])
def test_two_source_ref_matches_pallas_bsnh(bank_batch):
    b, h, s, sb, d = 3, 2, 64, 32, 32
    q, k, v = (np_rand((b, s, h, d), i) for i in range(3))
    kb, vb = (np_rand((bank_batch, sb, h, d), 3 + i) for i in range(2))
    scale = d ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want = _flash_attention_two_source_impl(
            *(jnp.asarray(a) for a in (q, k, v, kb, vb)), scale=scale)
    args = [to_t(a) for a in (q, k, v, kb, vb)]
    assert_close(K.two_source_attention_ref(*args, scale), want, **TOL)
    assert_close(tattn.bank_read_attention(*args), want, **TOL)


def test_dispatch_entry_points_match_xla_math():
    """dot_product_attention / bank_read_attention equal the JAX package's
    XLA-path functions, including at S >= 256 (plain math on the CPU)."""
    b, s, h, d = 1, 256, 2, 16
    q, k, v, kb, vb = (np_rand((b, s, h, d), 40 + i) for i in range(5))
    want = _xla_attention(*(jnp.asarray(a) for a in (q, k, v)), d ** -0.5)
    assert_close(tattn.dot_product_attention(to_t(q), to_t(k), to_t(v)), want, **TOL)
    want2 = bank_read_attention(*(jnp.asarray(a) for a in (q, k, v, kb, vb)),
                                impl="xla")
    assert_close(tattn.bank_read_attention(*(to_t(a) for a in (q, k, v, kb, vb))),
                 want2, **TOL)


def test_cpu_dispatch_never_launches_kernels():
    q = to_t(np_rand((2, 256, 64), 50))
    bank = to_t(np_rand((1, 256, 64), 51))
    K.reset_launches()
    out = tattn.attention_packed(q, q, q, num_heads=8)
    tattn.bank_read_attention_packed(q, q, q, bank, bank, num_heads=8)
    assert K.LAUNCHES == {"self_attention": 0, "two_source_attention": 0}
    split = q.reshape(2, 256, 8, 8)
    assert_close(out, K.self_attention_ref(split, split, split).reshape(2, 256, 64).numpy(),
                 atol=0, rtol=0)
