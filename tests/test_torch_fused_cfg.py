"""Fused classifier-free guidance in the port against the JAX package: the
gated plain version of kernel B (`two_source_attention_ref(..., bank_mask=)`)
against the Pallas kernel `flash.py::_attn2_kernel` (interpret mode) and the
XLA path; `MagicPoseModel.cfg_fused_eps` against JAX's and against the port's
own two passes; and `ddim_sample(fused_cfg=True)` against JAX's, with the
same weights (every leaf random) and the same numpy inputs, at the tiny
config. Tolerances: 2e-5 abs/rel for the attention (summation order), 3e-5
between the fused and the two-pass eps (tests/test_sampling.py's), 5e-4 for
the networks against JAX and 2e-3 for the sampled latents (CFG 7 amplifies
the per-pass fp32 differences, tests/test_torch_pipeline.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import magicdance_tpu_torch.config as tcfg
from magicdance_tpu.ops.attention import bank_read_attention as j_bank_read
from magicdance_tpu.ops.pallas.flash import _flash_attention_two_source_impl
from magicdance_tpu_torch.ops import attention as tattn
from magicdance_tpu_torch.ops import kernels as K
from magicdance_tpu_torch.ops import schedules as ts
from magicdance_tpu_torch.sampling.ddim import ddim_sample
from torch_port_util import (
    assert_close,
    make_pipelines,
    np_rand,
    sample_both,
    tiny_model_cfg_jax,
    to_t,
)
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("bank_batch,gates", [(1, (1.0, 0.0, 0.5)), (3, (0.0, 1.0, 0.25))])
def test_gated_ref_matches_pallas_and_xla(bank_batch, gates):
    b, h, s, sb, d = 3, 2, 64, 32, 32
    q, k, v = (np_rand((b, s, h, d), i) for i in range(3))
    kb, vb = (np_rand((bank_batch, sb, h, d), 3 + i) for i in range(2))
    mask = np.asarray(gates, np.float32)
    scale = d ** -0.5
    jargs = [jnp.asarray(a) for a in (q, k, v, kb, vb)]
    with pltpu.force_tpu_interpret_mode():
        want = _flash_attention_two_source_impl(*jargs, scale=scale,
                                                bank_mask=jnp.asarray(mask))
    want_xla = j_bank_read(*jargs, impl="xla", bank_mask=jnp.asarray(mask))
    args = [to_t(a) for a in (q, k, v, kb, vb)]
    got = K.two_source_attention_ref(*args, scale, bank_mask=to_t(mask))
    assert_close(got, want, **TOL)
    assert_close(got, want_xla, **TOL)
    # the dispatch entry point (a plain-version site here) and the wrapper
    K.reset_launches()
    assert_close(tattn.bank_read_attention(*args, bank_mask=to_t(mask)), want, **TOL)
    assert_close(K.two_source_attention(*args, bank_mask=to_t(mask)), want, **TOL)
    assert not any(K.LAUNCHES.values())
    # a gate of 0 is plain self-attention
    row = gates.index(0.0)
    assert_close(got[row], K.self_attention_ref(*args[:3])[row].numpy(), **TOL)


def test_gated_kernel_site_calls_the_wrapper_and_refuses_gradients(monkeypatch):
    """At S >= 256 the gated read calls kernel B's wrapper with the mask (the
    gated launch on the card); at S = 64 the gated plain version. The gate is
    forward-only, as in JAX."""
    calls = []
    real = tattn.two_source_attention
    monkeypatch.setattr(tattn, "two_source_attention",
                        lambda *a, **kw: calls.append(kw.get("bank_mask")) or real(*a, **kw))
    mask = torch.tensor([1.0, 0.0])
    x = to_t(np_rand((2, 256, 32), 10))
    bank = to_t(np_rand((1, 256, 32), 11))
    small = to_t(np_rand((2, 64, 32), 12))
    out = tattn.bank_read_attention_packed(x, x, x, bank, bank, num_heads=2, bank_mask=mask)
    tattn.bank_read_attention_packed(small, small, small, small[:1], small[:1], num_heads=2,
                                     bank_mask=mask)
    assert len(calls) == 1 and torch.equal(calls[0], mask)
    want = j_bank_read(*(jnp.asarray(t.reshape(t.shape[0], t.shape[1], 2, 16).numpy())
                         for t in (x, x, x, bank, bank)),
                       impl="xla", bank_mask=jnp.asarray(mask.numpy()))
    assert_close(out, np.asarray(want).reshape(2, 256, 32), **TOL)
    xg = x.clone().requires_grad_()
    with pytest.raises(NotImplementedError):
        tattn.bank_read_attention_packed(xg, xg, xg, bank, bank, num_heads=2, bank_mask=mask)


@pytest.fixture(scope="module")
def pipelines():
    return make_pipelines(tiny_model_cfg_jax())


X = np_rand((2, 8, 8, 4), 20)
T = np.array([501, 501])
CTX, UCTX = np_rand((1, 77, 16), 21), np_rand((1, 77, 16), 22)
REF = np_rand((1, 8, 8, 4), 23)
HINT = np_rand((2, 64, 64, 3), 24, 0.0, 1.0)


def test_cfg_fused_eps_matches_jax_and_two_passes(pipelines):
    jp, tp = pipelines
    jm = jp.model

    @jax.jit
    def fused(p, x, t, c, u, r, h):
        bank = jm.apply(p, r, t[:1], c, method=jm.compute_bank)
        return jm.apply(p, x, t, c, u, bank=bank, pose_hint=h, method=jm.cfg_fused_eps)

    want_c, want_u = fused(jp.params["model"], *(jnp.asarray(a) for a in
                                                 (X, T, CTX, UCTX, REF, HINT)))
    m = tp.model
    with torch.no_grad():
        bank = m.compute_bank(to_t(REF), torch.tensor(T[:1]), to_t(CTX))
        got_c, got_u = m.cfg_fused_eps(to_t(X), torch.tensor(T), to_t(CTX), to_t(UCTX),
                                       bank=bank, pose_hint=to_t(HINT))
        two_c = m(to_t(X), torch.tensor(T), to_t(CTX).expand(2, -1, -1), bank=bank,
                  pose_hint=to_t(HINT))
        two_u = m(to_t(X), torch.tensor(T), to_t(UCTX).expand(2, -1, -1), uc=True)
    assert_close(got_c, want_c, atol=5e-4, rtol=5e-4)
    assert_close(got_u, want_u, atol=5e-4, rtol=5e-4)
    assert_close(got_c, two_c.numpy(), atol=3e-5, rtol=3e-5)
    assert_close(got_u, two_u.numpy(), atol=3e-5, rtol=3e-5)
    assert float(np.abs(np.asarray(want_c) - np.asarray(want_u)).max()) > 1e-2


INPUTS = dict(x_T=np.broadcast_to(np_rand((1, 8, 8, 4), 30), (2, 8, 8, 4)).copy(),
              ctx=CTX, uctx=UCTX, ref=REF, hint=HINT)


def test_ddim_sample_fused_cfg_matches_jax(pipelines):
    jp, tp = pipelines
    got, want = sample_both(jp, tp, 3, INPUTS, fused_cfg=True)
    assert_close(got, want, atol=2e-3, rtol=2e-3)
    # fused and two-pass CFG sample the same latents
    two = ddim_sample(tp.model, tp.sched, ts.make_ddim_schedule(tp.sched, 3),
                      tcfg.SampleConfig(steps=3), to_t(INPUTS["x_T"]), to_t(CTX), to_t(UCTX),
                      reference_latent=to_t(REF), pose_hint=to_t(HINT))
    assert_close(got, two.numpy(), atol=1e-4, rtol=1e-4)


def test_fused_cfg_quirks_and_refusal(pipelines):
    """As in JAX (sampling/ddim.py:209-235): with fused_cfg the turbo flags
    are ignored; with cfg_scale 1 there is no CFG to fuse; fused_cfg with
    self_kv_downsample > 1 is refused."""
    _, tp = pipelines
    ddim = ts.make_ddim_schedule(tp.sched, 2)
    x_T = to_t(np_rand((2, 8, 8, 4), 31))
    kw = dict(reference_latent=to_t(REF), pose_hint=to_t(HINT))

    def run(**s):
        return ddim_sample(tp.model, tp.sched, ddim, tcfg.SampleConfig(steps=2, **s), x_T,
                           to_t(CTX), to_t(UCTX), **kw)

    fused = run(fused_cfg=True)
    assert torch.equal(run(fused_cfg=True, uncond_every=2, deepcache_every=2, pose_every=2,
                           cfg_interval=(0.2, 0.8), bank_every=2), fused)
    assert torch.equal(run(fused_cfg=True, cfg_scale=1.0), run(cfg_scale=1.0))
    with pytest.raises(ValueError, match="self_kv_downsample"):
        run(fused_cfg=True, self_kv_downsample=2)
