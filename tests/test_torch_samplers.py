"""The port's PLMS and DPM-Solver++ samplers and the schedule's x0
predictions against the JAX package: the same weights (carried by
`convert.from_jax`) and the same numpy inputs through `plms_sample`,
`dpmpp_2m_sample` and `dpmpp_3m_sample` on each side (ODE, `wonoise`, CFG 7,
4 steps: every history depth of each solver is reached), within 2e-3; the 3M
SDE variant's draws come from the caller's generator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magicdance_tpu.config as jcfg
import magicdance_tpu_torch.config as tcfg
from magicdance_tpu.ops import schedules as js
from magicdance_tpu_torch.ops import schedules as ts
from magicdance_tpu_torch.sampling.dpm import dpmpp_2m_sample, dpmpp_3m_sample
from magicdance_tpu_torch.sampling.plms import multistep_eps, plms_sample
from torch_port_util import assert_close, make_models, micro_model_cfg_jax, np_rand, to_t
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

STEPS = 4
TOL = 2e-3  # tests/test_torch_pipeline.py's sampler bound


@pytest.fixture(scope="module")
def setup():
    jc = micro_model_cfg_jax()
    jm, params, tm = make_models(jc)
    jsched, tsched = js.make_schedule(jc.diffusion), ts.make_schedule(tcfg.DiffusionConfig())
    inputs = dict(x_T=np_rand((2, 8, 8, 4), 1), ctx=np_rand((1, 77, 16), 2),
                  uctx=np_rand((1, 77, 16), 3), ref=np_rand((1, 8, 8, 4), 4),
                  hint=np_rand((2, 64, 64, 3), 5, 0.0, 1.0))
    return (jm, params, jsched), (tm, tsched), inputs


def run_both(setup, j_fn, t_fn, schedule_arg, **kw):
    """JAX sampler and the port's on the same inputs; (port, JAX) latents."""
    (jm, params, jsched), (tm, tsched), inp = setup
    j_args = [jnp.asarray(inp[k]) for k in ("x_T", "ctx", "uctx")]
    t_args = [to_t(inp[k]) for k in ("x_T", "ctx", "uctx")]
    # one compiled program (an eager call compiles each small op on its own)
    want = jax.jit(lambda p, x, c, u, ref, hint: j_fn(
        jm, p, jsched, schedule_arg(js, jsched), jcfg.SampleConfig(steps=STEPS),
        jax.random.PRNGKey(0), x, c, u, reference_latent=ref, pose_hint=hint, **kw))(
        params, *j_args, jnp.asarray(inp["ref"]), jnp.asarray(inp["hint"]))
    got = t_fn(tm, tsched, schedule_arg(ts, tsched), tcfg.SampleConfig(steps=STEPS),
               *t_args, reference_latent=to_t(inp["ref"]), pose_hint=to_t(inp["hint"]), **kw)
    return got, np.asarray(want)


def test_plms_matches_jax(setup):
    from magicdance_tpu.sampling.plms import plms_sample as j_plms

    got, want = run_both(setup, j_plms, plms_sample,
                         lambda m, sched: m.make_ddim_schedule(sched, STEPS))
    assert np.isfinite(want).all() and got.shape == want.shape
    assert_close(got, want, TOL, TOL)


@pytest.mark.parametrize("order", ["2m", "3m"])
def test_dpmpp_matches_jax(setup, order):
    from magicdance_tpu.sampling import dpm as jdpm

    j_fn = jdpm.dpmpp_2m_sample if order == "2m" else jdpm.dpmpp_3m_sample
    t_fn = dpmpp_2m_sample if order == "2m" else dpmpp_3m_sample
    got, want = run_both(setup, j_fn, t_fn, lambda m, sched: STEPS)
    assert np.isfinite(want).all() and got.shape == want.shape
    assert_close(got, want, TOL, TOL)


def test_dpmpp_3m_sde_draws_from_generator(setup):
    """sde_eta > 0: finite, the same for the same generator seed, different
    for another seed and from the ODE solver."""
    _, (tm, tsched), inp = setup
    args = [to_t(inp[k]) for k in ("x_T", "ctx", "uctx")]
    kw = dict(reference_latent=to_t(inp["ref"]), pose_hint=to_t(inp["hint"]))
    scfg = tcfg.SampleConfig(steps=2)

    def run(seed, eta=1.0):
        g = torch.Generator().manual_seed(seed)
        return dpmpp_3m_sample(tm, tsched, 2, scfg, *args, sde_eta=eta, generator=g, **kw)

    a, b, c, ode = run(0), run(0), run(1), run(0, eta=0.0)
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c, atol=1e-4)
    assert not torch.allclose(a, ode, atol=1e-4)


def test_plms_history_combinations():
    """The Adams-Bashforth weights of each history depth (JAX plms.py's
    jnp.select branches), on scalars."""
    e = [torch.tensor(float(v)) for v in (1.0, 2.0, 4.0, 8.0)]
    assert multistep_eps(e[0], []) == 1.0
    assert multistep_eps(e[0], e[1:2]) == (3 * 1 - 2) / 2
    assert multistep_eps(e[0], e[1:3]) == (23 * 1 - 16 * 2 + 5 * 4) / 12
    assert multistep_eps(e[0], e[1:4]) == (55 * 1 - 59 * 2 + 37 * 4 - 9 * 8) / 24


@pytest.mark.parametrize("param", ["eps", "v"])
def test_predict_start_matches_jax(param):
    """tests/test_schedules.py:64, 78: x0 from (x_t, eps) and from (x_t, v)
    on the same arrays, and the round trips."""
    jd = jcfg.DiffusionConfig(parameterization=jcfg.Parameterization(param))
    jsched, tsched = js.make_schedule(jd), ts.make_schedule(tcfg.DiffusionConfig(
        parameterization=tcfg.Parameterization(param)))
    x0, eps = np_rand((2, 8, 8, 4), 11), np_rand((2, 8, 8, 4), 12)
    t = np.array([50, 700])
    xt = ts.q_sample(tsched, to_t(x0), torch.tensor(t), to_t(eps))
    jxt = js.q_sample(jsched, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(eps))
    if param == "eps":
        got = ts.predict_start_from_noise(tsched, xt, torch.tensor(t), to_t(eps))
        want = js.predict_start_from_noise(jsched, jxt, jnp.asarray(t), jnp.asarray(eps))
    else:
        v = ts.get_v(tsched, to_t(x0), to_t(eps), torch.tensor(t))
        got = ts.predict_start_from_z_and_v(tsched, xt, torch.tensor(t), v)
        want = js.predict_start_from_z_and_v(
            jsched, jxt, jnp.asarray(t),
            js.get_v(jsched, jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(t)))
    assert_close(got, np.asarray(want), 2e-4, 2e-4)
    assert_close(got, x0, 1e-4, 1e-4)
