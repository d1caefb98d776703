"""DPM-Solver++ samplers, 2M and 3M (with the SDE variant), in PyTorch.

Counterpart of `magicdance_tpu.sampling.dpm`: the data-prediction ("++")
multistep solvers over lambda = log(alpha / sigma), on S + 1 knots uniform in
t from T-1 down to 0 (`knots`, JAX `_prep`). Each step makes one x0
prediction with the exact recipe's conditioning (`sampling.ddim.make_eps_fn`:
bank, control branches, CFG, wonoise) and returns the last one, as JAX does.

The step coefficients are scalars of the knot schedule; they are computed in
float32 on the host (numpy), as JAX computes them in float32, so the loop
never waits on the card. JAX's scan carries the history depth on the device
and evaluates every order's correction, selecting one with `jnp.where`; at
the first steps the unselected third-order term is 0/0. Here the depth,
min(i, 2), is known on the host, so only the selected correction is computed:
the same result, and no NaN is made. The SDE churn of `dpmpp_3m_sample`
(`sde_eta > 0`) draws from the caller's `generator`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from magicdance_tpu_torch.config import Parameterization, SampleConfig
from magicdance_tpu_torch.ops.schedules import DiffusionSchedule
from magicdance_tpu_torch.sampling.ddim import make_eps_fn

_F = np.float32


def knots(sched: DiffusionSchedule, num_steps: int):
    """(t, alpha, sigma, lambda) at the S + 1 knots: t int64 numpy, the rest
    float32 numpy."""
    acp = sched.alphas_cumprod.cpu().numpy()
    T = acp.shape[0]
    ts = np.linspace(T - 1, 0, num_steps + 1).round().astype(np.int64)
    alphas = np.sqrt(acp[ts]).astype(_F)
    sigmas = np.sqrt(_F(1.0) - acp[ts]).astype(_F)
    return ts, alphas, sigmas, (np.log(alphas) - np.log(sigmas)).astype(_F)


def _x0_fn(model, sched, num_steps, scfg, x_T, context, uncond_context, reference_latent,
           pose_hint, parameterization, generator):
    """The knots and the data prediction x0(x_t) = (x_t - sigma_t eps) / alpha_t."""
    eps_at = make_eps_fn(model, sched, scfg, x_T.shape[0], context, uncond_context,
                         reference_latent, pose_hint, parameterization, generator)
    sqrt_acp = np.sqrt(sched.alphas_cumprod.cpu().numpy())
    sqrt_1m_acp = np.sqrt(_F(1.0) - sched.alphas_cumprod.cpu().numpy())

    def x0_at(x: torch.Tensor, t_scalar: int) -> torch.Tensor:
        e = eps_at(x, t_scalar)
        return (x - float(sqrt_1m_acp[t_scalar]) * e) / float(sqrt_acp[t_scalar])

    return knots(sched, num_steps), x0_at


def _pos(v) -> np.float32:
    """max(v, 1e-8) in float32: JAX's guard on every divisor."""
    return np.maximum(_F(v), _F(1e-8))


@torch.inference_mode()
def dpmpp_2m_sample(
    model,
    sched: DiffusionSchedule,
    num_steps: int,
    scfg: SampleConfig,
    x_T: torch.Tensor,
    context: torch.Tensor,
    uncond_context: Optional[torch.Tensor] = None,
    *,
    reference_latent: Optional[torch.Tensor] = None,
    pose_hint: Optional[torch.Tensor] = None,
    parameterization: Parameterization = Parameterization.EPS,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Second-order multistep DPM-Solver++. x_T: (B, h, w, 4); the other
    arguments as `ddim_sample`'s. Returns the last x0 prediction."""
    (ts, alphas, sigmas, lambdas), x0_at = _x0_fn(
        model, sched, num_steps, scfg, x_T, context, uncond_context, reference_latent,
        pose_hint, parameterization, generator)
    x = x_T.float()
    x0_prev = None
    for i in range(num_steps):
        x0 = x0_at(x, int(ts[i]))
        h = lambdas[i + 1] - lambdas[i]
        d = x0
        if x0_prev is not None:  # the second-order correction
            r = (lambdas[i] - lambdas[i - 1]) / _pos(h)
            d = x0 + (x0 - x0_prev) / float(_pos(_F(2.0) * r))
        x = (float(sigmas[i + 1] / sigmas[i]) * x
             - float(alphas[i + 1] * np.expm1(-h)) * d)
        x0_prev = x0
    return x0_prev


@torch.inference_mode()
def dpmpp_3m_sample(
    model,
    sched: DiffusionSchedule,
    num_steps: int,
    scfg: SampleConfig,
    x_T: torch.Tensor,
    context: torch.Tensor,
    uncond_context: Optional[torch.Tensor] = None,
    *,
    reference_latent: Optional[torch.Tensor] = None,
    pose_hint: Optional[torch.Tensor] = None,
    parameterization: Parameterization = Parameterization.EPS,
    sde_eta: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Third-order multistep DPM-Solver++, an SDE with churn `sde_eta` > 0.

    Per step (h = lambda_{i+1} - lambda_i, h_eta = h (1 + eta)):

        x <- (sigma_{i+1} / sigma_i) e^{h - h_eta} x - alpha_{i+1} expm1(-h_eta) x0
             + alpha_{i+1} corr  [+ sigma_{i+1} sqrt(-expm1(-2 eta h)) xi]

    with phi_2 = expm1(-h_eta) / h_eta + 1, phi_3 = phi_2 / h_eta - 0.5 and
    corr = 0, phi_2 d1_0, or phi_2 d1 - phi_3 d2 by history depth 0, 1, 2
    (d: finite differences of the last three x0 predictions over lambda).
    xi is drawn from `generator`. Returns the last x0 prediction."""
    (ts, alphas, sigmas, lambdas), x0_at = _x0_fn(
        model, sched, num_steps, scfg, x_T, context, uncond_context, reference_latent,
        pose_hint, parameterization, generator)
    eta = _F(sde_eta)
    x = x_T.float()
    x0_1 = x0_2 = None
    for i in range(num_steps):
        x0 = x0_at(x, int(ts[i]))
        h = lambdas[i + 1] - lambdas[i]
        h_eta = h * (_F(1.0) + eta)
        phi_1 = np.expm1(-h_eta)
        phi_2 = phi_1 / _pos(h_eta) + _F(1.0)
        phi_3 = phi_2 / _pos(h_eta) - _F(0.5)
        x = (float(sigmas[i + 1] / sigmas[i] * np.exp(h - h_eta)) * x
             - float(alphas[i + 1] * phi_1) * x0)
        depth = min(i, 2)
        if depth >= 1:
            r0 = (lambdas[i] - lambdas[i - 1]) / _pos(h)
            d1_0 = (x0 - x0_1) / float(_pos(r0))
            if depth == 1:
                corr = float(phi_2) * d1_0
            else:
                r1 = (lambdas[i - 1] - lambdas[i - 2]) / _pos(h)
                d1_1 = (x0_1 - x0_2) / float(_pos(r1))
                d1 = d1_0 + (d1_0 - d1_1) * float(r0) / float(r0 + r1)
                d2 = (d1_0 - d1_1) / float(r0 + r1)
                corr = float(phi_2) * d1 - float(phi_3) * d2
            x = x + float(alphas[i + 1]) * corr
        if eta > 0:
            churn = np.sqrt(-np.expm1(_F(-2.0) * eta * h))
            xi = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
            x = x + float(sigmas[i + 1] * churn) * xi
        x0_1, x0_2 = x0, x0_1
    return x0_1
