"""Diffusion schedules and forward-process math.

Counterpart of `magicdance_tpu.ops.schedules`: the same float64 NumPy
derivation of every schedule array, stored as float32 tensors, so the port's
arrays equal the JAX package's element for element. Per-timestep gathers are
plain indexing; the arrays live on the CPU and are moved to the device of the
tensor they scale.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from magicdance_tpu_torch.config import DiffusionConfig, Parameterization


def make_beta_schedule(
    schedule: str,
    n_timestep: int,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    """Beta schedules (ref util.py:20-45). "linear" is the SD convention:
    linear in sqrt(beta) space."""
    if schedule == "linear":
        betas = (
            np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64) ** 2
        )
    elif schedule == "cosine":
        steps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(steps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = 1.0 - alphas[1:] / alphas[:-1]
        betas = np.clip(betas, 0.0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"unknown beta schedule {schedule!r}")
    return betas


class DiffusionSchedule(NamedTuple):
    """All derived schedule arrays, shape (T,), float32 on the CPU."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    lvlb_weights: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def make_schedule(cfg: DiffusionConfig) -> DiffusionSchedule:
    """Derived arrays exactly as DDPM.register_schedule (ddpm.py:138-196)."""
    betas = make_beta_schedule(
        cfg.beta_schedule,
        cfg.timesteps,
        linear_start=cfg.linear_start,
        linear_end=cfg.linear_end,
        cosine_s=cfg.cosine_s,
    )
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])

    posterior_variance = (1 - cfg.v_posterior) * betas * (
        1.0 - alphas_cumprod_prev
    ) / (1.0 - alphas_cumprod) + cfg.v_posterior * betas
    posterior_log_variance_clipped = np.log(np.maximum(posterior_variance, 1e-20))
    posterior_mean_coef1 = betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    posterior_mean_coef2 = (
        (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
    )

    if cfg.parameterization is Parameterization.EPS:
        # element 0 divides by posterior_variance[0]=0; overwritten below
        # (the reference does the same, ddpm.py:186-188)
        with np.errstate(divide="ignore"):
            lvlb_weights = betas**2 / (
                2 * posterior_variance * alphas * (1 - alphas_cumprod)
            )
        lvlb_weights[0] = lvlb_weights[1]
    elif cfg.parameterization is Parameterization.X0:
        lvlb_weights = 0.5 * np.sqrt(alphas_cumprod) / (2.0 * (1 - alphas_cumprod))
    else:  # V
        lvlb_weights = np.ones_like(betas)

    return DiffusionSchedule(
        betas=_f32(betas),
        alphas_cumprod=_f32(alphas_cumprod),
        alphas_cumprod_prev=_f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=_f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=_f32(np.sqrt(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=_f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=_f32(np.sqrt(1.0 / alphas_cumprod - 1)),
        posterior_variance=_f32(posterior_variance),
        posterior_log_variance_clipped=_f32(posterior_log_variance_clipped),
        posterior_mean_coef1=_f32(posterior_mean_coef1),
        posterior_mean_coef2=_f32(posterior_mean_coef2),
        lvlb_weights=_f32(lvlb_weights),
    )


def _extract(a: torch.Tensor, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Gather per-timestep scalars and broadcast to an image batch."""
    out = a.to(like.device)[t.to(like.device).long()]
    return out.reshape(t.shape + (1,) * (like.ndim - t.ndim))


def q_sample(sched: DiffusionSchedule, x_start: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward diffusion q(x_t | x_0) (ref ddpm.py:356-360)."""
    return (_extract(sched.sqrt_alphas_cumprod, t, x_start) * x_start
            + _extract(sched.sqrt_one_minus_alphas_cumprod, t, x_start) * noise)


def predict_eps_from_v(sched: DiffusionSchedule, x_t: torch.Tensor,
                       t: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """eps from a v-prediction (ref ddim.py:608-631)."""
    return (_extract(sched.sqrt_alphas_cumprod, t, x_t) * v
            + _extract(sched.sqrt_one_minus_alphas_cumprod, t, x_t) * x_t)


class DDIMSchedule(NamedTuple):
    """Per-sampling-step arrays, shape (S,), ordered t ascending."""

    timesteps: torch.Tensor  # int32 model timesteps
    alphas: torch.Tensor  # alpha_cumprod at each step
    alphas_prev: torch.Tensor
    sqrt_one_minus_alphas: torch.Tensor
    sigmas: torch.Tensor

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]


def make_ddim_schedule(
    sched: DiffusionSchedule,
    num_steps: int,
    eta: float = 0.0,
    method: str = "uniform",
) -> DDIMSchedule:
    """DDIM step selection + sampling parameters (util.py:47-99). Uniform:
    c = T // S, timesteps = arange(0, T, c) + 1 (the reference's +1 shift)."""
    T = int(sched.num_timesteps)
    if method == "uniform":
        c = T // num_steps
        ddim_timesteps = np.arange(0, num_steps) * c + 1
    elif method == "quad":
        ddim_timesteps = ((np.linspace(0, np.sqrt(T * 0.8), num_steps)) ** 2).astype(int) + 1
    else:
        raise ValueError(f"unknown ddim discretization {method!r}")

    acp = sched.alphas_cumprod.numpy()
    alphas = acp[ddim_timesteps]
    alphas_prev = np.concatenate([[float(acp[0])], acp[ddim_timesteps[:-1]]])
    sigmas = eta * np.sqrt(
        (1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev)
    )
    return DDIMSchedule(
        timesteps=torch.from_numpy(ddim_timesteps.astype(np.int32)),
        alphas=_f32(alphas),
        alphas_prev=_f32(alphas_prev),
        sqrt_one_minus_alphas=_f32(np.sqrt(1.0 - alphas)),
        sigmas=_f32(sigmas),
    )


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sinusoidal timestep embeddings (ref util.py:189-210).

    timesteps: (B,) int or float. Returns (B, dim): [cos | sin] halves, in
    that order, zero-padded when dim is odd."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2 == 1:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb.to(dtype)
