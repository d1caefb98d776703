"""Exact DDIM sampling (PyTorch).

Counterpart of `magicdance_tpu.sampling.ddim` without the turbo levers: the
JAX `lax.scan` becomes a Python loop over the steps. Per step, in order: the
appearance-UNet write pass on the (batch-1) reference latent, the pose
ControlNet, the main-UNet cond pass reading the bank, the CFG uncond pass
and the DDIM update. All frames of a request are one batch and the bank is
computed once per step for the whole batch. Reference quirks kept:
`wonoise=True` feeds the clean reference latent to the write pass every
step; `controlnet_important` makes the uncond pass a vanilla SD forward.
"""

from __future__ import annotations

from typing import Optional

import torch

from magicdance_tpu_torch.config import Parameterization, SampleConfig
from magicdance_tpu_torch.models.diffusion import output_to_eps
from magicdance_tpu_torch.ops.schedules import DDIMSchedule, DiffusionSchedule, q_sample


def ddim_step(x: torch.Tensor, eps: torch.Tensor, alpha: torch.Tensor,
              alpha_prev: torch.Tensor, sqrt_one_minus_alpha: torch.Tensor,
              sigma: torch.Tensor, noise: torch.Tensor):
    """One DDIM update x_t -> x_{t-1} (ref ddim.py:633-645); the schedule
    scalars are 0-dim fp32 tensors. Returns (x_prev, pred_x0)."""
    pred_x0 = (x - sqrt_one_minus_alpha * eps) / torch.sqrt(alpha)
    dir_xt = torch.sqrt(torch.clamp(1.0 - alpha_prev - sigma**2, min=0.0)) * eps
    x_prev = torch.sqrt(alpha_prev) * pred_x0 + dir_xt + sigma * noise
    return x_prev, pred_x0


def _check_exact(scfg: SampleConfig) -> None:
    turbo = {
        "fused_cfg": scfg.fused_cfg, "cfg_interval": scfg.cfg_interval is not None,
        "uncond_every": scfg.uncond_every > 1, "pose_every": scfg.pose_every > 1,
        "deepcache_every": scfg.deepcache_every > 1, "bank_every": scfg.bank_every > 1,
        "bank_downsample": scfg.bank_downsample > 1,
        "self_kv_downsample": scfg.self_kv_downsample > 1,
    }
    on = [k for k, v in turbo.items() if v]
    if on:
        raise NotImplementedError(f"not ported yet: {', '.join(on)} "
                                  "(the port samples the exact recipe only)")
    if scfg.control_mode not in ("controlnet_important", "balance"):
        raise ValueError(f"unknown control_mode {scfg.control_mode!r}")


@torch.inference_mode()
def ddim_sample(
    model,
    sched: DiffusionSchedule,
    ddim: DDIMSchedule,
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
    """Sample latents x_0 from x_T.

    model: a MagicPoseModel. x_T: (B, h, w, 4); context / uncond_context:
    (1 or B, 77, context_dim); reference_latent: (Br, h, w, 4), Br in {1, B};
    pose_hint: (B, H, W, 3). `generator` supplies the noise when eta > 0 or
    wonoise is off; with the default recipe the sampler draws nothing."""
    _check_exact(scfg)
    B = x_T.shape[0]
    use_cfg = scfg.cfg_scale != 1.0 and uncond_context is not None
    has_appearance = reference_latent is not None and model.cfg.has_appearance

    def tile(c):
        if c is None:
            return None
        return c.expand(B, *c.shape[1:]) if c.shape[0] == 1 else c

    ctx, uctx = tile(context), tile(uncond_context)
    ref_ctx = context[:1]
    S = ddim.num_steps
    x = x_T.float()
    for i in range(S):
        step = S - 1 - i  # descending t
        t_scalar = int(ddim.timesteps[step])
        t = torch.full((B,), t_scalar, dtype=torch.int64, device=x.device)

        bank = None
        if has_appearance:
            t_ref = torch.full((reference_latent.shape[0],), t_scalar,
                               dtype=torch.int64, device=x.device)
            if scfg.wonoise:
                ref_noisy = reference_latent
            else:
                ref_noise = torch.randn(reference_latent.shape, generator=generator,
                                        device=x.device, dtype=reference_latent.dtype)
                ref_noisy = q_sample(sched, reference_latent, t_ref, ref_noise)
            bank = model.compute_bank(ref_noisy, t_ref, ref_ctx)

        eps_c = output_to_eps(parameterization, sched,
                              model(x, t, ctx, bank=bank, pose_hint=pose_hint), x, t)
        if use_cfg:
            if scfg.control_mode == "balance":
                # the uncond pass keeps both control branches and swaps only
                # the text conditioning
                out_u = model(x, t, uctx, bank=bank, pose_hint=pose_hint)
            else:  # controlnet_important: vanilla SD uncond
                out_u = model(x, t, uctx, uc=True)
            eps_u = output_to_eps(parameterization, sched, out_u, x, t)
            eps = eps_u + scfg.cfg_scale * (eps_c - eps_u)
        else:
            eps = eps_c

        if scfg.eta > 0:
            noise = torch.randn(x.shape, generator=generator, device=x.device,
                                dtype=x.dtype)
        else:
            noise = torch.zeros_like(x)
        x, _ = ddim_step(x, eps, ddim.alphas[step], ddim.alphas_prev[step],
                         ddim.sqrt_one_minus_alphas[step], ddim.sigmas[step], noise)
    return x
