"""Model-output parameterizations and the training loss.

Counterpart of `magicdance_tpu.models.diffusion`: turning a denoiser output
into eps (the sampler) and `diffusion_loss`, the reference's p_losses chain
(ddpm.py:2165-2212, :382-412): noise the target latent at t, optionally noise
the reference latent (skipped under `wonoise`), run the composite denoiser,
and take the weighted l2/l1 error against the eps / x0 / v target, plus the
`lvlb` term when `original_elbo_weight` > 0.

The random draws are separate from the loss: `draw_timesteps_and_noise`
draws t and the noise from a torch.Generator (the trainer's), and
`diffusion_loss` takes them as arguments, so a test can hand it the JAX
package's draws (jax.random and torch give different numbers).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from magicdance_tpu_torch.config import DiffusionConfig, Parameterization
from magicdance_tpu_torch.ops.schedules import (
    DiffusionSchedule,
    get_v,
    predict_eps_from_v,
    q_sample,
)


def output_to_eps(parameterization: Parameterization, sched: DiffusionSchedule,
                  model_out: torch.Tensor, x_t: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
    """eps from the denoiser output: unchanged for eps-prediction, converted
    for v-prediction (ref ddim.py:608-631), as the JAX sampler's `to_eps`."""
    if parameterization is Parameterization.V:
        return predict_eps_from_v(sched, x_t, t, model_out)
    return model_out


def draw_timesteps_and_noise(sched: DiffusionSchedule, x_start: torch.Tensor,
                             generator: Optional[torch.Generator] = None,
                             num_frames: int = 1):
    """t ~ U{0, ..., T-1} per sample and standard-normal noise like x_start,
    on x_start's device. With num_frames > 1 the batch holds clips of that
    many frames (clip major) and each clip draws one timestep, shared by its
    frames (the AnimateDiff convention, JAX diffusion.py:43-52)."""
    b = x_start.shape[0]
    t = torch.randint(0, sched.num_timesteps, (b // num_frames,), generator=generator,
                      device=x_start.device).repeat_interleave(num_frames)
    noise = torch.randn(x_start.shape, generator=generator, device=x_start.device,
                        dtype=x_start.dtype)
    return t, noise


def diffusion_loss(
    apply_fn: Callable[..., torch.Tensor],
    sched: DiffusionSchedule,
    dcfg: DiffusionConfig,
    x_start: torch.Tensor,
    context: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
    *,
    reference_latent: Optional[torch.Tensor] = None,
    pose_hint: Optional[torch.Tensor] = None,
    wonoise: bool = True,
    ref_noise: Optional[torch.Tensor] = None,
    num_frames: int = 1,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One training loss evaluation at the given timesteps `t` (B,) and
    `noise` (like x_start). apply_fn(x_noisy, t, context, reference_noisy=,
    pose_hint=, num_frames=) -> model output. Without `wonoise` the reference
    latent is noised with `ref_noise` at its sample's (or clip's) timestep.
    `num_frames`: frames per clip of a temporal batch (B = clips x frames)."""
    b = x_start.shape[0]
    x_noisy = q_sample(sched, x_start, t, noise)

    reference_noisy = None
    if reference_latent is not None:
        if wonoise:
            reference_noisy = reference_latent
        else:
            if ref_noise is None:
                raise ValueError("wonoise=False needs ref_noise")
            stride = max(1, t.shape[0] // reference_latent.shape[0])
            t_ref = t[::stride][: reference_latent.shape[0]]
            reference_noisy = q_sample(sched, reference_latent, t_ref, ref_noise)

    model_out = apply_fn(x_noisy, t, context, reference_noisy=reference_noisy,
                         pose_hint=pose_hint, num_frames=num_frames)

    if dcfg.parameterization is Parameterization.EPS:
        target = noise
    elif dcfg.parameterization is Parameterization.X0:
        target = x_start
    else:
        target = get_v(sched, x_start, noise, t)

    diff = model_out.float() - target.float()
    err = diff.abs() if dcfg.loss_type == "l1" else diff ** 2
    loss_simple = err.reshape(b, -1).mean(dim=1)

    loss = dcfg.l_simple_weight * loss_simple.mean()
    metrics = {"loss_simple": loss_simple.mean().detach(),
               "t_mean": t.float().mean()}
    if dcfg.original_elbo_weight > 0:
        w = sched.lvlb_weights.to(loss_simple.device)[t.long()]
        lvlb = (w * loss_simple).mean()
        loss = loss + dcfg.original_elbo_weight * lvlb
        metrics["loss_vlb"] = lvlb.detach()
    metrics["loss"] = loss.detach()
    return loss, metrics
