"""PLMS (pseudo linear multistep) sampler (PyTorch).

Counterpart of `magicdance_tpu.sampling.plms.plms_sample`: Adams-Bashforth
over the eps predictions, e' = (55 e_t - 59 e_{t-1} + 37 e_{t-2} - 9 e_{t-3})
/ 24 once three earlier evaluations exist, of lower order while the history
fills (JAX carries a fixed (3, ...) history and a depth counter in its scan;
here the loop knows the depth, min(i, 3), on the host), then the DDIM
update with e'. One model evaluation per step, with the exact recipe's
conditioning (`sampling.ddim.make_eps_fn`).
"""

from __future__ import annotations

from typing import Optional

import torch

from magicdance_tpu_torch.config import Parameterization, SampleConfig
from magicdance_tpu_torch.ops.schedules import DDIMSchedule, DiffusionSchedule
from magicdance_tpu_torch.sampling.ddim import ddim_step, make_eps_fn


def multistep_eps(e_t: torch.Tensor, hist: list) -> torch.Tensor:
    """The Adams-Bashforth combination of e_t and the earlier evaluations
    `hist` (most recent first) for the history depth len(hist) <= 3."""
    if len(hist) >= 3:
        return (55 * e_t - 59 * hist[0] + 37 * hist[1] - 9 * hist[2]) / 24
    if len(hist) == 2:
        return (23 * e_t - 16 * hist[0] + 5 * hist[1]) / 12
    if len(hist) == 1:
        return (3 * e_t - hist[0]) / 2
    return e_t


@torch.inference_mode()
def plms_sample(
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
    """Sample latents x_0 from x_T (B, h, w, 4) over the DDIM timesteps of
    `ddim`; arguments as `ddim_sample`'s. `generator` supplies the reference
    noise when wonoise is off; the DDIM update adds no noise."""
    B = x_T.shape[0]
    S = ddim.num_steps
    eps_at = make_eps_fn(model, sched, scfg, B, context, uncond_context, reference_latent,
                         pose_hint, parameterization, generator)
    x = x_T.float()
    hist: list = []
    for i in range(S):
        step = S - 1 - i  # descending t
        e_t = eps_at(x, int(ddim.timesteps[step]))
        x, _ = ddim_step(x, multistep_eps(e_t, hist), ddim.alphas[step], ddim.alphas_prev[step],
                         ddim.sqrt_one_minus_alphas[step], ddim.sigmas[step],
                         torch.zeros_like(x))
        hist = [e_t] + hist[:2]
    return x
