"""Model-output parameterizations the sampler needs.

The part of `magicdance_tpu.models.diffusion` that sampling uses: turning a
denoiser output into eps. Training losses come with the training slice.
"""

from __future__ import annotations

import torch

from magicdance_tpu_torch.config import Parameterization
from magicdance_tpu_torch.ops.schedules import DiffusionSchedule, predict_eps_from_v


def output_to_eps(parameterization: Parameterization, sched: DiffusionSchedule,
                  model_out: torch.Tensor, x_t: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
    """eps from the denoiser output: unchanged for eps-prediction, converted
    for v-prediction (ref ddim.py:608-631), as the JAX sampler's `to_eps`."""
    if parameterization is Parameterization.V:
        return predict_eps_from_v(sched, x_t, t, model_out)
    return model_out
