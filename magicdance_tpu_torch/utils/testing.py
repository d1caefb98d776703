"""Test and debug helpers.

Counterpart of `magicdance_tpu.utils.testing`, over the port's modules and
state dicts: parameters are named by their dotted state-dict keys, where the
JAX helpers join Flax paths with '/'.
"""

from __future__ import annotations

from typing import Mapping, Union

import torch
from torch import nn


@torch.no_grad()
def randomize_zero_kernels(module: nn.Module, scale: float = 0.05, seed: int = 0) -> nn.Module:
    """Replace every all-zero kernel (a parameter of >= 2 dims) of `module`
    with small random values N(0, scale^2), in place; returns the module.

    At init, zero-initialized output layers (`conv_out`, `proj_out`,
    `zero_conv*`: SD/ControlNet semantics) make the UNet output exactly zero
    and block gradient flow; real runs load pretrained weights. Tests that
    need signals and gradients to flow call this first. Each parameter in
    `named_parameters` order draws from its own generator, seeded
    `seed + its index + 1` (the JAX helper's counter)."""
    for i, (_, p) in enumerate(module.named_parameters()):
        if p.dim() >= 2 and p.is_floating_point() and not bool(p.any()):
            gen = torch.Generator(device=p.device).manual_seed(seed + i + 1)
            p.copy_(torch.randn(p.shape, generator=gen, device=p.device, dtype=p.dtype)
                    * scale)
    return module


def _flat(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> dict:
    return dict(params.state_dict()) if isinstance(params, nn.Module) else dict(params)


@torch.no_grad()
def weight_deviation(params_a, params_b, keyword: str = "") -> float:
    """Mean per-leaf squared L2 distance between two sets of parameters (a
    module or a state dict each), over the keys present in both whose name
    contains `keyword`.

    The training-drift probe of the reference (`estimate_deviation` /
    `_calc_dist`, ref train_tiktok.py:532-544): e.g. how far the appearance
    branch moved from the frozen UNet it was copied from (keyword='attn1'),
    or a trained model against its init. Keys present in only one side are
    ignored (the reference intersects keys the same way)."""
    flat_a, flat_b = _flat(params_a), _flat(params_b)
    keys = [k for k in flat_a if keyword in k and k in flat_b]
    if not keys:
        return 0.0
    total = 0.0
    for k in keys:
        a, b = flat_a[k].float(), flat_b[k].float().to(flat_a[k].device)
        total += float(((a - b) ** 2).sum())
    return total / len(keys)
