"""Flax-style random initialisation of the port's networks.

What the JAX package's `model.init` / `vae.init` / `clip.init` draw (its
training CLI's start without a checkpoint), leaf by leaf, from the same
families:

  * Dense and Conv kernels: `lecun_normal`, a normal truncated at two
    standard units, std = 1 / sqrt(fan_in) / 0.87962566, where fan_in is
    counted in the Flax layout -- H * W * I of an HWIO kernel, `in` of an
    (in, out) Dense kernel -- through the converter's transposes
    (`convert.from_jax.convert_leaf`), whatever the port's OIHW / (out, in)
    layout; zeros where the JAX module says `zero_init=True` (the layers
    built with `zero_init=True` here: a ResBlock's and the UNet's `conv_out`,
    the transformers' `proj_out`, the ControlNet's zero convs and hint
    output), so the UNet output and the ControlNet residuals are exactly zero
    at step 0;
  * biases: zeros; GroupNorm and LayerNorm: ones and zeros;
  * CLIP's token embedding: Flax's default `Embed` init, a normal with
    std = 1 / sqrt(features) (variance scaling over the fan-in, out_axis 0);
    its position embedding: `normal(0.02)`.

The values are drawn on the parameters' device from an explicit
`torch.Generator`, so they are not JAX's numbers: the distributions are.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from magicdance_tpu_torch.convert.from_jax import KERNEL_MODULES

# std of the standard normal truncated to [-2, 2]
TRUNC_STD = 0.87962566103423978


def flax_kernel_shape(module: nn.Module, shape) -> tuple:
    """The Flax shape of a port kernel: (out, in) -> (in, out),
    O I *spatial -> *spatial I O (`convert_leaf`'s inverse)."""
    shape = tuple(shape)
    if isinstance(module, nn.Linear):
        return shape[::-1]
    return shape[2:] + (shape[1], shape[0])


def lecun_std(module: nn.Module, shape) -> float:
    """std of the normal (before truncation) of `lecun_normal` for a kernel
    of `module`: 1 / sqrt(fan_in) / 0.8796, fan_in = product of every Flax
    axis but the last."""
    fan_in = math.prod(flax_kernel_shape(module, shape)[:-1])
    return 1.0 / math.sqrt(fan_in) / TRUNC_STD


@torch.no_grad()
def flax_init_(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of `net` in place (see the module docstring);
    returns `net`. Raises on a parameter no rule covers."""
    for owner, sub in net.named_modules():
        for name, p in sub.named_parameters(recurse=False):
            if isinstance(sub, KERNEL_MODULES) and name == "weight":
                if getattr(sub, "zero_init", False):
                    p.zero_()
                else:
                    std = lecun_std(sub, p.shape)
                    nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std,
                                          generator=generator)
            elif name == "bias":
                p.zero_()
            elif isinstance(sub, (nn.GroupNorm, nn.LayerNorm)) and name == "weight":
                p.fill_(1.0)
            elif isinstance(sub, nn.Embedding) and name == "weight":
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[-1]), generator=generator)
            elif name == "position_embedding":
                p.normal_(0.0, 0.02, generator=generator)
            else:
                raise ValueError(f"no Flax init rule for {owner}.{name} of "
                                 f"{type(sub).__name__}")
    return net
