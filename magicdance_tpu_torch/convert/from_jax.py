"""Carry the JAX package's parameters into the port's modules.

The port names its submodules after the Flax module names, so conversion is
a walk over the Flax tree with one rule per leaf name:

  * Dense `kernel` (in, out)        -> Linear `weight` (out, in)
  * Conv `kernel` HWIO              -> Conv2d `weight` OIHW
  * norm `scale`, Embed `embedding` -> `weight`
  * anything else (`bias`, `position_embedding`) keeps its name and layout.

Input: the JAX pipeline's {"model", "vae", "clip"} variables, each
{"params": {...}} (or the bare param tree), with numpy arrays as leaves.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping[str, Any], prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def flax_to_state_dict(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A Flax variables tree -> a state dict for the matching port module."""
    tree = variables["params"] if "params" in variables else variables
    out = {}
    for path, leaf in _flatten(tree):
        a = np.asarray(leaf, dtype=np.float32)
        *mods, name = path
        if name == "kernel":
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2:
                a = a.T
            else:
                raise ValueError(f"unexpected kernel rank {a.ndim} at {'/'.join(path)}")
            name = "weight"
        elif name in ("scale", "embedding"):
            name = "weight"
        out[".".join(mods + [name])] = torch.tensor(a)
    return out


def load_flax_params(module: nn.Module, variables: Mapping[str, Any]) -> None:
    """Copy a Flax variables tree into `module` (strict: every parameter of
    the module is set and no leaf is left over); values are cast to each
    parameter's dtype and device."""
    module.load_state_dict(flax_to_state_dict(variables), strict=True)
