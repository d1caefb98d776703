"""Carry the JAX package's parameters into the port's modules.

The port names its submodules after the Flax module names, so conversion is
a walk over the Flax tree with one rule per leaf name:

  * Dense `kernel` (in, out)        -> Linear `weight` (out, in)
  * Conv `kernel` HWIO              -> Conv2d `weight` OIHW
  * Conv `kernel` DHWIO             -> Conv3d `weight` OIDHW
  * norm `scale`, Embed `embedding` -> `weight`
  * BatchNormInference `mean`/`var` -> `running_mean`/`running_var` (the
    metric nets' inference BatchNorm, `metrics.i3d.BatchNormInference`)
  * anything else (`bias`, `position_embedding`) keeps its name and layout.

The motion modules (`enc_motion_*`, `dec_motion_*`) are Dense, LayerNorm
and GroupNorm leaves too, so they cross by the same rules.

Input: the JAX pipeline's {"model", "vae", "clip"} variables, each
{"params": {...}} (or the bare param tree), with numpy arrays as leaves; or a
JAX trainer's `TrainState` (`load_train_state`), whose trainable and frozen
denoiser trees are flat {path tuple: array} dicts.
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


def flax_key(path: tuple) -> str:
    """The port's state-dict key of the Flax leaf at `path`."""
    *mods, name = (str(p) for p in path)
    if name in ("kernel", "scale", "embedding"):
        name = "weight"
    elif name in ("mean", "var"):
        name = f"running_{name}"
    return ".".join(mods + [name])


def convert_leaf(path: tuple, leaf) -> tuple[str, torch.Tensor]:
    """One Flax leaf at `path` -> (state-dict key, fp32 tensor)."""
    a = np.asarray(leaf, dtype=np.float32)
    if str(path[-1]) == "kernel":
        if a.ndim == 5:
            a = a.transpose(4, 3, 0, 1, 2)
        elif a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 2:
            a = a.T
        else:
            raise ValueError(f"unexpected kernel rank {a.ndim} at {'/'.join(map(str, path))}")
    return flax_key(path), torch.tensor(a)


def flax_to_state_dict(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A Flax variables tree -> a state dict for the matching port module."""
    tree = variables["params"] if "params" in variables else variables
    return dict(convert_leaf(path, leaf) for path, leaf in _flatten(tree))


def flat_to_state_dict(flat: Mapping[tuple, Any]) -> dict[str, torch.Tensor]:
    """A flat {path tuple: array} dict (the JAX trainer's partition of the
    denoiser params) -> state-dict entries."""
    return dict(convert_leaf(path, leaf) for path, leaf in flat.items())


def load_train_state(trainer, state) -> None:
    """Carry a JAX `TrainState` into a port `Trainer`: its trainable and
    frozen denoiser params, the frozen VAE and CLIP, the EMA params when
    present, and the step. (The optimizer moments are not carried: a
    carried state restarts AdamW from zero moments.)"""
    model = {**flat_to_state_dict(state.train_params),
             **flat_to_state_dict(state.frozen_params["model"])}
    trainer.load_state_dicts(model, flax_to_state_dict(state.frozen_params["vae"]),
                             flax_to_state_dict(state.frozen_params["clip"]))
    if state.ema_params is not None:
        trainer.set_ema(flat_to_state_dict(state.ema_params))
    trainer.step = int(np.asarray(state.step))


def load_flax_params(module: nn.Module, variables: Mapping[str, Any]) -> None:
    """Copy a Flax variables tree into `module` (strict: every parameter of
    the module is set and no leaf is left over); values are cast to each
    parameter's dtype and device."""
    module.load_state_dict(flax_to_state_dict(variables), strict=True)
