"""Weight-only int8 storage of frozen parameters: the format and its use.

A quantized leaf holds int8 values with one fp32 scale per output channel,
symmetric: scale = max(max|w|, 1e-8) / 127 over every other axis, q =
clip(round(w / scale), -127, 127). At use the layer dequantizes, as JAX's
`dequantize_tree(..., dtype=bf16)`: q.float() * scale, rounded to bf16,
then cast to the compute dtype -- so an fp32 network (the VAE, CLIP, an fp32
denoiser) computes with bf16-rounded values too. Products still run in the
compute dtype: only the storage changes.

The output channel is the Flax leaf's last axis (JAX reduces over all the
others); in the port's layout that is dim 0 of a Linear or Conv weight
((out, in), OIHW) and the last dim of an embedding or the CLIP position
embedding, as the converter's per-leaf rules say
(`convert.from_jax.flax_last_dim`).

In a module, a quantized leaf `<name>` becomes an int8 parameter of the same
name and shape and an fp32 parameter `<name>_scale` (the scale with the
reduced dims kept as 1), both without gradient: a state dict (checkpoint)
holds q and scale, as a JAX `TrainState` holds its `QuantizedLeaf(q,
scale)`. Each layer dequantizes its own leaves at use (`param_at`), so no
dequantized copy of the whole frozen set is ever held. JAX left the
dequantization to XLA; here it is plain torch ops. Which leaves are
quantized is the trainer's policy (`train/quant.py`).
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

SCALE_SUFFIX = "_scale"


def quantize(w: torch.Tensor, keep_dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 q, fp32 scale) of `w`, one scale per index of `keep_dim` (the
    output channel); the scale keeps the reduced dims as size 1."""
    w = w.detach().float()
    dims = tuple(d for d in range(w.dim()) if d != keep_dim % w.dim())
    amax = w.abs().amax(dim=dims, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """q * scale in `dtype` (bf16 by default, as JAX's `dequantize_tree`). A
    tensor-parallel leaf (DTensor) is dequantized on each rank's shard: a
    column-parallel q and its scale share their split of the output
    channels, a row-parallel q keeps every channel's scale."""
    from torch.distributed.tensor import DTensor

    if isinstance(q, DTensor):
        s = scale.to_local() if isinstance(scale, DTensor) else scale
        w = dequantize(q.to_local(), s, dtype)
        return DTensor.from_local(w, q.device_mesh, q.placements, run_check=False)
    return (q.float() * scale).to(dtype)


def is_quantized(module: nn.Module, name: str) -> bool:
    """Whether `module.<name>` holds int8 storage."""
    p = module._parameters.get(name)
    return p is not None and p.dtype == torch.int8 and (name + SCALE_SUFFIX) in module._parameters


def is_scale(module: nn.Module, name: str) -> bool:
    """Whether `module.<name>` is the scale of an int8 leaf."""
    return name.endswith(SCALE_SUFFIX) and is_quantized(module, name[:-len(SCALE_SUFFIX)])


def param_at(module: nn.Module, name: str, dtype: torch.dtype) -> torch.Tensor:
    """`module.<name>` in `dtype` at use: an int8 leaf is dequantized to bf16
    first (JAX's values), any other leaf is cast."""
    p = getattr(module, name)
    if p.dtype == torch.int8:
        return dequantize(p, getattr(module, name + SCALE_SUFFIX)).to(dtype)
    return p.to(dtype)


@torch.no_grad()
def quantize_param_(module: nn.Module, name: str, keep_dim: int) -> None:
    """Replace the float leaf `module.<name>` by int8 storage in place."""
    q, scale = quantize(getattr(module, name), keep_dim)
    setattr(module, name, nn.Parameter(q, requires_grad=False))
    module.register_parameter(name + SCALE_SUFFIX, nn.Parameter(scale, requires_grad=False))


@torch.no_grad()
def unquantize_(net: nn.Module) -> None:
    """Every int8 leaf of `net` back to an fp32 parameter of its dequantized
    values (q * scale), before new float weights are written over it."""
    for sub in net.modules():
        for name in [n for n in sub._parameters if is_quantized(sub, n)]:
            scale = sub._parameters.pop(name + SCALE_SUFFIX)
            setattr(sub, name, nn.Parameter(dequantize(sub._parameters[name], scale,
                                                       torch.float32)))


@torch.no_grad()
def match_(net: nn.Module, state: Mapping[str, torch.Tensor]) -> None:
    """Give `net` int8 storage wherever `state` holds an int8 leaf with its
    scale (a quantized checkpoint, a JAX int8 TrainState), so that a strict
    load of `state` fits; the values come with the load."""
    for key, t in state.items():
        if t.dtype != torch.int8 or key + SCALE_SUFFIX not in state:
            continue
        owner, _, name = key.rpartition(".")
        sub = net.get_submodule(owner)
        if not is_quantized(sub, name):
            dev = getattr(sub, name).device
            setattr(sub, name, nn.Parameter(torch.zeros_like(t, device=dev),
                                            requires_grad=False))
            sub.register_parameter(name + SCALE_SUFFIX, nn.Parameter(
                torch.zeros_like(state[key + SCALE_SUFFIX], device=dev), requires_grad=False))


def has_quantized(net_or_state) -> bool:
    """Whether a module or a state dict holds an int8 leaf."""
    if isinstance(net_or_state, nn.Module):
        return any(p.dtype == torch.int8 for p in net_or_state.parameters())
    return any(t.dtype == torch.int8 for t in net_or_state.values())


def dequantize_state_dict(state: Mapping[str, torch.Tensor],
                          dtype: torch.dtype = torch.bfloat16) -> dict[str, torch.Tensor]:
    """A state dict with each int8 leaf and its scale replaced by the
    dequantized values (bf16 by default), for a module without int8 storage
    (e.g. a sampling pipeline)."""
    out = {}
    for key, t in state.items():
        if key.endswith(SCALE_SUFFIX) and key[:-len(SCALE_SUFFIX)] in state \
                and state[key[:-len(SCALE_SUFFIX)]].dtype == torch.int8:
            continue
        scale: Optional[torch.Tensor] = state.get(key + SCALE_SUFFIX)
        out[key] = dequantize(t, scale, dtype) if t.dtype == torch.int8 and scale is not None else t
    return out


def storage_bytes(nets, trainable: Mapping[str, torch.Tensor] = ()) -> int:
    """Bytes of the parameters of `nets` that are not in `trainable` (the
    frozen storage: int8 values and their scales, or bf16/fp32 weights)."""
    skip = {id(p) for p in dict(trainable).values()}
    return sum(p.numel() * p.element_size() for net in nets for p in net.parameters()
               if id(p) not in skip)
