"""Device mesh, ZeRO-1 layout and the tensor-parallel plan on torch.distributed.

Counterpart of `magicdance_tpu.parallel.mesh`:

  reference / JAX                          here
  ---------------                          ----
  Mesh over every device                   `make_mesh`: a DeviceMesh over the
                                           ranks of the process group
  batch sharded on 'data'                  each rank keeps its rows of the
                                           global batch (`MeshAxis.rows`)
  XLA's gradient psum                      `MeshAxis.all_reduce` of the
                                           gradients in buckets (trainer)
  zero1_sharding of the moments + EMA      `zero1_spec` per leaf: the axis
                                           each rank holds a slice of
  tensor_parallel_shardings ('model')      `tensor_parallel_plan`: Colwise /
                                           RowwiseParallel on the Linear layers

The collectives are the ones gloo and NCCL both offer (all_reduce,
all_gather, broadcast, barrier). gloo takes no CUDA tensor for all_gather,
so `MeshAxis` stages every collective of a gloo group on a CUDA tensor
through host memory (two ranks sharing one card); NCCL groups and CPU
tensors go straight through.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn


def make_mesh(axes: Sequence[str] = ("data",), shape: Optional[Sequence[int]] = None):
    """A DeviceMesh over every rank of the initialized process group. The
    default shape puts every rank on the first axis; several axes lay the
    ranks out row-major (the last axis varies fastest), as JAX's mesh does.
    Its device type is the group's: "cuda" under NCCL, else "cpu"."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.multihost.initialize_distributed)")
    axes = tuple(axes)
    n = dist.get_world_size()
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes) or int(torch.tensor(shape).prod()) != n:
        raise ValueError(f"mesh shape {shape} for axes {axes} does not cover {n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=axes)


class MeshAxis:
    """One axis of a mesh as a process group: this rank's index along it,
    the axis size and the collectives over it. `MeshAxis.single()` is the
    one-process axis (rank 0 of 1, no group): every collective is the
    identity."""

    def __init__(self, mesh=None, name: str = "data"):
        if mesh is None:
            self.group, self.rank, self.size, self.backend = None, 0, 1, None
            return
        dim = mesh.mesh_dim_names.index(name)
        self.group = mesh.get_group(mesh_dim=dim)
        self.rank = mesh.get_local_rank(mesh_dim=dim)
        self.size = mesh.shape[dim]
        self.backend = dist.get_backend(self.group)

    @classmethod
    def single(cls) -> "MeshAxis":
        return cls(None)

    def rows(self, n: int) -> tuple[int, int]:
        """[start, stop) of this rank's share of n rows (`torch.tensor_split`'s
        split: the first n % size ranks take one more)."""
        base, extra = divmod(n, self.size)
        start = self.rank * base + min(self.rank, extra)
        return start, start + base + (1 if self.rank < extra else 0)

    def _buffer(self, t: torch.Tensor) -> torch.Tensor:
        """`t`, or the contiguous buffer a collective takes in its place:
        host memory for a CUDA tensor under gloo (gloo takes no CUDA tensor
        for all_gather, so every gloo collective on the card is staged
        alike)."""
        if self.backend == "gloo" and t.is_cuda:
            return t.cpu().contiguous()
        return t if t.is_contiguous() else t.contiguous()

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the axis, in place; returns it."""
        if self.group is not None:
            buf = self._buffer(t)
            dist.all_reduce(buf, group=self.group)
            if buf is not t:
                t.copy_(buf)
        return t

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's `t` (same shape on every rank), in rank order."""
        if self.group is None:
            return [t]
        buf = self._buffer(t)
        out = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(out, buf, group=self.group)
        return [o.to(t.device) for o in out]

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """`t` of the axis' rank `src` on every rank, in place; returns it."""
        if self.group is not None:
            buf = self._buffer(t)
            dist.broadcast(buf, src=dist.get_global_rank(self.group, src), group=self.group)
            if buf is not t:
                t.copy_(buf)
        return t

    def gather_rows(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """The full (n, ...) tensor from every rank's `rows(n)` share `t`:
        shares padded to the largest, gathered, trimmed and concatenated."""
        if self.group is None:
            return t
        most = -(-n // self.size)
        pad = t.new_zeros((most,) + tuple(t.shape[1:]))
        pad[: t.shape[0]] = t
        parts = self.all_gather(pad)
        counts = [n // self.size + (1 if r < n % self.size else 0) for r in range(self.size)]
        return torch.cat([p[:c] for p, c in zip(parts, counts)])


def as_axis(axis_or_mesh, name: str = "data") -> MeshAxis:
    """A MeshAxis from a DeviceMesh (its `name` axis), a MeshAxis, or None
    (the one-process axis)."""
    if axis_or_mesh is None:
        return MeshAxis.single()
    if isinstance(axis_or_mesh, MeshAxis):
        return axis_or_mesh
    return MeshAxis(axis_or_mesh, name)


# ---------------------------------------------------------------------------
# ZeRO-1
# ---------------------------------------------------------------------------

# port axis i of a Linear / Conv2d / Conv3d weight is Flax kernel axis
# _TO_FLAX[ndim][i] ((out, in) <- (in, out); OIHW <- HWIO; OIDHW <- DHWIO)
_TO_FLAX = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def zero1_spec(shape: Sequence[int], n: int) -> Optional[int]:
    """The axis ZeRO-1 shards a leaf of this shape along over n ranks, or
    None (replicated): the largest axis divisible by n, the first of equal
    ones (JAX `_zero1_spec`). Scalars and small indivisible biases stay
    whole."""
    shape = tuple(shape)
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % n == 0 and shape[i] >= n:
            return i
    return None


def kernel_zero1_axis(shape: Sequence[int], n: int) -> Optional[int]:
    """`zero1_spec` of a Linear / Conv weight taken in the Flax kernel's
    layout and mapped back to the port's axes, so that the port shards the
    same elements as the JAX package (ties between equal axes go as there)."""
    perm = _TO_FLAX.get(len(shape))
    if perm is None:
        return zero1_spec(shape, n)
    flax_shape = [0] * len(shape)
    for i, a in enumerate(perm):
        flax_shape[a] = shape[i]
    ax = zero1_spec(flax_shape, n)
    return None if ax is None else perm.index(ax)


def zero1_sharding(module: nn.Module, keys: Sequence[str], n: int) -> dict[str, Optional[int]]:
    """{parameter key: the axis ZeRO-1 shards its optimizer state along over
    n ranks, or None} for `keys` of `module` (JAX `zero1_sharding`)."""
    out = {}
    for key in keys:
        owner_name, _, leaf = key.rpartition(".")
        owner = module.get_submodule(owner_name)
        shape = tuple(owner.get_parameter(leaf).shape)
        kernel = leaf == "weight" and isinstance(owner, (nn.Linear, nn.Conv2d, nn.Conv3d))
        out[key] = kernel_zero1_axis(shape, n) if kernel else zero1_spec(shape, n)
    return out


def replicated(keys: Sequence[str]) -> dict[str, Optional[int]]:
    """Every key whole on every rank (JAX `replicated_like`)."""
    return {k: None for k in keys}


def batch_sharding(mesh, axis: str = "data") -> MeshAxis:
    """The axis whose ranks split the leading (batch) dim of every array:
    each keeps its `rows` of the global batch."""
    return as_axis(mesh, axis)


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

# the JAX package's parameter-path rules (mesh.py:108-114): attention QKV and
# the GEGLU input projection inside 'ff' are column-parallel (their output
# features shard), the attention output and the GEGLU output projection are
# row-parallel (their input features shard, the partial sums are all-reduced)
_TP_COL = ("to_q", "to_k", "to_v", "q_proj", "k_proj", "v_proj", "fc1")
_TP_ROW = ("to_out", "out_proj", "fc2")
_TP_FF_COL = ("proj_in",)
_TP_FF_ROW = ("proj_out",)


def _tp_kind(path: Sequence[str]) -> Optional[str]:
    parent = path[-2] if len(path) >= 2 else ""
    in_ff = len(path) >= 3 and path[-3] == "ff"
    if parent in _TP_COL or (in_ff and parent in _TP_FF_COL):
        return "col"
    if parent in _TP_ROW or (in_ff and parent in _TP_FF_ROW):
        return "row"
    return None


def tp_spec(path: Sequence[str], shape: Sequence[int], n: int) -> Optional[int]:
    """The dim of the port's tensor at `path` (its state-dict key split on
    ".") that the 'model' axis of size n shards, or None. JAX's
    `_tp_spec` through the (in, out) -> (out, in) map: a column-parallel
    weight shards dim 0, a row-parallel one dim 1, a column-parallel bias
    dim 0; convolutions, norms and embeddings stay replicated."""
    kind = _tp_kind(path)
    if path[-1] == "weight" and len(shape) == 2:
        if kind == "col" and shape[0] % n == 0:
            return 0
        if kind == "row" and shape[1] % n == 0:
            return 1
        return None
    if path[-1] == "bias" and kind == "col" and len(shape) >= 1 and shape[-1] % n == 0:
        return 0
    return None


@torch.no_grad()
def _pair_geglu_rows(proj_in: nn.Linear, n: int) -> None:
    """Reorder a GEGLU input projection's 2 x inner output rows as n blocks
    of [value block r; gate block r], so that a column split hands rank r
    the value and gate features its row-parallel `proj_out` slice needs
    (`GEGLUFeedForward.forward` splits its local output in halves)."""
    inner = proj_in.out_features // 2
    b = inner // n
    order = torch.cat([torch.cat([torch.arange(r * b, (r + 1) * b),
                                  inner + torch.arange(r * b, (r + 1) * b)])
                       for r in range(n)])
    proj_in.weight.copy_(proj_in.weight[order])
    if proj_in.bias is not None:
        proj_in.bias.copy_(proj_in.bias[order])
    scale = getattr(proj_in, "weight_scale", None)  # an int8 weight's (models.quant)
    if scale is not None:
        scale.copy_(scale[order])


def tensor_parallel_plan(module: nn.Module, mesh) -> dict:
    """Shard `module`'s attention and GEGLU Linear layers over the mesh's
    'model' axis (Megatron column / row parallelism, the JAX package's
    `tensor_parallel_shardings`), in place. Every layer hands back a plain
    local tensor (`use_local_output=True`): a DTensor never reaches a kernel
    wrapper, and an attention sees its rank's heads. A GEGLU pair is sharded
    only when its inner width divides by the axis (its rows are paired
    first); the module then computes the same function only under this
    plan. An int8 weight (`models.quant`) shards like a float one; its
    per-output-channel scale goes with the column split and stays whole on
    every rank under the row split. Returns the plan ({module name: style})."""
    from torch.distributed.tensor.parallel import (
        ColwiseParallel,
        RowwiseParallel,
        parallelize_module,
    )

    tp_mesh = mesh["model"]
    n = tp_mesh.size()
    plan = {}
    for name, sub in module.named_modules():
        if isinstance(sub, nn.Linear):
            dim = tp_spec(tuple(name.split(".")) + ("weight",), tuple(sub.weight.shape), n)
            if dim is not None:
                plan[name] = dim
    for ff in {name.rpartition(".")[0] for name in plan if name.endswith(("ff.proj_in",
                                                                           "ff.proj_out"))}:
        pin, pout = ff + ".proj_in", ff + ".proj_out"
        if pin in plan and pout in plan and (module.get_submodule(pin).out_features // 2) % n == 0:
            _pair_geglu_rows(module.get_submodule(pin), n)
        else:
            plan.pop(pin, None)
            plan.pop(pout, None)
    styles = {name: ColwiseParallel() if dim == 0 else RowwiseParallel()
              for name, dim in plan.items()}
    parallelize_module(module, tp_mesh, styles)
    return styles
