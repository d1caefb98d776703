"""One DDIM step of the serving samplers as one CUDA graph (PyTorch).

A step of the exact recipe launches thousands of kernels: the batch-1 bank
write, the ControlNet, the cond and uncond passes, CFG, the DDIM update and,
in video, the window gather and the scatter-average. Enqueued one by one
from Python they take the host longer than the card takes to run them.
`StepGraphs` captures such a step once per shape key as a
`torch.cuda.CUDAGraph` (`torch.cuda.graph`, in one memory pool per cache)
and replays it for every step of every request with that key: one launch a
step. The hand-written kernels are captured as they are launched.

Nothing that changes from step to step or from request to request is
baked into the graph. Every step, eager or replayed, reads its timestep,
its DDIM coefficients (`ddim_coefficients`) and the video window offset
from the request's tables (`StepTables`, uploaded once a request): an eager
step reads row i itself, a replayed one reads static buffers that a
device-to-device copy fills from row i. `bind` sets a request up for its
sampler: on the graph path the request's inputs (x_T, pose maps, reference
latent, contexts, added vectors) are copied once into static buffers that
the graph reads, and the latents live in one static buffer that the step
updates in place. The step, the update included (`ddim_step_table`), gives
the bits of the DDIM step with host scalars (`ddim.ddim_step`): the same
values, the same operations, in the same order.

The samplers take the graph path by what they observe (`decline_reason`),
and run a step eagerly where the device is not CUDA, grad mode is on, a
profiler records (a replay would launch its kernels outside the `md.` and
benchmark ranges that name each call), a turbo lever or fused CFG changes
the step's branches from step to step, the step draws random numbers
(eta > 0, or the reference noised without `wonoise`), or the batch is
sharded over a process group. A new key's first step runs eagerly on the
static buffers (a warm-up: kernel builds, library handles and algorithm
choices happen outside the capture), its second is captured and replayed.

A replay runs no Python: no forward hook, span or host counter sees it, as
under `torch.compile`. What the captured step's host code added to
`ops.kernels.LAUNCHES` and `models.layers.GN_SITES` is recorded at capture
and added again at every replay, so those counters still count what the card
ran. `STEP_GRAPHS` counts captures, replays, evictions and the steps run
eagerly, by reason ("eager.<reason>"). The graphs and their pool live with
the model until `release`.
"""

from __future__ import annotations

import os
from collections import Counter, OrderedDict
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from magicdance_tpu_torch.models import layers
from magicdance_tpu_torch.ops import attention
from magicdance_tpu_torch.ops.kernels.attention import LAUNCHES
from magicdance_tpu_torch.ops.schedules import DDIMSchedule

# "captures", "replays", "evictions", and steps run eagerly by reason:
# "eager.cpu", "eager.grad", "eager.profiler", "eager.turbo", "eager.noise",
# "eager.sharded", "eager.warmup" (a new key's first step), "eager.off" (the
# sampler asked not to); reset with STEP_GRAPHS.clear()
STEP_GRAPHS: Counter = Counter()

# graphs a cache keeps; the least recently used one goes first
CAPACITY = 4


def decline_reason(device: torch.device, *, turbo: bool, noise: bool,
                   sharded: bool) -> Optional[str]:
    """Why a request's steps run eagerly, or None for the graph path."""
    if torch.device(device).type != "cuda":
        return "cpu"
    if torch.is_grad_enabled():
        return "grad"
    if torch.autograd._profiler_enabled():
        return "profiler"
    if turbo:
        return "turbo"
    if noise:
        return "noise"
    if sharded:
        return "sharded"
    return None


def ddim_coefficients(ddim: DDIMSchedule) -> torch.Tensor:
    """(S, 6) fp32 on the host, one row a step in execution order (t
    descending): the scalars of `ddim.ddim_step` as it computes them from the
    host schedule, [sqrt(1 - a), sqrt(a), 1 / sqrt(a), sqrt(clamp(1 - a_prev
    - sigma^2, 0)), sqrt(a_prev), sigma]. `ddim_step_table` divides by
    sqrt(a) on the CPU and multiplies by its reciprocal on the card, which is
    how each device's kernel divides by a host scalar (a CUDA `div` by a CPU
    scalar multiplies by the reciprocal computed on the host)."""
    order = torch.arange(ddim.num_steps - 1, -1, -1)
    alpha, alpha_prev = ddim.alphas[order], ddim.alphas_prev[order]
    sigma = ddim.sigmas[order]
    sqrt_alpha = torch.sqrt(alpha)
    return torch.stack([ddim.sqrt_one_minus_alphas[order], sqrt_alpha,
                        torch.ones_like(sqrt_alpha).div(sqrt_alpha),
                        torch.sqrt(torch.clamp(1.0 - alpha_prev - sigma**2, min=0.0)),
                        torch.sqrt(alpha_prev), sigma], dim=1)


def ddim_step_table(x: torch.Tensor, eps: torch.Tensor, coef: torch.Tensor,
                    noise: torch.Tensor) -> torch.Tensor:
    """`ddim.ddim_step`'s x_prev with the step's scalars read from `coef`, a
    row of `ddim_coefficients` on x's device: the same values and operations
    in the same order, so the same bits on either device."""
    s1ma, sqrt_alpha, inv_sqrt_alpha, dir_coef, sqrt_alpha_prev, sigma = coef.unbind()
    diff = x - s1ma * eps
    pred_x0 = diff * inv_sqrt_alpha if x.is_cuda else diff / sqrt_alpha
    return sqrt_alpha_prev * pred_x0 + dir_coef * eps + sigma * noise


@dataclass
class StepValues:
    """What a step reads besides the latents: t (rows,) int64, its DDIM
    coefficients (6,) fp32 and the video window offset () int64 (or None)."""

    t: torch.Tensor
    coef: torch.Tensor
    offset: Optional[torch.Tensor] = None


@dataclass
class StepTables:
    """A request's per-step values on the device, one row a step in
    execution order: t (S, rows) int64, the DDIM coefficients (S, 6) fp32,
    and the video window offsets (S,) int64 or None."""

    t: torch.Tensor
    coef: torch.Tensor
    offset: Optional[torch.Tensor] = None

    @classmethod
    def upload(cls, ddim: DDIMSchedule, device, rows: int,
               offsets: Optional[torch.Tensor] = None):
        t = ddim.timesteps.flip(0).to(torch.int64)[:, None].expand(-1, rows)
        return cls(t.to(device).contiguous(), ddim_coefficients(ddim).to(device), offsets)

    def row(self, i: int) -> StepValues:
        return StepValues(self.t[i], self.coef[i],
                          None if self.offset is None else self.offset[i])


def _cuda_capture(body: Callable[[], None], pool) -> Callable[[], None]:
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        body()
    return graph.replay


class StepEntry:
    """One key's static buffers and, once captured, its graph. `statics`
    holds a buffer per input on `device`; `values` the step's t, DDIM
    coefficients and window offset, filled before each step."""

    def __init__(self, inputs: dict, rows: int, device, sched):
        self.statics = {k: torch.empty_like(v, device=device) for k, v in inputs.items()}
        self.values = StepValues(torch.zeros((rows,), dtype=torch.int64, device=device),
                                 torch.zeros((6,), dtype=torch.float32, device=device),
                                 torch.zeros((), dtype=torch.int64, device=device))
        # the diffusion schedule on the device (v-prediction gathers from it
        # by t; a host array would be copied to the card inside the capture),
        # beside the host one whose identity the key holds
        self.sched_host = sched
        self.sched = type(sched)(*(v.to(device) if isinstance(v, torch.Tensor) else v
                                   for v in sched))
        self.replay: Optional[Callable[[], None]] = None
        self.warm = False
        self.launches: dict = {}    # LAUNCHES increments of one step
        self.gn_sites: Counter = Counter()


class StepGraphs:
    """A bounded cache of captured steps, keyed by everything a capture
    bakes in, with one memory pool for all of them. `capture(body, pool)`
    returns the replay of `body` (tests pass a stub for the CUDA capture)."""

    def __init__(self, capacity: int = CAPACITY, capture=_cuda_capture):
        self.capacity, self.capture = capacity, capture
        self.entries: OrderedDict = OrderedDict()
        self.pool = None

    def request(self, key, inputs: dict, rows: int, device, sched) -> StepEntry:
        """The entry of `key` (made, and the oldest evicted past capacity,
        on first sight), with `inputs` copied into its static buffers. The
        key names everything the capture bakes in: `rows` timesteps a step,
        `sched` (by identity) and the shapes of `inputs` among it."""
        entry = self.entries.get(key)
        if entry is None:
            entry = self.entries[key] = StepEntry(inputs, rows, device, sched)
            while len(self.entries) > self.capacity:
                self.entries.popitem(last=False)
                STEP_GRAPHS["evictions"] += 1
        self.entries.move_to_end(key)
        for k, v in inputs.items():
            entry.statics[k].copy_(v)
        return entry

    def step(self, entry: StepEntry, tables: StepTables, i: int,
             body: Callable[[], None]) -> None:
        """Step i of a request: fill the step's buffers from row i of the
        tables, then replay the graph, or on a new key run `body` eagerly
        (its first step) or capture it and replay (its second)."""
        row, values = tables.row(i), entry.values
        values.t.copy_(row.t)
        values.coef.copy_(row.coef)
        if row.offset is not None:
            values.offset.copy_(row.offset)
        if entry.replay is None:
            if not entry.warm:
                body()
                entry.warm = True
                STEP_GRAPHS["eager.warmup"] += 1
                return
            self._capture(entry, body)
        entry.replay()
        STEP_GRAPHS["replays"] += 1
        for k, n in entry.launches.items():
            LAUNCHES[k] += n
        layers.GN_SITES.update(entry.gn_sites)

    def _capture(self, entry: StepEntry, body: Callable[[], None]) -> None:
        """Capture `body`, record what its host code added to the launch
        and GroupNorm counters, and take it back off them: the capture ran
        nothing on the card, every replay adds it."""
        if self.pool is None and self.capture is _cuda_capture:
            self.pool = torch.cuda.graph_pool_handle()
        launches, gn_sites = dict(LAUNCHES), Counter(layers.GN_SITES)
        entry.replay = self.capture(body, self.pool)
        entry.launches = {k: n - launches[k] for k, n in LAUNCHES.items() if n != launches[k]}
        entry.gn_sites = Counter(layers.GN_SITES)
        entry.gn_sites.subtract(gn_sites)
        entry.gn_sites = +entry.gn_sites
        LAUNCHES.update(launches)
        layers.GN_SITES.clear()
        layers.GN_SITES.update(gn_sites)
        STEP_GRAPHS["captures"] += 1


def graphs_of(model) -> StepGraphs:
    """The model's cache of captured steps, made on first use; it lives and
    dies with the model, whose weights its graphs read."""
    graphs = model.__dict__.get("_step_graphs")
    if graphs is None:
        graphs = model.__dict__["_step_graphs"] = StepGraphs()
    return graphs


def release(model) -> None:
    """Drop the model's captured steps, their static buffers and their pool,
    so that the allocator can hand the memory to other work (the training
    CLI calls it after each sample grid); the next request captures anew."""
    model.__dict__.pop("_step_graphs", None)


def step_key(model, sched, inputs: dict, *extra) -> tuple:
    """What a capture bakes in besides the step's values: where the model's
    parameters and buffers live (weights replaced, not copied into, make a
    new key), the host schedule's identity, each static input's name,
    shape, strides and dtype (the batch, the window layout, whether there
    is CFG), the math flags of its cuBLAS and cuDNN calls, the kernel
    dispatch's host state (`dispatch_key`), and the sampler's
    `extra` (its kind, CFG scale, control mode, ...)."""
    weights = tuple(p.data_ptr() for p in model.parameters()) + tuple(
        b.data_ptr() for b in model.buffers())
    layout = tuple((k, tuple(v.shape), v.stride(), v.dtype) for k, v in sorted(inputs.items()))
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    return (weights, id(sched), layout, flags, dispatch_key()) + extra


def dispatch_key() -> tuple:
    """The host state by which the port picks its kernels at a site, which a
    capture bakes in: the attention override (`ops.attention.attention_impl`), the
    switches that keep GroupNorm plain (`MAGICDANCE_FUSED_GN=0`) and the
    grouped attention off (`MD_DISABLE_GROUPED_ATTN=1`), and where K8 may
    run."""
    return (attention.current_impl(), os.environ.get("MAGICDANCE_FUSED_GN"),
            os.environ.get("MD_DISABLE_GROUPED_ATTN"), layers.FUSED_GN_DEVICES,
            layers.FUSED_GN_MIN_HW)


class StepRun:
    """A request's steps as its sampler runs them: `inputs` are the tensors
    the step reads (the static buffers on the graph path), `sched` the
    diffusion schedule it gathers from, `x` the latents."""

    def __init__(self, reason: Optional[str], inputs: dict, tables: StepTables, sched,
                 entry: Optional[StepEntry] = None, graphs: Optional[StepGraphs] = None):
        self.reason, self.inputs, self.tables, self.sched = reason, inputs, tables, sched
        self.entry, self.graphs = entry, graphs
        self.x = inputs["x"]

    def step(self, i: int, body: Callable[[torch.Tensor, StepValues], torch.Tensor]) -> None:
        """Step i: `body(x, values)` returns the next latents from x and the
        step's values, row i of the tables (eager) or the buffers filled from
        it (a replay or a capture, which write the result into x)."""
        if self.entry is None:
            STEP_GRAPHS["eager." + self.reason] += 1
            self.x = body(self.x, self.tables.row(i))
            return
        x, values = self.x, self.entry.values
        self.graphs.step(self.entry, self.tables, i, lambda: x.copy_(body(x, values)))

    def result(self) -> torch.Tensor:
        """The final latents (a copy of the static buffer on the graph path,
        which the next request overwrites)."""
        return self.x if self.entry is None else self.x.clone()


def bind(model, sched, ddim: DDIMSchedule, inputs: dict, rows: int, *extra,
         offsets: Optional[torch.Tensor] = None, graph: bool = True, turbo: bool,
         noise: bool, sharded: bool) -> StepRun:
    """Set up a request's steps: upload its tables (`rows` timesteps a
    step, the window `offsets`), then take the graph path unless
    `decline_reason` (or `graph=False`) says otherwise. `inputs` name the
    tensors the step reads, x (fp32 latents) among them, None where absent;
    `extra` is the sampler's part of the key. Inputs on another device than
    x are moved to it (on the graph path, copied straight into their static
    buffers)."""
    inputs = {k: v for k, v in inputs.items() if v is not None}
    device = inputs["x"].device
    tables = StepTables.upload(ddim, device, rows, offsets)
    reason = "off" if not graph else decline_reason(device, turbo=turbo, noise=noise,
                                                     sharded=sharded)
    if reason is not None:
        return StepRun(reason, {k: v.to(device) for k, v in inputs.items()}, tables, sched)
    graphs = graphs_of(model)
    entry = graphs.request(step_key(model, sched, inputs, *extra), inputs, rows, device, sched)
    return StepRun(None, entry.statics, tables, entry.sched, entry, graphs)
