"""One-GPU training step for stages 1-3 (PyTorch).

Counterpart of `magicdance_tpu.train.trainer`:

  * parameter freezing is a partition of the denoiser's parameters by the
    freeze regime's predicate over their Flax paths (the port's state-dict
    keys split on "."): trainable parameters require grad, frozen ones do not,
    so frozen branches never pay the dW products, as in JAX.
  * clip by global norm, then AdamW with a linear warm-up from 0 and a
    constant rate after it, as optax.chain(clip_by_global_norm, adamw); the
    schedule's count starts at 0, so the first update has a rate of 0.
    `grad_accum` > 1 averages micro-batch gradients and applies the inner
    update every k-th step, as optax.MultiSteps. Written out here (no
    torch.optim) so that its arithmetic is optax's step for step.
  * EMA of the trainable parameters: a lerp after every step.
  * the frozen VAE encodes the image and the reference (posterior samples,
    chunked by `vae_encode_chunk`) and the frozen CLIP the prompt, without
    gradients; the loss is `models.diffusion.diffusion_loss`.
  * stage 3 (the temporal variant, `MOTION_ONLY`: only the motion modules
    train): a batch holds clips of `cfg.video_frames` frames folded into the
    batch axis, (B_clips * F, H, W, C), with one reference per clip; each clip
    draws one timestep for all its frames.

Precision, by explicit cast at use (not torch.autocast): trainable master
weights, their gradients and the AdamW moments are fp32; frozen parameters
are stored in `optim.frozen_dtype` ("bfloat16", "float32" or "int8"); the
denoiser's products run in `cfg.model.dtype`, each `Linear`/`Conv2d` casting
its weight to the activations' dtype as a Flax module with `dtype=bf16` casts
its fp32 params, so the gradient of an fp32 master comes back through that
cast in fp32. The frozen VAE and CLIP compute in fp32, and the whole step
runs with TF32 off (`pipeline.full_fp32`), so fp32 means full fp32.

`frozen_dtype="int8"` (JAX `train/quant.py`): the frozen leaves of the
denoiser, the VAE and CLIP that `train.quant.should_quantize` takes are
quantized from their fp32 values (int8 and one fp32 scale per output
channel, `models/quant.py`); the others keep fp32 storage, as in JAX. Each layer dequantizes
its own weight at use to bf16, then to the compute dtype -- JAX's values,
without a dequantized copy of the whole frozen set. Checkpoints hold q and
scale.

`attention_impl` (JAX `TrainConfig.attention_impl`, `ops.attention
.attention_impl`) scopes the denoiser's forward and backward (remat's
recompute runs in the backward, so the backward is inside it too); the VAE
encode and CLIP run under "auto", as in JAX.

Dropout (`UNetConfig.dropout` > 0) trains in neither package: JAX's step
applies the model with `deterministic=False` and no "dropout" RNG, which
Flax refuses (`InvalidRngError`), so the port's step raises where JAX's
does. Serving with dropout > 0 is the identity in both.

Random draws come from the trainer's `torch.Generator` (`draw`), separately
from the loss, and a caller may hand its own `Draws` to `train_step`; the
generator's state is part of the checkpointed state, so a resumed run
continues the same stream.

Distribution (torch.distributed; JAX jits the step over a mesh): under an
initialized process group the trainer builds a mesh of `cfg.mesh_axes`
(every rank on 'data' by default; a ("data", "model") mesh trains data
parallel, as JAX's trainer, which never applies the tensor-parallel plan)
and runs on the rank's card. Each rank computes the loss of its rows of the
global batch; the trainable gradients are summed over the 'data' axis in
buckets after the backward pass and divided by its size, so every rank holds
the gradient of the global batch's mean loss, as XLA's psum gives. The
random draws are the global batch's, from the generator every rank seeds
alike, and each rank keeps its rows (whole clips in a temporal batch), so W
ranks compute what one device computes on the W-times batch. The metrics are
averaged over the ranks. A plain all-reduce after backward was chosen over
DistributedDataParallel: the loss reaches the denoiser through remat
(non-reentrant checkpoint) and the freeze regimes leave trainable leaves
without a gradient in some configurations (they get zeros, as in JAX), so
DDP would need `find_unused_parameters` (a graph walk every step); and the
optimizer below is not a torch.optim class, so ZeroRedundancyOptimizer does
not apply either.

ZeRO-1 (`optim.shard_opt_state`, JAX `zero1_sharding`): each rank keeps
the slice of `mu`, `nu`, the accumulator `acc` and the EMA along the axis
`parallel.mesh.zero1_sharding` picks per leaf (small indivisible leaves stay
whole), updates the same slice of the parameter, and the slices are then
all-gathered into every rank's full parameter. The clip uses the global
norm of the full averaged gradient (with a sharded `acc`, its squared slices
are summed over the ranks). Checkpoints (`state_dict`) gather the slices:
their layout does not depend on the world size.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Union

import torch
import torch.distributed as dist

from magicdance_tpu_torch.config import FreezeRegime, OptimConfig, TrainConfig
from magicdance_tpu_torch.convert.from_jax import flax_last_dim
from magicdance_tpu_torch.device import resolve_device
from magicdance_tpu_torch.models import AutoencoderKL, CLIPTextEncoder, MagicPoseModel, quant
from magicdance_tpu_torch.models.diffusion import diffusion_loss, draw_timesteps_and_noise
from magicdance_tpu_torch.models.init import flax_init_
from magicdance_tpu_torch.models.magicpose import refuse_vector
from magicdance_tpu_torch.models.vae import encode_sample_chunked, encode_to_latent
from magicdance_tpu_torch.ops.attention import IMPLS, attention_impl
from magicdance_tpu_torch.ops.schedules import make_schedule
from magicdance_tpu_torch.parallel.mesh import (
    MeshAxis,
    as_axis,
    make_mesh,
    replicated,
    zero1_sharding,
)
from magicdance_tpu_torch.pipeline import full_fp32
from magicdance_tpu_torch.train.quant import should_quantize
from magicdance_tpu_torch.utils.profiling import span

# elements per bucket of the gradient all-reduce and the parameter all-gather
BUCKET_ELEMS = 1 << 26

# ---------------------------------------------------------------------------
# freeze regimes as path predicates
# ---------------------------------------------------------------------------


def trainable_predicate(regime: FreezeRegime,
                        sd_locked: bool = True) -> Callable[[tuple[str, ...]], bool]:
    """Predicate over parameter paths (('unet', 'enc_attn_0', ...)). Roots:
    'unet', 'appearance_unet', 'pose_control'. Semantics per reference flag
    in config.FreezeRegime; the JAX package's predicate, on the same paths."""

    def in_unet_decoder(path):
        return path[0] == "unet" and path[1].startswith(("dec_", "norm_out", "conv_out"))

    def pred(path: tuple[str, ...]) -> bool:
        root = path[0]
        unlocked = (not sd_locked) and in_unet_decoder(path)
        if regime is FreezeRegime.ALL_TRAINABLE:
            return True
        if regime is FreezeRegime.APPEARANCE_PRETRAIN:
            is_self_attn = root == "unet" and any(p == "attn1" for p in path)
            return root in ("appearance_unet", "pose_control") or is_self_attn or unlocked
        if regime is FreezeRegime.FINETUNE_CONTROL:
            return root in ("appearance_unet", "pose_control") or unlocked
        if regime is FreezeRegime.POSE_ONLY:
            return root == "pose_control" or unlocked
        if regime is FreezeRegime.REFERENCE_ONLY:
            return root == "appearance_unet" or unlocked
        if regime is FreezeRegime.MOTION_ONLY:
            return any("motion" in p for p in path)
        raise ValueError(regime)

    return pred


def param_path(key: str) -> tuple[str, ...]:
    return tuple(key.split("."))


# ---------------------------------------------------------------------------
# optimizer: optax.chain(clip_by_global_norm, adamw) [+ MultiSteps]
# ---------------------------------------------------------------------------


def make_lr_schedule(ocfg: OptimConfig) -> Callable[[int], float]:
    """Linear warm-up 0 -> lr over max(1, warmup_steps) updates, then
    constant (optax.join_schedules of linear and constant schedules)."""
    warm = max(1, ocfg.warmup_steps)
    lr = ocfg.learning_rate

    def schedule(count: int) -> float:
        return lr if count >= warm else lr * count / warm

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


def buckets(tensors: list, cap: int = BUCKET_ELEMS) -> list[list[int]]:
    """Indices of `tensors` in consecutive groups of at most `cap` elements
    (a larger tensor is a group of its own)."""
    out, cur, n = [], [], 0
    for i, t in enumerate(tensors):
        if cur and n + t.numel() > cap:
            out.append(cur)
            cur, n = [], 0
        cur.append(i)
        n += t.numel()
    return out + ([cur] if cur else [])


@torch.no_grad()
def all_reduce_mean(tensors: list, axis: MeshAxis) -> None:
    """Average each tensor over the axis in place, flattened in buckets."""
    if axis.group is None:
        return
    for idx in buckets(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        axis.all_reduce(flat).div_(axis.size)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            tensors[i].copy_(flat[off:off + n].view_as(tensors[i]))
            off += n


class Shards:
    """Which slice of each key's state this rank of `axis` holds (ZeRO-1):
    `shard` maps a key to the axis it is split along, or None (whole)."""

    def __init__(self, axis: Optional[MeshAxis] = None,
                 shard: Optional[Mapping[str, Optional[int]]] = None):
        self.axis = axis or MeshAxis.single()
        self.shard = dict(shard or {})

    def local(self, key: str, t: torch.Tensor, rank: Optional[int] = None) -> torch.Tensor:
        """The slice of full tensor `t` that rank `rank` (default: this one)
        holds of `key` (a view; `t` itself when whole)."""
        a = self.shard.get(key)
        if a is None:
            return t
        n = t.shape[a] // self.axis.size
        return t.narrow(a, (self.axis.rank if rank is None else rank) * n, n)

    def gather(self, key: str, t: torch.Tensor) -> torch.Tensor:
        """The full tensor of `key` from every rank's slice `t`."""
        a = self.shard.get(key)
        return t if a is None else torch.cat(self.axis.all_gather(t.contiguous()), dim=a)

    @torch.no_grad()
    def gather_params(self, params: Mapping[str, torch.Tensor]) -> None:
        """Every rank's slices of `params` into every rank's full tensors,
        flattened in buckets (one all-gather each)."""
        keys = [k for k in params if self.shard.get(k) is not None]
        if self.axis.group is None or not keys:
            return
        mine = [self.local(k, params[k]) for k in keys]
        for idx in buckets(mine):
            parts = self.axis.all_gather(torch.cat([mine[i].reshape(-1) for i in idx]))
            for r, part in enumerate(parts):
                if r == self.axis.rank:
                    continue
                off = 0
                for i in idx:
                    view = self.local(keys[i], params[keys[i]], rank=r)
                    view.copy_(part[off:off + view.numel()].view(view.shape))
                    off += view.numel()


class Optimizer:
    """Clip by global norm, then AdamW, with gradient accumulation. State:
    fp32 moments `mu`/`nu`, the inner update `count`, and for grad_accum > 1
    the running mean `acc` of the micro-batch gradients and `mini_step`.

    ZeRO-1: with `shards`, this rank holds its slices of the moments and
    `acc`, updates its slice of each parameter, and the slices are then
    all-gathered."""

    def __init__(self, ocfg: OptimConfig, params: Mapping[str, torch.Tensor],
                 shards: Optional[Shards] = None):
        self.cfg = ocfg
        self.schedule = make_lr_schedule(ocfg)
        self.shards = shards or Shards()
        local = self.shards.local
        self.mu = {k: torch.zeros_like(local(k, p)) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(local(k, p)) for k, p in params.items()}
        self.count = 0
        self.acc = ({k: torch.zeros_like(local(k, p)) for k, p in params.items()}
                    if ocfg.grad_accum > 1 else None)
        self.mini_step = 0

    def state_bytes(self) -> int:
        """Bytes of the moments and accumulator this rank holds."""
        return sum(t.numel() * t.element_size() for part in (self.mu, self.nu, self.acc or {})
                   for t in part.values())

    def _norm(self, keys: list, g: list) -> torch.Tensor:
        """Global norm of the full tensors whose slices (or wholes) are `g`."""
        shard = self.shards.shard
        split = [t for k, t in zip(keys, g) if shard.get(k) is not None]
        if not split:
            return global_norm(g)
        sq = self.shards.axis.all_reduce(sum(t.float().pow(2).sum() for t in split))
        whole = [t for k, t in zip(keys, g) if shard.get(k) is None]
        return torch.sqrt(sq + sum(t.float().pow(2).sum() for t in whole))

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, torch.Tensor]) -> bool:
        """Apply one step in place; returns whether the parameters moved
        (False on an accumulating micro-step)."""
        keys = list(params)
        if self.acc is not None:
            acc = [self.acc[k] for k in keys]
            diff = torch._foreach_sub([self.shards.local(k, grads[k]) for k in keys], acc)
            torch._foreach_div_(diff, float(self.mini_step + 1))
            torch._foreach_add_(acc, diff)
            if self.mini_step < self.cfg.grad_accum - 1:
                self.mini_step += 1
                return False
            g = [a.clone() for a in acc]
            for a in acc:
                a.zero_()
            self.mini_step = 0
            norm = self._norm(keys, g)
        else:
            norm = global_norm([grads[k] for k in keys])
            g = [self.shards.local(k, grads[k]).clone() for k in keys]
        c = self.cfg
        scale = torch.where(norm < c.grad_clip, torch.ones_like(norm), c.grad_clip / norm)
        torch._foreach_mul_(g, scale)
        mu = [self.mu[k] for k in keys]
        nu = [self.nu[k] for k in keys]
        torch._foreach_lerp_(mu, g, 1.0 - c.adam_b1)
        torch._foreach_mul_(nu, c.adam_b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - c.adam_b2)
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = 1.0 - c.adam_b1 ** self.count
        bc2 = 1.0 - c.adam_b2 ** self.count
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, c.adam_eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        p = [self.shards.local(k, params[k]) for k in keys]
        if c.weight_decay:
            torch._foreach_add_(upd, p, alpha=c.weight_decay)
        torch._foreach_add_(p, upd, alpha=-lr)
        self.shards.gather_params(params)
        return True

    def state_dict(self) -> dict:
        """The full moments (gathered from every rank's slices): the same
        layout at any world size. Every rank must call it."""
        full = {name: {k: self.shards.gather(k, t) for k, t in getattr(self, name).items()}
                for name in ("mu", "nu") + (("acc",) if self.acc is not None else ())}
        return {"mu": full["mu"], "nu": full["nu"], "count": self.count,
                "acc": full.get("acc"), "mini_step": self.mini_step}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Full moments, as `state_dict` writes them; each rank keeps its
        slices."""
        for name in ("mu", "nu") + (("acc",) if self.acc is not None else ()):
            for k, t in getattr(self, name).items():
                t.copy_(self.shards.local(k, sd[name][k].to(t.device)))
        self.count = int(sd["count"])
        self.mini_step = int(sd["mini_step"])


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------


@dataclass
class Draws:
    """The random numbers of one step: timesteps (B,), the diffusion noise
    and the VAE posterior noise of the image, each (B, h, w, embed_dim)
    standard normal, and that of the reference, (B_ref, h, w, embed_dim). In
    a temporal batch B = clips x frames, B_ref = clips, and the timesteps
    repeat each clip's draw over its frames."""

    t: torch.Tensor
    noise: torch.Tensor
    vae_image: torch.Tensor
    vae_reference: Optional[torch.Tensor] = None


# storage of the frozen leaves; under "int8" the leaves it does not quantize
# keep fp32, as JAX's quantize_tree leaves them
_FROZEN_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                  "int8": torch.float32}


class Trainer:
    """Owns the denoiser, the frozen VAE and CLIP, the optimizer state and
    the step. Build, set the weights (`init_random`, `load_state_dicts` or
    `convert.from_jax.load_train_state`), then call `train_step`."""

    def __init__(self, cfg: TrainConfig, device: Union[str, torch.device] = "cuda",
                 mesh=None):
        """`mesh`: a DeviceMesh with a 'data' axis; by default one of
        `cfg.mesh_axes` over every rank when a process group is initialized,
        else none (one process). Under a group, "cuda" is the rank's card
        (`parallel.multihost.initialize_distributed` sets it)."""
        ocfg = cfg.optim
        refuse_vector(cfg.model, "training")
        if ocfg.frozen_dtype not in _FROZEN_DTYPES:
            raise ValueError(f"unknown frozen_dtype {ocfg.frozen_dtype!r}")
        if "data" not in tuple(cfg.mesh_axes):
            raise ValueError(f"mesh axes {cfg.mesh_axes} lack the 'data' axis the batch "
                             "is split over")
        if cfg.attention_impl not in IMPLS:
            raise ValueError(f"attention_impl {cfg.attention_impl!r} is not one of {IMPLS}")
        self.cfg = cfg
        # video clips arrive frame-folded into the batch: (B_clips * F, ...)
        self.num_frames = cfg.video_frames if cfg.model.has_temporal else 1
        if mesh is None and dist.is_initialized():
            mesh = make_mesh(cfg.mesh_axes)
        self.mesh = mesh
        self.data = as_axis(mesh, "data")
        self.device = resolve_device(device)
        with self.device:  # built where it runs: no host-side default init
            self.model = MagicPoseModel(cfg.model).to(self.device)
            self.vae = AutoencoderKL(cfg.model.vae).to(self.device)
            self.clip = CLIPTextEncoder(cfg.model.clip).to(self.device)
        for m in (self.model, self.vae, self.clip):
            m.train(False)
        self.sched = make_schedule(cfg.model.diffusion)
        self.pred = trainable_predicate(cfg.freeze, cfg.sd_locked)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.step = 0
        self.train_params: dict[str, torch.nn.Parameter] = {}
        self.opt: Optional[Optimizer] = None
        self.ema_params: Optional[dict[str, torch.Tensor]] = None
        self._partition()

    # -- parameters ---------------------------------------------------------
    @torch.no_grad()
    def _partition(self) -> None:
        """Trainable denoiser params: fp32, requires_grad. Everything else:
        `frozen_dtype` storage, no grad (under "int8" each leaf
        `should_quantize` takes is quantized from its fp32 values;
        leaves already held in int8 stay so). Resets the optimizer state and
        the EMA."""
        frozen = _FROZEN_DTYPES[self.cfg.optim.frozen_dtype]
        int8 = self.cfg.optim.frozen_dtype == "int8"
        self.train_params = {}
        for net in (self.model, self.vae, self.clip):
            for owner, sub in net.named_modules():
                for name, p in list(sub.named_parameters(recurse=False)):
                    if quant.is_quantized(sub, name) or quant.is_scale(sub, name):
                        continue
                    key = f"{owner}.{name}" if owner else name
                    train = net is self.model and self.pred(param_path(key))
                    if train:
                        p.data = p.data.float()
                        self.train_params[key] = p
                    elif int8 and should_quantize(p):
                        quant.quantize_param_(sub, name, flax_last_dim(sub, name, p.dim()))
                        continue
                    else:
                        p.data = p.data.to(frozen)
                    p.requires_grad_(train)
        keys = list(self.train_params)
        zero1 = (zero1_sharding(self.model, keys, self.data.size)
                 if self.data.group is not None else replicated(keys))
        self.opt = Optimizer(self.cfg.optim, self.train_params, Shards(
            self.data, zero1 if self.cfg.optim.shard_opt_state else replicated(keys)))
        # the EMA is ZeRO-1 sharded whatever shard_opt_state says, as in JAX
        self.ema_shards = Shards(self.data, zero1)
        self.ema_params = ({k: self.ema_shards.local(k, p.detach()).clone()
                            for k, p in self.train_params.items()}
                           if self.cfg.optim.ema_rate > 0 else None)

    @torch.no_grad()
    def _float_storage(self) -> None:
        """Every parameter back to fp32 storage (int8 leaves dequantized),
        before new weights are written."""
        for m in (self.model, self.vae, self.clip):
            quant.unquantize_(m)
            for p in m.parameters():
                p.data = p.data.float()

    @torch.no_grad()
    def init_random(self, seed: int = 0, scale: float = 0.02) -> None:
        """Seeded random weights for tests and smoke runs: every leaf (the
        zero-initialised output convs and zero convs included) from
        N(0, scale^2), then partitioned as `_partition` says."""
        self._float_storage()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for m in (self.model, self.vae, self.clip):
            for p in m.parameters():
                p.data = torch.randn(p.shape, generator=gen, device=self.device) * scale
        self._partition()

    @torch.no_grad()
    def init_flax(self, seed: int = 0) -> None:
        """The JAX package's initialisation (`models.init.flax_init_`: lecun
        normal kernels, zeros where JAX zero-inits, ones and zeros for the
        norms, Flax's embedding inits), drawn on the device from a generator
        seeded `seed`, then partitioned: the training CLI's start without a
        checkpoint."""
        self._float_storage()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for m in (self.model, self.vae, self.clip):
            flax_init_(m, gen)
        self._partition()

    def load_state_dicts(self, model: Mapping[str, torch.Tensor],
                         vae: Mapping[str, torch.Tensor],
                         clip: Mapping[str, torch.Tensor]) -> None:
        """Weights for the three networks (strict: a missing or unexpected
        key raises), loaded at full precision, then the partition; e.g. from
        `convert.from_jax.flax_to_state_dict` or a reference checkpoint
        through `convert.torch_convert.convert_magicpose_state`. An int8
        entry with its `<key>_scale` is loaded as int8 storage."""
        from magicdance_tpu_torch.convert.torch_convert import load_strict

        self._float_storage()
        for name, m, sd in (("model", self.model, model), ("vae", self.vae, vae),
                            ("clip", self.clip, clip)):
            quant.match_(m, sd)  # int8 leaves (a JAX int8 TrainState) load as such
            load_strict(m, sd, name)
        self._partition()

    @torch.no_grad()
    def set_ema(self, ema: Mapping[str, torch.Tensor]) -> None:
        """The full EMA tensors; each rank keeps its slices."""
        if self.ema_params is None:
            raise ValueError("ema_rate is 0: the trainer keeps no EMA")
        for k, t in self.ema_params.items():
            t.copy_(self.ema_shards.local(k, ema[k].to(t.device)))

    def full_ema(self) -> Optional[dict[str, torch.Tensor]]:
        """The full EMA tensors, gathered from every rank's slices (every
        rank must call it)."""
        if self.ema_params is None:
            return None
        return {k: self.ema_shards.gather(k, t) for k, t in self.ema_params.items()}

    # -- one step -------------------------------------------------------------
    def draw(self, batch: Mapping[str, torch.Tensor]) -> Draws:
        """This step's random numbers from the trainer's generator: those of
        the GLOBAL batch (this rank's rows times the 'data' axis), the same
        on every rank, which keeps its rows (`local_draws`)."""
        f = 2 ** (len(self.cfg.model.vae.channel_mult) - 1)  # the VAE's downsampling
        n = self.data.size

        def latent_shape(images):
            b, h, w, _ = images.shape
            return (b * n, h // f, w // f, self.cfg.model.vae.embed_dim)

        shape = latent_shape(batch["image"])
        g, dev = self.generator, self.device
        vae_image = torch.randn(shape, generator=g, device=dev)
        vae_ref = (torch.randn(latent_shape(batch["reference"]), generator=g, device=dev)
                   if self.cfg.model.has_appearance else None)
        t, noise = draw_timesteps_and_noise(
            self.sched, torch.empty(shape, device=dev), generator=g,
            num_frames=self.num_frames)
        return Draws(t=t, noise=noise, vae_image=vae_image, vae_reference=vae_ref)

    def local_draws(self, draws: Draws, batch: Mapping[str, torch.Tensor]) -> Draws:
        """This rank's rows of the global batch's draws: rows
        [rank * B, (rank + 1) * B) for this rank's B images (whole clips in
        a temporal batch) and likewise for the references."""
        n, r = self.data.size, self.data.rank
        b = batch["image"].shape[0]
        if draws.t.shape[0] != b * n:
            raise ValueError(f"draws for {draws.t.shape[0]} images; the global batch holds "
                             f"{b} x {n}")
        if n == 1:
            return draws

        def rows(x, m):
            return None if x is None else x[r * m:(r + 1) * m]

        b_ref = batch["reference"].shape[0] if draws.vae_reference is not None else 0
        return Draws(t=rows(draws.t, b), noise=rows(draws.noise, b),
                     vae_image=rows(draws.vae_image, b),
                     vae_reference=rows(draws.vae_reference, b_ref))

    def to_device(self, batch: Mapping) -> dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    @torch.no_grad()
    def encode(self, batch: Mapping[str, torch.Tensor], draws: Draws):
        """The frozen encoders: (x0 latent, reference latent or None,
        context), from VAE posterior samples and CLIP, without gradients."""
        cfg = self.cfg
        chunk = cfg.vae_encode_chunk
        scale = cfg.model.vae.scale_factor
        with span("md.train.encode"):
            x0 = encode_to_latent(encode_sample_chunked(
                self.vae, batch["image"], draws.vae_image, chunk), scale)
            ref = None
            if cfg.model.has_appearance:
                ref = encode_to_latent(encode_sample_chunked(
                    self.vae, batch["reference"], draws.vae_reference, chunk), scale)
            return x0, ref, self.clip(batch["input_ids"])

    def loss_from_latents(self, x0: torch.Tensor, ref: Optional[torch.Tensor],
                          context: torch.Tensor, batch: Mapping[str, torch.Tensor],
                          draws: Draws):
        """The denoiser's loss on encoded inputs (graph kept for backward).
        Call it, and run its backward, under `attention_impl(cfg.attention_impl)`
        as `loss_and_grads` does."""
        cfg = self.cfg
        if cfg.model.unet.dropout > 0:
            raise RuntimeError(
                f"UNetConfig.dropout={cfg.model.unet.dropout} cannot train: the JAX "
                "package's train step applies the model with deterministic=False and no "
                "'dropout' RNG, which Flax refuses (flax.errors.InvalidRngError), and "
                "the port raises where JAX does. Serving with dropout > 0 works (the "
                "identity); train with dropout=0.")
        pose = batch.get("pose") if cfg.model.has_pose else None
        return diffusion_loss(self.model, self.sched, cfg.model.diffusion, x0, context,
                              draws.t.to(self.device), draws.noise.to(self.device),
                              reference_latent=ref, pose_hint=pose, wonoise=True,
                              num_frames=self.num_frames)

    def grads(self) -> dict[str, torch.Tensor]:
        """The trainable parameters' gradients after a backward pass, fp32,
        zeros for one the loss does not reach (as JAX gives)."""
        return {k: p.grad if p.grad is not None else torch.zeros_like(p)
                for k, p in self.train_params.items()}

    def average(self, grads: Mapping[str, torch.Tensor],
                metrics: Mapping[str, torch.Tensor]) -> dict:
        """Average the gradients (in place) and the metrics over the 'data'
        axis: the global batch's. Returns the averaged metrics."""
        if self.data.group is None:
            return dict(metrics)
        all_reduce_mean(list(grads.values()), self.data)
        vals = torch.stack([v.detach().float() for v in metrics.values()])
        all_reduce_mean([vals], self.data)
        return dict(zip(metrics, vals.unbind()))

    def loss_and_grads(self, batch: Mapping[str, torch.Tensor], draws: Draws):
        """(loss, metrics, grads) of this rank's rows of the batch with its
        rows of the global draws, the gradients and metrics averaged over the
        'data' axis (the loss is the counterpart of the JAX trainer's
        `_loss`)."""
        for p in self.train_params.values():
            p.grad = None
        draws = self.local_draws(draws, batch)
        with full_fp32():
            encoded = self.encode(batch, draws)  # VAE and CLIP under "auto"
            with attention_impl(self.cfg.attention_impl):
                with span("md.train.forward"):
                    loss, metrics = self.loss_from_latents(*encoded, batch, draws)
                with span("md.train.backward"):
                    loss.backward()
        grads = self.grads()
        metrics = self.average(grads, metrics)
        return metrics["loss"], metrics, grads

    def apply_update(self, grads: Mapping[str, torch.Tensor]) -> None:
        """Optimizer update and EMA; clears the gradients; counts the step."""
        with full_fp32(), span("md.train.optimizer"):
            self.opt.update(self.train_params, grads)
            if self.ema_params is not None:
                rate = self.cfg.optim.ema_rate
                local = self.ema_shards.local
                with torch.no_grad():
                    torch._foreach_lerp_(list(self.ema_params.values()),
                                         [local(k, p.detach())
                                          for k, p in self.train_params.items()],
                                         1.0 - rate)
        for p in self.train_params.values():
            p.grad = None
        self.step += 1

    def train_step(self, batch: Mapping, draws: Optional[Draws] = None) -> dict:
        """One step on this rank's rows of the global batch: loss and grads,
        optimizer update, EMA. `draws` are the global batch's (default: from
        the trainer's generator). Returns the metrics of the global batch as
        0-d tensors on the device (no host sync)."""
        with span("md.train.step", " i={}".format, self.step):
            batch = self.to_device(batch)
            if draws is None:
                draws = self.draw(batch)
            _, metrics, grads = self.loss_and_grads(batch, draws)
            metrics["grad_norm"] = global_norm(grads.values())
            self.apply_update(grads)
        return metrics

    # -- state ----------------------------------------------------------------
    def state_dict(self) -> dict:
        """Everything a resumed run needs: step, weights (int8 leaves as
        `<key>` and `<key>_scale`), optimizer state, EMA and the generator's
        state, in a layout that does not depend on the world size (the
        ZeRO-1 slices are gathered: every rank must call it)."""
        return {
            "step": self.step,
            "model": self.model.state_dict(),
            "vae": self.vae.state_dict(),
            "clip": self.clip.state_dict(),
            "opt": self.opt.state_dict(),
            "ema": self.full_ema(),
            "generator": self.generator.get_state(),
        }

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """A `state_dict` saved at any world size; each rank keeps its
        slices."""
        for name in ("model", "vae", "clip"):
            module = getattr(self, name)
            for k, t in module.state_dict(keep_vars=True).items():
                t.copy_(sd[name][k])
        self.opt.load_state_dict(sd["opt"])
        if self.ema_params is not None:
            self.set_ema(sd["ema"])
        self.generator.set_state(sd["generator"])
        self.step = int(sd["step"])
