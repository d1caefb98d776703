"""Typed configuration for the PyTorch port.

The port's own copy of the model and sampling dataclasses: the variant enum,
the UNet / ControlNet / VAE / CLIP / diffusion configs, `ModelConfig` and the
DDIM `SampleConfig`, plus `from_dict` / `to_dict`. Field names and defaults
are those of the JAX package, so one JSON config drives either.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Any, Optional


class ModelVariant(str, enum.Enum):
    """Which control branches are active.

    Mirrors the reference's three shipped YAMLs + the unshipped temporal stage
    (cldm_v15.yaml / cldm_v15_reference_only.yaml /
    cldm_v15_reference_only_pose.yaml; SURVEY.md §0).
    """

    SD = "sd"  # plain text-to-image SD1.5 (no control branches)
    POSE = "pose"  # classic pose ControlNet only (cldm_v15.yaml)
    APPEARANCE = "appearance"  # stage 1: appearance bank only
    APPEARANCE_POSE = "appearance_pose"  # stage 2 / flagship MagicPose
    APPEARANCE_POSE_TEMPORAL = "appearance_pose_temporal"  # stage 3 video
    # two classic ControlNets (pose hint + image hint) whose residual lists
    # sum positionally into the UNet (ref cldm.py:42-52 ControlledUnetModel
    # `image_control`, :909 ControlLDMVideo / :985 ControlLDMVideoMaskPose)
    DUAL_CONTROL = "dual_control"


class Parameterization(str, enum.Enum):
    EPS = "eps"
    X0 = "x0"
    V = "v"


@dataclass(frozen=True)
class UNetConfig:
    """SD1.5 UNet (ref: ldm/modules/diffusionmodules/openaimodel.py:432)."""

    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    # downsample factors at which SpatialTransformers are inserted
    attention_resolutions: tuple[int, ...] = (4, 2, 1)
    num_heads: int = 8
    transformer_depth: int = 1
    context_dim: int = 768
    dropout: float = 0.0
    # AnimateDiff-style temporal motion modules interleaved after spatial
    # transformers (ref: motion_module.py, openaimodel.py:811 UNetModel_Temporal)
    use_motion_modules: bool = False
    motion_num_heads: int = 8
    motion_max_len: int = 24
    motion_layers: int = 1
    # temporal self-attention units per transformer block (ref
    # attention_block_types = 2x "Temporal_Self", motion_module.py:94;
    # matches public AnimateDiff mm_sd_v15 checkpoints)
    motion_attn_blocks: int = 2
    # recompute blocks in the backward pass (training only; kept so one
    # config file serves both packages)
    remat: bool = True

    @property
    def head_dim_at(self) -> dict[int, int]:
        return {m: self.model_channels * m // self.num_heads for m in self.channel_mult}


@dataclass(frozen=True)
class ControlNetConfig:
    """Pose ControlNet (ref: cldm/cldm.py:500)."""

    hint_channels: int = 3
    # architecture mirrors the UNet encoder; these are validated against the
    # paired UNetConfig at model build time
    model_channels: int = 320
    channel_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attention_resolutions: tuple[int, ...] = (4, 2, 1)
    num_heads: int = 8
    transformer_depth: int = 1
    context_dim: int = 768
    remat: bool = True


@dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL (ref: ldm/models/autoencoder.py:13, ddconfig in YAMLs)."""

    embed_dim: int = 4
    z_channels: int = 4
    base_channels: int = 128
    channel_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    in_channels: int = 3
    out_channels: int = 3
    double_z: bool = True
    scale_factor: float = 0.18215
    # compute dtype for VAE forward passes ("float32" | "bfloat16")
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class CLIPTextConfig:
    """FrozenCLIPEmbedder = openai/clip-vit-large-patch14 text tower
    (ref: ldm/modules/encoders/modules.py:88)."""

    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    bos_token_id: int = 49406
    eos_token_id: int = 49407


@dataclass(frozen=True)
class DiffusionConfig:
    """DDPM schedule + loss (ref: ddpm.py:138 register_schedule, YAML params)."""

    timesteps: int = 1000
    beta_schedule: str = "linear"
    linear_start: float = 0.00085
    linear_end: float = 0.0120
    cosine_s: float = 8e-3
    parameterization: Parameterization = Parameterization.EPS
    loss_type: str = "l2"
    # weight of the simple loss; elbo weighting off by default like reference
    l_simple_weight: float = 1.0
    original_elbo_weight: float = 0.0
    # v-posterior (ref DDPM.__init__ v_posterior, default 0)
    v_posterior: float = 0.0


@dataclass(frozen=True)
class ModelConfig:
    variant: ModelVariant = ModelVariant.APPEARANCE_POSE
    unet: UNetConfig = field(default_factory=UNetConfig)
    pose_control: ControlNetConfig = field(default_factory=ControlNetConfig)
    # second ControlNet for DUAL_CONTROL (image-hint branch; None -> same
    # architecture as pose_control, ref cldm.py:909-946 instantiates two
    # identical ControlNet configs)
    image_control: Optional[ControlNetConfig] = None
    vae: VAEConfig = field(default_factory=VAEConfig)
    clip: CLIPTextConfig = field(default_factory=CLIPTextConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    latent_size: int = 64  # 512px / 8
    # compute dtype for UNet/control branches ("bfloat16" | "float32")
    dtype: str = "bfloat16"

    @property
    def has_appearance(self) -> bool:
        return self.variant in (
            ModelVariant.APPEARANCE,
            ModelVariant.APPEARANCE_POSE,
            ModelVariant.APPEARANCE_POSE_TEMPORAL,
        )

    @property
    def has_pose(self) -> bool:
        return self.variant in (
            ModelVariant.POSE,
            ModelVariant.APPEARANCE_POSE,
            ModelVariant.APPEARANCE_POSE_TEMPORAL,
            ModelVariant.DUAL_CONTROL,
        )

    @property
    def has_image_control(self) -> bool:
        return self.variant is ModelVariant.DUAL_CONTROL

    @property
    def has_temporal(self) -> bool:
        return self.variant is ModelVariant.APPEARANCE_POSE_TEMPORAL


@dataclass(frozen=True)
class SampleConfig:
    """DDIM inference recipe (ref: test_tiktok.py:261-268)."""

    steps: int = 50
    cfg_scale: float = 7.0
    eta: float = 0.0
    # "controlnet_important": uncond pass drops BOTH control branches
    # (ref: ddim.py:598-605) — i.e. uncond is a vanilla SD UNet forward.
    control_mode: str = "controlnet_important"
    # skip noising the reference latent ("wonoise", ref: ddpm.py:2173-2176)
    wonoise: bool = True
    # share the initial noise x_T across all frames of a sequence
    # (ref: test_any_image_pose.py:201-202)
    shared_noise: bool = True
    # video overlap sampling (ref: ddim.py:569-594)
    window: int = 16
    stride: int = 12
    # batch cond+uncond into ONE UNet forward (numerically identical to the
    # reference's two sequential passes). Not ported yet: the port's sampler
    # raises when it is set.
    fused_cfg: bool = False
    # ---- opt-in turbo modes (NOT reference-parity; defaults are exact) ----
    # The JAX package's sampler implements them; the port's sampler runs the
    # exact path only and raises when any of them is set.
    # cfg_interval=(lo, hi): apply classifier-free guidance only while t/T
    # is inside [lo, hi] ("Applying Guidance in a Limited Interval",
    # Kynkäänniemi et al. 2024).
    cfg_interval: Optional[tuple[float, float]] = None
    # uncond_every=k (k>1): refresh the uncond eps every k-th CFG-active
    # step and reuse the cached value in between (the uncond trajectory is
    # smooth in t — "Faster Diffusion"-style reuse applied to the CFG pass).
    # Cuts ~(1-1/k) of all vanilla-SD uncond forwards.
    uncond_every: int = 1
    # DeepCache split level: 0 = classic deepest reuse (fastest shallow
    # pass); 1 = second split point, recomputes levels 0-1 per step for a
    # smaller approximation error at less speedup
    deepcache_level: int = 0
    # pose_every=k (k>1): refresh the pose-ControlNet residuals every k-th
    # step and reuse the cached tuple in between (DeepCache-style reuse —
    # the residuals vary smoothly along the trajectory while the hint is
    # constant). Cuts ~(1-1/k) of all pose-branch forwards.
    pose_every: int = 1
    # deepcache_every=k (k>1): refresh the cond UNet's deep levels every
    # k-th step; in between run only the level-0 encoder/decoder around the
    # cached deep feature ("DeepCache", Ma et al. 2023 — the deep features
    # vary slowly along the trajectory). Combines with pose_every (reuse
    # steps then also skip the pose branch refresh).
    deepcache_every: int = 1
    # bank_every=k (k>1): refresh the appearance bank (the full-UNet-copy
    # write pass, ref cldm.py:164-497) every k-th step and reuse the cached
    # bank tuple in between. With wonoise=True (the reference inference
    # recipe) the write input is the SAME reference latent every step — only
    # the timestep embedding varies — so the bank drifts slowly in t and
    # reuse is a small approximation. Matters most at small frame batches,
    # where the B=1 write is a full third of the per-step UNet forwards
    # (at B=32 it is ~1-2 % — amortized across the batch).
    bank_every: int = 1
    # bank_downsample=f (f>1): average-pool each appearance-bank entry f x f
    # over its site's spatial grid before the read sites consume it
    # (ToMe-style KV reduction). Only entries with at least
    # bank_downsample_min_seq tokens are pooled (default 4096 = the five
    # ds-1 read sites, the largest single cost bucket in the DDIM step);
    # smaller sites stay exact. Cuts pooled-site bank KV ~f^2.
    bank_downsample: int = 1
    bank_downsample_min_seq: int = 4096
    # self_kv_downsample=f (f>1): ToMe-style token reduction on the SELF
    # keys/values of the main UNet's self-attention read sites — queries and
    # outputs stay full resolution, only K/V are f x f average-pooled over
    # the site's spatial grid (cf. Bolya & Hoffman 2023 token merging).
    # Applies to sites with at least
    # self_kv_min_seq tokens (default 4096 = the ds-1 sites); the appearance
    # WRITE pass and cross/temporal attention stay exact. Composes with
    # bank_downsample (the bank entries those sites read are pooled
    # separately). Not supported with fused_cfg (which needs the gated
    # bank_mask kernel).
    self_kv_downsample: int = 1
    self_kv_min_seq: int = 4096
    # trajectory-scheduled reuse: force EVERY reuse cache (uncond, pose,
    # deepcache, bank) to refresh on the first / last N executed steps of
    # the trajectory, so aggressive mid-range strides keep exact endpoints
    # (the endpoints set global structure at high t and final detail at low
    # t; mid-range features vary slowest — the DeepCache observation).
    reuse_exact_first: int = 0
    reuse_exact_last: int = 0


def _to_tuple(x: Any) -> Any:
    if isinstance(x, list):
        return tuple(_to_tuple(v) for v in x)
    return x


def from_dict(cls, d: dict[str, Any]):
    """Recursively build a (frozen) dataclass from a plain dict."""
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls} is not a dataclass")
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for k, v in d.items():
        if k not in fields:
            raise KeyError(f"unknown config key {k!r} for {cls.__name__}")
        f = fields[k]
        # resolve the declared type for nested dataclasses/enums
        declared = f.default_factory() if f.default_factory is not dataclasses.MISSING else f.default  # type: ignore[misc]
        if isinstance(v, dict) and dataclasses.is_dataclass(declared):
            kwargs[k] = from_dict(type(declared), v)
        elif isinstance(declared, enum.Enum) and isinstance(v, str):
            kwargs[k] = type(declared)(v)
        else:
            kwargs[k] = _to_tuple(v)
    return cls(**kwargs)


def to_dict(cfg) -> dict[str, Any]:
    def _convert(obj):
        if dataclasses.is_dataclass(obj):
            return {f.name: _convert(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
        if isinstance(obj, enum.Enum):
            return obj.value
        if isinstance(obj, tuple):
            return [_convert(v) for v in obj]
        return obj

    return _convert(cfg)
