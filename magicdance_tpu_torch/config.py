"""Typed configuration for the PyTorch port.

The port's own copy of the model, sampling and training dataclasses: the
variant enum, the UNet / ControlNet / VAE / CLIP / diffusion configs,
`ModelConfig`, the DDIM `SampleConfig`, the freeze regimes, `OptimConfig`,
`TrainConfig` and the three stage presets, plus `from_dict` / `to_dict` /
`load_json` / `load_yaml` / `save_json`. Field names and defaults are those
of the JAX package, so one JSON config of the SD1.5 family drives either.
The SDXL fields (per-level transformer depth, `num_head_channels`,
`use_linear_in_transformer`, `adm_in_channels`, the text tower's
activation, output layer, projection and pad id, and `ModelConfig.clip_g`)
are the port's own: the JAX package has no
SDXL, and `to_dict` leaves them out while they hold their defaults, so an
SD1.5 configuration's dict is the JAX package's.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import typing
from dataclasses import dataclass, field
from typing import Any, Optional, Union


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


def port_only(default):
    """A field the JAX package lacks (the SDXL family): `to_dict` leaves it
    out while it holds `default`."""
    return field(default=default, metadata={"port_only": True})


class _SpatialArch:
    """What the UNet, its appearance copy and the ControlNet derive from
    the transformer fields alike: the depth at each level and in the middle
    block, and the heads at a width."""

    def depth_at(self, level: int) -> int:
        """Transformer blocks a site of `level` holds (an int depth holds
        for every level)."""
        d = self.transformer_depth
        return d if isinstance(d, int) else d[level]

    @property
    def depth_middle(self) -> int:
        """The middle block's depth: the deepest level's (SDXL 10)."""
        return self.depth_at(len(self.channel_mult) - 1)

    def heads_at(self, channels: int) -> tuple[int, int]:
        """(heads, head width) of a transformer of `channels` channels:
        `num_head_channels` wide heads when set (SDXL), else `num_heads`
        heads (SD1.5)."""
        if self.num_head_channels > 0:
            return channels // self.num_head_channels, self.num_head_channels
        return self.num_heads, channels // self.num_heads


@dataclass(frozen=True)
class UNetConfig(_SpatialArch):
    """SD1.5 UNet (ref: ldm/modules/diffusionmodules/openaimodel.py:432);
    with the port's own SDXL fields, the SDXL UNet (Stability-AI
    generative-models sgm/modules/diffusionmodules/openaimodel.py)."""

    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    # downsample factors at which SpatialTransformers are inserted
    attention_resolutions: tuple[int, ...] = (4, 2, 1)
    num_heads: int = 8
    transformer_depth: Union[int, tuple[int, ...]] = 1
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
    # ---- the SDXL fields (the port's own) ----
    # transformer_depth may also be one depth per level (SDXL [1, 2, 10]);
    # the middle block takes the deepest level's
    # heads of this width (SDXL 64); -1: `num_heads` heads at every level
    num_head_channels: int = port_only(-1)
    # a transformer's proj_in / proj_out as linear layers on the tokens
    # (SDXL) instead of 1x1 convolutions (SD1.5)
    use_linear_in_transformer: bool = port_only(False)
    # width of the added vector y (SDXL 2816: the pooled text and six size
    # sinusoids); > 0 adds `label_emb`, Linear-SiLU-Linear, to the time
    # embedding. 0: no vector (SD1.5)
    adm_in_channels: int = port_only(0)

    @property
    def head_dim_at(self) -> dict[int, int]:
        return {m: self.heads_at(self.model_channels * m)[1] for m in self.channel_mult}


@dataclass(frozen=True)
class ControlNetConfig(_SpatialArch):
    """Pose ControlNet (ref: cldm/cldm.py:500); the SDXL fields as the
    UNet's."""

    hint_channels: int = 3
    # architecture mirrors the UNet encoder; these are validated against the
    # paired UNetConfig at model build time
    model_channels: int = 320
    channel_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attention_resolutions: tuple[int, ...] = (4, 2, 1)
    num_heads: int = 8
    transformer_depth: Union[int, tuple[int, ...]] = 1
    context_dim: int = 768
    remat: bool = True
    num_head_channels: int = port_only(-1)
    use_linear_in_transformer: bool = port_only(False)
    adm_in_channels: int = port_only(0)


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
    # ---- the SDXL towers' fields (the port's own) ----
    # the MLP's activation: "quick_gelu" (OpenAI CLIP) or "gelu" (OpenCLIP)
    hidden_act: str = port_only("quick_gelu")
    # the hidden state returned: "last" (after the final LayerNorm) or
    # "penultimate" (the input of the last layer, no final norm: SDXL)
    output_layer: str = port_only("last")
    # > 0: also a pooled embedding, the final LayerNorm's output at the
    # EOT token times `text_projection` (hidden_size x projection_dim, no
    # bias); 0: none
    projection_dim: int = port_only(0)
    # the id after the EOT token (OpenCLIP pads with 0); None: the EOS id
    pad_token_id: Optional[int] = port_only(None)


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
    # ---- the SDXL fields (the port's own) ----
    # the second text tower (OpenCLIP ViT-bigG/14); with it the context is
    # both towers' hidden states side by side and `clip_g`'s pooled
    # embedding starts the added vector. None: one tower (SD1.5)
    clip_g: Optional[CLIPTextConfig] = port_only(None)

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

    @property
    def has_vector(self) -> bool:
        """The denoisers take an added vector y (SDXL micro-conditioning)."""
        return self.unet.adm_in_channels > 0


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
    # reference's two sequential passes); the uncond rows read the bank
    # through a gate of 0 (kernel B's gated mode). Image sampler only.
    fused_cfg: bool = False
    # ---- opt-in turbo modes (NOT reference-parity; defaults are exact) ----
    # Ignored when fused_cfg is set (as in the JAX package).
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


class FreezeRegime(str, enum.Enum):
    """Parameter-freeze regimes (ref: train_tiktok.py:762-969).

    Mapping to reference CLI flags:
      ALL_TRAINABLE        = --finetune_all
      APPEARANCE_PRETRAIN  = --finetune_attn (stage 1: control branches +
                             UNet self-attention "attn1" params)
      FINETUNE_CONTROL     = --finetune_control (stage 2: both control
                             branches, UNet frozen / sd_locked)
      POSE_ONLY            = --finetune_pose_only
      REFERENCE_ONLY       = --finetune_reference_only
      MOTION_ONLY          = --finetune_mm (AnimateDiff stage: motion
                             modules only)
    """

    ALL_TRAINABLE = "all"
    APPEARANCE_PRETRAIN = "appearance_pretrain"
    FINETUNE_CONTROL = "finetune_control"
    POSE_ONLY = "pose_only"
    REFERENCE_ONLY = "reference_only"
    MOTION_ONLY = "motion_only"


@dataclass(frozen=True)
class OptimConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    grad_clip: float = 0.5
    warmup_steps: int = 1000
    grad_accum: int = 1
    # ZeRO-1 analog: shard optimizer moments across the data axis (a
    # process group's 'data' ranks each keep their slices; one process keeps
    # them whole)
    shard_opt_state: bool = True
    ema_rate: float = 0.0  # reference default: EMA off (train_tiktok.py:586)
    # storage dtype for FROZEN params (VAE/CLIP/locked UNet): bf16 halves
    # their memory, "int8" (models/quant.py: per-output-channel scales,
    # dequantized to bf16 at use) quarters it; trainable params/moments stay
    # f32. One of "bfloat16", "float32", "int8".
    frozen_dtype: str = "bfloat16"


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    freeze: FreezeRegime = FreezeRegime.FINETUNE_CONTROL
    # reference --sd_locked (default True); False additionally trains the
    # UNet decoder + output head (train_tiktok.py sd_locked branches)
    sd_locked: bool = True
    batch_size_per_device: int = 8
    num_train_steps: int = 100000
    seed: int = 42
    image_size: int = 512
    img_bin_limit: int = 29
    # stage-3 (temporal) training: frames per clip fed to the motion modules
    # (the reference hardcodes video_length=16, motion_module.py:137) and the
    # temporal subsampling stride inside the source video
    video_frames: int = 16
    frame_stride: int = 4
    # empty-text conditioning (the reference's --with_text flag *disables*
    # text, train_tiktok.py:1396-1397; empty is the default training signal)
    use_text: bool = False
    logging_steps: int = 100
    logging_gen_steps: int = 1000
    # DDIM steps for the periodic sample-grid visualization
    vis_steps: int = 20
    save_steps: int = 2500
    save_total_limit: int = 5
    output_dir: str = "runs/default"
    resume: bool = True
    mesh_axes: tuple[str, ...] = ("data",)
    # attention implementation inside the train step's denoiser forward and
    # backward (ops/attention.py::attention_impl): "auto" trains the kernel
    # sites through the backward kernels (ops.kernels.flash_vjp), "flash"
    # every site, "xla" none (the plain math). The VAE and CLIP stay "auto".
    attention_impl: str = "auto"
    # frozen-VAE encode runs in chunks of this many images when the batch
    # exceeds it (and divides by it), bounding the full-resolution fp32
    # encoder activations. 0 disables chunking.
    vae_encode_chunk: int = 8


def _to_tuple(x: Any) -> Any:
    if isinstance(x, list):
        return tuple(_to_tuple(v) for v in x)
    return x


def _optional_dataclass(cls, name: str):
    """The dataclass X of a field annotated Optional[X], else None."""
    hint = typing.get_type_hints(cls).get(name)
    args = [a for a in typing.get_args(hint) if a is not type(None)]
    return args[0] if len(args) == 1 and dataclasses.is_dataclass(args[0]) else None


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
        elif isinstance(v, dict) and _optional_dataclass(cls, k) is not None:
            # a nested config whose default is None (ModelConfig.image_control)
            kwargs[k] = from_dict(_optional_dataclass(cls, k), v)
        elif isinstance(declared, enum.Enum) and isinstance(v, str):
            kwargs[k] = type(declared)(v)
        else:
            kwargs[k] = _to_tuple(v)
    return cls(**kwargs)


def to_dict(cfg) -> dict[str, Any]:
    """A plain dict of a config; the port's own fields are left out while
    they hold their defaults."""
    def _convert(obj):
        if dataclasses.is_dataclass(obj):
            return {f.name: _convert(getattr(obj, f.name)) for f in dataclasses.fields(obj)
                    if not (f.metadata.get("port_only") and getattr(obj, f.name) == f.default)}
        if isinstance(obj, enum.Enum):
            return obj.value
        if isinstance(obj, tuple):
            return [_convert(v) for v in obj]
        return obj

    return _convert(cfg)


def load_json(path: str, cls=TrainConfig):
    with open(path) as f:
        return from_dict(cls, json.load(f))


def load_yaml(path: str, cls=TrainConfig):
    try:
        import yaml  # type: ignore
    except ImportError as e:  # pragma: no cover
        raise ImportError("pyyaml not available; use load_json") from e
    with open(path) as f:
        return from_dict(cls, yaml.safe_load(f))


def save_json(cfg, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2)


# Canonical presets mirroring the reference's shipped YAML + script recipes.
def stage1_appearance_pretrain() -> TrainConfig:
    """scripts/appearance_control_pretraining.sh equivalent."""
    return TrainConfig(
        model=ModelConfig(variant=ModelVariant.APPEARANCE),
        freeze=FreezeRegime.APPEARANCE_PRETRAIN,
        batch_size_per_device=32,
        img_bin_limit=15,
    )


def stage2_pose_control() -> TrainConfig:
    """scripts/appearance_disentangle_pose_control.sh equivalent."""
    return TrainConfig(
        model=ModelConfig(variant=ModelVariant.APPEARANCE_POSE),
        freeze=FreezeRegime.FINETUNE_CONTROL,
        batch_size_per_device=8,
        img_bin_limit=29,
    )


def stage3_motion() -> TrainConfig:
    """Motion-module training (code-present-but-unshipped stage 3,
    ref train_tiktok.py:847-956): one clip of `video_frames` frames per
    step, only the motion modules train."""
    return TrainConfig(
        model=ModelConfig(
            variant=ModelVariant.APPEARANCE_POSE_TEMPORAL,
            unet=UNetConfig(use_motion_modules=True),
        ),
        freeze=FreezeRegime.MOTION_ONLY,
        batch_size_per_device=1,
    )
