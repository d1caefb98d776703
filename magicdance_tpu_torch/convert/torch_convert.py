"""Reference PyTorch checkpoints straight into the port's modules.

The port's counterpart of `magicdance_tpu.convert.torch_convert`, without the
Flax tree in between. The reference checkpoints -- `model_state-{step}.th`
(the full ControlLDMReferenceOnlyPose state dict), `control_sd15_ini.ckpt`,
plain SD1.5 `.ckpt`, AnimateDiff `mm_sd_v15` motion modules -- use the
LDM / openai-UNet key anatomy: `input_blocks.{i}.{j}` where j = 0 is the
ResBlock (`in_layers.0` GN, `in_layers.2` conv, `emb_layers.1`,
`out_layers.0` GN, `out_layers.3` conv, `skip_connection`) and j = 1 the
SpatialTransformer (`norm`, `proj_in`, `transformer_blocks.{d}.attn1/attn2.
to_q/to_k/to_v/to_out.0`, `ff.net.0.proj`, `ff.net.2`, `norm1..3`,
`proj_out`); downsamples are `input_blocks.{i}.0.op`, `out.0` / `out.2` the
head; the ControlNet adds `input_hint_block.{0,2,..,14}`, `zero_convs.{i}.0`
and `middle_block_out.0`.

The port's modules carry the Flax module names (`enc_res_0`,
`block_0.attn1.to_q`, `zero_conv_mid`, ...) in PyTorch layouts: a conv weight
is OIHW and a linear weight (out, in) on both sides, so the map is a table of
key pairs and no tensor is transposed. `reference_key_map(cfg)` is the
table of the current layout; `convert_magicpose_state` applies it, with the
reference's checkpoint surgery for the legacy `control_model.*` layout
(ref train_tiktok.py:94-102, 128-249). Values stay the checkpoint's tensors
(fp32, fp16 or bf16); `load_state_dict` casts each to its parameter's dtype.

`to_flax` is the reverse direction, port state dicts -> the JAX package's
{"model", "vae", "clip"} trees with numpy leaves (the inverse of
`convert.from_jax`).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Tuple

import numpy as np
import torch

from magicdance_tpu_torch.config import (
    CLIPTextConfig,
    ControlNetConfig,
    ModelConfig,
    UNetConfig,
    VAEConfig,
)
from magicdance_tpu_torch.models.unet import unet_plan

Pairs = List[Tuple[str, str]]
State = Dict[str, torch.Tensor]

UNET = "model.diffusion_model"
APPEARANCE = "appearance_control_model"
POSE = "pose_control_model"
LEGACY_CONTROL = "control_model"
VAE = "first_stage_model"
CLIP = "cond_stage_model.transformer"


def load_torch_state(path: str) -> State:
    """A torch checkpoint as a flat {key: tensor} dict on the CPU.

    Takes the reference's containers: a raw state dict or
    {"state_dict": ...} (.ckpt); anything else (an optimizer file, a bare
    tensor) is rejected. Tensors keep their dtype."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if not isinstance(obj, dict):
        raise ValueError(f"unsupported checkpoint container in {path}")
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


# ---------------------------------------------------------------------------
# elementary maps: (reference key, port key) pairs of one layer
# ---------------------------------------------------------------------------

def _conv(ref: str, port: str, bias: bool = True) -> Pairs:
    out = [(f"{ref}.weight", f"{port}.weight")]
    if bias:
        out.append((f"{ref}.bias", f"{port}.bias"))
    return out


_linear = _conv  # (out, in) on both sides
_norm = _conv    # weight / bias on both sides


def _gn32(ref: str, port: str) -> Pairs:
    # the GroupNorm32 wrapper holds its parameters under a child `norm`
    return _norm(ref, f"{port}.norm")


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------

def _resblock(ref: str, port: str, has_skip: bool) -> Pairs:
    out = (_gn32(f"{ref}.in_layers.0", f"{port}.norm_in")
           + _conv(f"{ref}.in_layers.2", f"{port}.conv_in")
           + _linear(f"{ref}.emb_layers.1", f"{port}.emb_proj")
           + _gn32(f"{ref}.out_layers.0", f"{port}.norm_out")
           + _conv(f"{ref}.out_layers.3", f"{port}.conv_out"))
    if has_skip:
        out += _conv(f"{ref}.skip_connection", f"{port}.skip")
    return out


def _attention(ref: str, port: str) -> Pairs:
    return (_linear(f"{ref}.to_q", f"{port}.to_q", bias=False)
            + _linear(f"{ref}.to_k", f"{port}.to_k", bias=False)
            + _linear(f"{ref}.to_v", f"{port}.to_v", bias=False)
            + _linear(f"{ref}.to_out.0", f"{port}.to_out"))


def _transformer_block(ref: str, port: str) -> Pairs:
    return (_attention(f"{ref}.attn1", f"{port}.attn1")
            + _attention(f"{ref}.attn2", f"{port}.attn2")
            + _linear(f"{ref}.ff.net.0.proj", f"{port}.ff.proj_in")
            + _linear(f"{ref}.ff.net.2", f"{port}.ff.proj_out")
            + _norm(f"{ref}.norm1", f"{port}.norm1")
            + _norm(f"{ref}.norm2", f"{port}.norm2")
            + _norm(f"{ref}.norm3", f"{port}.norm3"))


def _spatial_transformer(ref: str, port: str, depth: int) -> Pairs:
    out = (_gn32(f"{ref}.norm", f"{port}.norm")
           + _conv(f"{ref}.proj_in", f"{port}.proj_in")
           + _conv(f"{ref}.proj_out", f"{port}.proj_out"))
    for d in range(depth):
        out += _transformer_block(f"{ref}.transformer_blocks.{d}", f"{port}.block_{d}")
    return out


def _encoder(p: str, q: str, cfg: UNetConfig) -> Pairs:
    """conv_in, the encoder units and the middle block (shared by the UNet
    and the ControlNet). The torch `input_blocks` index starts at 1 (0 is
    conv_in)."""
    out = (_linear(f"{p}.time_embed.0", f"{q}time_embed.fc1")
           + _linear(f"{p}.time_embed.2", f"{q}time_embed.fc2")
           + _conv(f"{p}.input_blocks.0.0", f"{q}conv_in"))
    units, _, _ = unet_plan(cfg)
    res_i = attn_i = down_i = 0
    in_ch = cfg.model_channels
    for tb, u in enumerate(units, start=1):
        if u["kind"] == "res":
            out += _resblock(f"{p}.input_blocks.{tb}.0", f"{q}enc_res_{res_i}",
                             has_skip=in_ch != u["ch"])
            in_ch = u["ch"]
            if u["attn"]:
                out += _spatial_transformer(f"{p}.input_blocks.{tb}.1", f"{q}enc_attn_{attn_i}",
                                            cfg.transformer_depth)
                attn_i += 1
            res_i += 1
        else:
            out += _conv(f"{p}.input_blocks.{tb}.0.op", f"{q}enc_down_{down_i}.conv")
            down_i += 1
    out += (_resblock(f"{p}.middle_block.0", f"{q}mid_res_0", has_skip=False)
            + _spatial_transformer(f"{p}.middle_block.1", f"{q}mid_attn", cfg.transformer_depth)
            + _resblock(f"{p}.middle_block.2", f"{q}mid_res_1", has_skip=False))
    return out


def unet_key_map(prefix: str, cfg: UNetConfig, port_prefix: str = "") -> Pairs:
    """`{prefix}.*` UNet keys -> the port's UNet (its state-dict keys under
    `port_prefix`). The main UNet (`model.diffusion_model`) and the
    appearance branch (`appearance_control_model`, same architecture; its
    unused `input_hint_block` keys are not read). Motion modules are not
    part of it (see `motion_module_key_map`)."""
    p, q = prefix.rstrip("."), port_prefix
    out = _encoder(p, q, cfg)
    # decoder: every res block concatenates a skip, so skip_connection exists
    ds = 2 ** (len(cfg.channel_mult) - 1)
    dec_i = dattn_i = up_i = tb = 0
    for level in reversed(range(len(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            out += _resblock(f"{p}.output_blocks.{tb}.0", f"{q}dec_res_{dec_i}", has_skip=True)
            dec_i += 1
            j = 1
            if ds in cfg.attention_resolutions:
                out += _spatial_transformer(f"{p}.output_blocks.{tb}.{j}",
                                            f"{q}dec_attn_{dattn_i}", cfg.transformer_depth)
                dattn_i += 1
                j += 1
            if level != 0 and i == cfg.num_res_blocks:
                out += _conv(f"{p}.output_blocks.{tb}.{j}.conv", f"{q}dec_up_{up_i}.conv")
                up_i += 1
                ds //= 2
            tb += 1
    return out + _gn32(f"{p}.out.0", f"{q}norm_out") + _conv(f"{p}.out.2", f"{q}conv_out")


# ---------------------------------------------------------------------------
# ControlNet
# ---------------------------------------------------------------------------

def controlnet_key_map(prefix: str, cfg: ControlNetConfig, port_prefix: str = "") -> Pairs:
    """ControlNet keys (`pose_control_model` / `control_model`) -> the
    port's PoseControlNet (ref cldm.py:500-757)."""
    p, q = prefix.rstrip("."), port_prefix
    ucfg = UNetConfig(model_channels=cfg.model_channels, channel_mult=cfg.channel_mult,
                      num_res_blocks=cfg.num_res_blocks,
                      attention_resolutions=cfg.attention_resolutions,
                      num_heads=cfg.num_heads, transformer_depth=cfg.transformer_depth,
                      context_dim=cfg.context_dim)
    out = _encoder(p, q, ucfg)
    # hint CNN: torch indices 0, 2, ..., 12 (SiLU between) -> conv_0..6,
    # 14 -> conv_out
    for i in range(7):
        out += _conv(f"{p}.input_hint_block.{2 * i}", f"{q}hint_encoder.conv_{i}")
    out += _conv(f"{p}.input_hint_block.14", f"{q}hint_encoder.conv_out")
    for i in range(len(unet_plan(ucfg)[0]) + 1):
        out += _conv(f"{p}.zero_convs.{i}.0", f"{q}zero_conv_{i}")
    return out + _conv(f"{p}.middle_block_out.0", f"{q}zero_conv_mid")


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------

def _vae_resblock(ref: str, port: str, has_shortcut: bool) -> Pairs:
    out = (_norm(f"{ref}.norm1", f"{port}.norm1") + _conv(f"{ref}.conv1", f"{port}.conv1")
           + _norm(f"{ref}.norm2", f"{port}.norm2") + _conv(f"{ref}.conv2", f"{port}.conv2"))
    if has_shortcut:
        out += _conv(f"{ref}.nin_shortcut", f"{port}.nin_shortcut")
    return out


def _vae_attn(ref: str, port: str) -> Pairs:
    # 1x1 q / k / v / proj_out convs
    return (_norm(f"{ref}.norm", f"{port}.norm")
            + [pair for n in ("q", "k", "v", "proj_out")
               for pair in _conv(f"{ref}.{n}", f"{port}.{n}")])


def _vae_mid(ref: str, port: str) -> Pairs:
    return (_vae_resblock(f"{ref}.mid.block_1", f"{port}.mid_block_1", False)
            + _vae_attn(f"{ref}.mid.attn_1", f"{port}.mid_attn_1")
            + _vae_resblock(f"{ref}.mid.block_2", f"{port}.mid_block_2", False))


def vae_key_map(prefix: str, cfg: VAEConfig, port_prefix: str = "") -> Pairs:
    """`first_stage_model.*` -> the port's AutoencoderKL
    (ref ldm/models/autoencoder.py, modules/diffusionmodules/model.py)."""
    e, d = f"{prefix.rstrip('.')}.encoder", f"{prefix.rstrip('.')}.decoder"
    qe, qd = f"{port_prefix}encoder", f"{port_prefix}decoder"
    out = _conv(f"{e}.conv_in", f"{qe}.conv_in")
    ch = cfg.base_channels
    for level, mult in enumerate(cfg.channel_mult):
        out_ch = cfg.base_channels * mult
        for b in range(cfg.num_res_blocks):
            out += _vae_resblock(f"{e}.down.{level}.block.{b}", f"{qe}.down_{level}_block_{b}",
                                 has_shortcut=ch != out_ch)
            ch = out_ch
        if level != len(cfg.channel_mult) - 1:
            out += _conv(f"{e}.down.{level}.downsample.conv", f"{qe}.down_{level}_downsample.conv")
    out += (_vae_mid(e, qe) + _norm(f"{e}.norm_out", f"{qe}.norm_out")
            + _conv(f"{e}.conv_out", f"{qe}.conv_out"))

    out += _conv(f"{d}.conv_in", f"{qd}.conv_in") + _vae_mid(d, qd)
    ch = cfg.base_channels * cfg.channel_mult[-1]
    for level in reversed(range(len(cfg.channel_mult))):
        out_ch = cfg.base_channels * cfg.channel_mult[level]
        for b in range(cfg.num_res_blocks + 1):
            out += _vae_resblock(f"{d}.up.{level}.block.{b}", f"{qd}.up_{level}_block_{b}",
                                 has_shortcut=ch != out_ch)
            ch = out_ch
        if level != 0:
            out += _conv(f"{d}.up.{level}.upsample.conv", f"{qd}.up_{level}_upsample.conv")
    p = prefix.rstrip(".")
    return (out + _norm(f"{d}.norm_out", f"{qd}.norm_out") + _conv(f"{d}.conv_out", f"{qd}.conv_out")
            + _conv(f"{p}.quant_conv", f"{port_prefix}quant_conv")
            + _conv(f"{p}.post_quant_conv", f"{port_prefix}post_quant_conv"))


# ---------------------------------------------------------------------------
# CLIP text encoder
# ---------------------------------------------------------------------------

def clip_key_map(prefix: str, cfg: CLIPTextConfig, port_prefix: str = "",
                 text_model: bool = False) -> Pairs:
    """HF CLIPTextModel keys (`cond_stage_model.transformer.*`, with or
    without the `text_model.` level) -> the port's CLIPTextEncoder (ref
    encoders/modules.py:88 FrozenCLIPEmbedder). The `position_ids` buffer
    is not read."""
    p, q = prefix.rstrip("."), port_prefix
    tm = ".".join(s for s in (p, "text_model" if text_model else "") if s)
    e = f"{tm}." if tm else ""
    out = [(f"{e}embeddings.token_embedding.weight", f"{q}token_embedding.weight"),
           (f"{e}embeddings.position_embedding.weight", f"{q}position_embedding")]
    out += _norm(f"{e}final_layer_norm", f"{q}final_layer_norm")
    for i in range(cfg.num_layers):
        lp, lq = f"{e}encoder.layers.{i}", f"{q}layer_{i}"
        out += [pair for n in ("q_proj", "k_proj", "v_proj", "out_proj")
                for pair in _linear(f"{lp}.self_attn.{n}", f"{lq}.self_attn.{n}")]
        out += (_norm(f"{lp}.layer_norm1", f"{lq}.layer_norm1")
                + _norm(f"{lp}.layer_norm2", f"{lq}.layer_norm2")
                + _linear(f"{lp}.mlp.fc1", f"{lq}.fc1")
                + _linear(f"{lp}.mlp.fc2", f"{lq}.fc2"))
    return out


def _has_text_model(sd: Mapping[str, Any], prefix: str) -> bool:
    p = prefix.rstrip(".")
    return f"{p + '.' if p else ''}text_model.final_layer_norm.weight" in sd


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def reference_key_map(cfg: ModelConfig, vae: bool = True, clip: bool = True,
                      text_model: bool = False) -> Pairs:
    """The table of a full `model_state-*.th` in the current layout:
    (reference key, port key) for the main UNet, the appearance UNet, the
    pose ControlNet, the VAE and CLIP. Port keys are prefixed with the
    network they belong to: `model.` (MagicPoseModel), `vae.`
    (AutoencoderKL) or `clip.` (CLIPTextEncoder). The DUAL_CONTROL image
    ControlNet and motion modules have no entry (the reference's converter
    converts neither from this file)."""
    from magicdance_tpu_torch.models.magicpose import appearance_unet_config

    out = unet_key_map(UNET, cfg.unet, "model.unet.")
    if cfg.has_appearance:
        out += unet_key_map(APPEARANCE, appearance_unet_config(cfg), "model.appearance_unet.")
    if cfg.has_pose:
        out += controlnet_key_map(POSE, cfg.pose_control, "model.pose_control.")
    if vae:
        out += vae_key_map(VAE, cfg.vae, "vae.")
    if clip:
        out += clip_key_map(CLIP, cfg.clip, "clip.", text_model=text_model)
    return out


def reference_shapes(cfg: ModelConfig, pairs: Iterable[Tuple[str, str]]) -> Dict[str, tuple]:
    """{reference key: shape} for `pairs` of `reference_key_map(cfg)`: the
    port's parameter shapes, which are the reference's (no transposes),
    read from the networks built on the meta device."""
    from magicdance_tpu_torch.models import AutoencoderKL, CLIPTextEncoder, MagicPoseModel

    with torch.device("meta"):
        nets = {"model": MagicPoseModel(cfg), "vae": AutoencoderKL(cfg.vae),
                "clip": CLIPTextEncoder(cfg.clip)}
    shapes = {f"{name}.{k}": tuple(v.shape) for name, net in nets.items()
              for k, v in net.state_dict().items()}
    return {ref: shapes[port] for ref, port in pairs}


def _gather(sd: Mapping[str, torch.Tensor], pairs: Pairs) -> State:
    missing = [ref for ref, _ in pairs if ref not in sd]
    if missing:
        raise KeyError(f"{len(missing)} reference keys missing from the checkpoint, "
                       f"e.g. {missing[:5]}")
    return {port: sd[ref] for ref, port in pairs}


def convert_magicpose_state(sd: Mapping[str, torch.Tensor], cfg: ModelConfig
                            ) -> Dict[str, State]:
    """A full `model_state-*.th` -> {"model", "vae", "clip"} state dicts
    for MagicPoseModel, AutoencoderKL and CLIPTextEncoder; "vae" and "clip"
    only when the checkpoint has their keys.

    The legacy layout (`control_model.*` and no `appearance_control_model.*`,
    control_sd15_ini.ckpt) goes through the reference's surgery
    (train_tiktok.py:94-102, 236-249): `control_model` initializes both the
    appearance UNet -- its missing `output_blocks` / `out.` taken from the
    SD UNet (`model.diffusion_model`) -- and the pose ControlNet. The
    returned dicts may share tensors (the surgery maps one reference tensor
    to two parameters); `load_state_dict` copies each into its own
    parameter."""
    from magicdance_tpu_torch.models.magicpose import appearance_unet_config

    keys = list(sd.keys())

    def has(prefix):
        return any(k.startswith(prefix + ".") for k in keys)

    legacy = has(LEGACY_CONTROL)
    pairs = unet_key_map(UNET, cfg.unet, "unet.")
    if cfg.has_appearance:
        if has(APPEARANCE):
            pairs += unet_key_map(APPEARANCE, appearance_unet_config(cfg), "appearance_unet.")
        elif legacy:
            decoder = (f"{LEGACY_CONTROL}.output_blocks", f"{LEGACY_CONTROL}.out.")
            pairs += [(UNET + ref[len(LEGACY_CONTROL):] if ref.startswith(decoder) else ref, port)
                      for ref, port in unet_key_map(LEGACY_CONTROL, appearance_unet_config(cfg),
                                                    "appearance_unet.")]
        else:
            raise KeyError("no appearance/control keys in checkpoint")
    if cfg.has_pose:
        if has(POSE):
            pairs += controlnet_key_map(POSE, cfg.pose_control, "pose_control.")
        elif legacy:
            pairs += controlnet_key_map(LEGACY_CONTROL, cfg.pose_control, "pose_control.")
        else:
            raise KeyError("no pose/control keys in checkpoint")

    out = {"model": _gather(sd, pairs)}
    if has(VAE):
        out["vae"] = _gather(sd, vae_key_map(VAE, cfg.vae))
    if has(CLIP):
        out["clip"] = _gather(sd, clip_key_map(CLIP, cfg.clip,
                                               text_model=_has_text_model(sd, CLIP)))
    return out


# ---------------------------------------------------------------------------
# motion modules (AnimateDiff)
# ---------------------------------------------------------------------------

def motion_module_key_map(prefix: str, port_prefix: str, layers: int, attns: int) -> Pairs:
    """One VanillaTemporalModule (`{prefix}.temporal_transformer.*`, ref
    motion_module.py:86-209) -> the port's TemporalTransformer. The
    pos_encoder `pe` buffer is not read: the module recomputes the sinusoid
    (motion_module.py:227-241)."""
    tt, q = f"{prefix}.temporal_transformer", port_prefix
    out = (_gn32(f"{tt}.norm", f"{q}.norm") + _linear(f"{tt}.proj_in", f"{q}.proj_in")
           + _linear(f"{tt}.proj_out", f"{q}.proj_out"))
    for i in range(layers):
        b = f"{tt}.transformer_blocks.{i}"
        for j in range(attns):
            out += (_attention(f"{b}.attention_blocks.{j}", f"{q}.attn_{i}_{j}")
                    + _norm(f"{b}.norms.{j}", f"{q}.norm_attn_{i}_{j}"))
        out += (_norm(f"{b}.ff_norm", f"{q}.norm_ff_{i}")
                + _linear(f"{b}.ff.net.0.proj", f"{q}.ff_{i}.proj_in")
                + _linear(f"{b}.ff.net.2", f"{q}.ff_{i}.proj_out"))
    return out


def _motion_sites(sd: Mapping[str, Any], cfg: UNetConfig) -> List[Tuple[str, str]]:
    """(reference module prefix, port module name) of every motion module
    the checkpoint holds.

    The reference's `merge_state_dict_mm` remap (train_tiktok.py:146-192):
    public AnimateDiff checkpoints (mm_sd_v15 layout) store modules as
    `down_blocks.{i}.motion_modules.{j}` / `up_blocks.{i}.motion_modules.{j}`,
    mapped to `enc_motion_{i*R+j}` / `dec_motion_{i*(R+1)+j}` with R =
    num_res_blocks; mid-block modules are skipped, as the reference skips
    them. Checkpoints in the reference's own
    `[model.diffusion_model.]{input,output}_blocks_motion_module.{k}.0` layout
    are accepted too."""
    keys = list(sd.keys())

    def held(prefix):
        return any(k.startswith(prefix) for k in keys)

    sites = []
    if any(".motion_modules." in k for k in keys):
        R = cfg.num_res_blocks
        for i in range(len(cfg.channel_mult)):
            sites += [(f"down_blocks.{i}.motion_modules.{j}", f"enc_motion_{i * R + j}")
                      for j in range(R)]
            sites += [(f"up_blocks.{i}.motion_modules.{j}", f"dec_motion_{i * (R + 1) + j}")
                      for j in range(R + 1)]
    else:
        n_enc = sum(1 for u in unet_plan(cfg)[0] if u["kind"] == "res")
        n_dec = (cfg.num_res_blocks + 1) * len(cfg.channel_mult)
        for side, n, name in (("input", n_enc, "enc"), ("output", n_dec, "dec")):
            for k in range(n):
                p = f"{UNET}.{side}_blocks_motion_module.{k}.0"
                if not held(p):
                    p = f"{side}_blocks_motion_module.{k}.0"
                sites.append((p, f"{name}_motion_{k}"))
    return [(p, name) for p, name in sites if held(p)]


def convert_motion_modules(sd: Mapping[str, torch.Tensor], cfg: UNetConfig) -> State:
    """An AnimateDiff (or reference-layout) motion-module checkpoint -> the
    UNet state-dict entries of its `enc_motion_k` / `dec_motion_k`."""
    pairs = [pair for ref, name in _motion_sites(sd, cfg)
             for pair in motion_module_key_map(ref, name, cfg.motion_layers,
                                               cfg.motion_attn_blocks)]
    if not pairs:
        raise KeyError("no motion-module keys found in checkpoint")
    return _gather(sd, pairs)


def merge_motion_state(unet_state: Mapping[str, torch.Tensor],
                       mm_state: Mapping[str, torch.Tensor]) -> State:
    """Overlay converted motion modules onto a UNet state dict (the
    `merge_state_dict_mm` merge step, ref train_tiktok.py:146): the temporal
    UNet initialized from an image checkpoint + AnimateDiff motion weights.
    Entries of the UNet not in `mm_state` are kept."""
    return {**unet_state, **mm_state}


def expand_conv_in(unet_state: Mapping[str, torch.Tensor], new_in_channels: int) -> State:
    """Zero-pad the UNet's input conv (`conv_in.weight`, OIHW) to
    `new_in_channels` input channels -- the mask-variant first-conv surgery
    (ref train_tiktok.py:251-271: the added channels start at zero, so the
    pretrained 4-channel behavior is kept). Apply it to the main UNet only:
    the appearance UNet reads the bare reference latent."""
    w = unet_state["conv_in.weight"]
    cur = w.shape[1]
    if new_in_channels < cur:
        raise ValueError(f"cannot shrink conv_in {cur} -> {new_in_channels}")
    if new_in_channels == cur:
        return dict(unet_state)
    pad = w.new_zeros((w.shape[0], new_in_channels - cur) + tuple(w.shape[2:]))
    return {**unet_state, "conv_in.weight": torch.cat([w, pad], dim=1)}


# ---------------------------------------------------------------------------
# loading, and the reverse direction
# ---------------------------------------------------------------------------

def load_strict(module: torch.nn.Module, state: Mapping[str, torch.Tensor],
                name: str) -> None:
    """`module.load_state_dict(state, strict=True)`, after a check that
    names what is missing or left over by network part (e.g. the motion
    modules a single-file checkpoint lacks)."""
    want = set(module.state_dict())
    missing, unexpected = sorted(want - set(state)), sorted(set(state) - want)
    if missing or unexpected:
        def parts(keys):
            out: Dict[str, int] = {}
            for k in keys:
                head = ".".join(k.split(".")[:2])
                out[head] = out.get(head, 0) + 1
            return out

        raise KeyError(f"{name}: {len(missing)} parameters missing from the converted state "
                       f"{parts(missing)}, {len(unexpected)} unexpected {parts(unexpected)}")
    module.load_state_dict(state, strict=True)


def _flax_leaf(key: str, t: torch.Tensor) -> Tuple[Tuple[str, ...], np.ndarray]:
    *mods, name = key.split(".")
    a = t.detach().float().cpu().numpy()
    if name == "weight":
        if a.ndim == 4:          # Conv2d OIHW -> Conv HWIO
            name, a = "kernel", a.transpose(2, 3, 1, 0)
        elif a.ndim == 2 and mods[-1] == "token_embedding":
            name = "embedding"   # nn.Embed
        elif a.ndim == 2:        # Linear (out, in) -> Dense (in, out)
            name, a = "kernel", a.T
        else:                    # GroupNorm / LayerNorm
            name = "scale"
    return tuple(mods) + (name,), np.ascontiguousarray(a)


def to_flax(state_dicts: Mapping[str, Mapping[str, torch.Tensor]]) -> Dict[str, Any]:
    """Port state dicts ({"model", "vae", "clip"} or any subset) -> the JAX
    package's {"model": {"params": tree}, ...} with fp32 numpy leaves: the
    inverse of `convert.from_jax.flax_to_state_dict`."""
    out: Dict[str, Any] = {}
    for net, sd in state_dicts.items():
        tree: Dict[str, Any] = {}
        for key, t in sd.items():
            path, leaf = _flax_leaf(key, t)
            node = tree
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = leaf
        out[net] = {"params": tree}
    return out
