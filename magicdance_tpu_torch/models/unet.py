"""SD1.5 UNet with appearance-bank, pose-ControlNet and motion-module hooks
(PyTorch).

Counterpart of `magicdance_tpu.models.unet.UNet` without the turbo levers
(DeepCache, self-KV pooling, the bank mask):

  * `collect_bank=True` -- appearance "write" pass: every transformer block
    returns norm1 of its input; the tuple of all entries, in traversal order
    (encoder, middle, decoder), is the appearance bank.
  * `bank=(...)` -- main "read" pass: each block's self-attention also
    attends over its bank entry (batch 1, broadcast, or batch B).
  * neither -- plain SD1.5 forward (the CFG uncond pass).
  * `pose_residuals=(r0..r11, r_mid)` -- ControlNet residuals, NHWC, added
    to the middle block output and to each decoder skip.
  * `cfg.use_motion_modules` -- an AnimateDiff temporal module
    (`layers.TemporalTransformer`) after every encoder res unit
    (`enc_motion_i`) and every decoder unit before its upsample
    (`dec_motion_i`), none in the middle block: 20 at SD1.5 width. The batch
    holds clips of `num_frames` frames, clip major; with num_frames = 1 the
    modules still run, over one frame, as in JAX.

Public layout is NHWC like the JAX package: x (B, h, w, C) in, eps
(B, h, w, C) fp32 out. The compute dtype is `compute_dtype` when set (the
composite model sets it from `ModelConfig.dtype`), else the dtype of the
parameters. With `cfg.remat` every ResBlock and SpatialTransformer is
recomputed in the backward pass (`layers.remat`), and so is every motion
module; bank entries written inside a recomputed block keep their gradient.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from magicdance_tpu_torch.config import UNetConfig
from magicdance_tpu_torch.models.layers import (
    Downsample,
    GroupNorm32,
    ResBlock,
    SpatialTransformer,
    TemporalTransformer,
    TimestepEmbedMLP,
    Upsample,
    conv3x3,
    remat,
)
from magicdance_tpu_torch.ops.schedules import timestep_embedding

Bank = Tuple[torch.Tensor, ...]


def unet_plan(cfg: UNetConfig):
    """Static encoder plan shared by the UNet and the pose ControlNet.

    Returns (enc_units, skip_channels, final_ds); each unit is a dict
    {kind: "res"|"down", ch, attn, level, ds}."""
    units = []
    skip_ch = [cfg.model_channels]
    ch = cfg.model_channels
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        out_ch = cfg.model_channels * mult
        for _ in range(cfg.num_res_blocks):
            units.append(dict(kind="res", ch=out_ch, attn=ds in cfg.attention_resolutions,
                              level=level, ds=ds))
            ch = out_ch
            skip_ch.append(ch)
        if level != len(cfg.channel_mult) - 1:
            units.append(dict(kind="down", ch=ch, attn=False, level=level, ds=ds))
            ds *= 2
            skip_ch.append(ch)
    return units, skip_ch, ds


def decoder_plan(cfg: UNetConfig):
    """Decoder units in traversal order (deepest level first) with their
    module names: {level, ch, attn, ds, upsample, name_res, name_attn,
    name_mm, name_up}. The forward loop and `num_bank_entries` both derive
    from it."""
    units = []
    ds = max(1, 2 ** (len(cfg.channel_mult) - 1))
    attn_i = up_i = 0
    for level in reversed(range(len(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            attn = ds in cfg.attention_resolutions
            upsample = level != 0 and i == cfg.num_res_blocks
            idx = len(units)
            units.append(dict(
                level=level,
                ch=cfg.model_channels * cfg.channel_mult[level],
                attn=attn,
                ds=ds,
                upsample=upsample,
                name_res=f"dec_res_{idx}",
                name_attn=f"dec_attn_{attn_i}" if attn else None,
                name_mm=f"dec_motion_{idx}",
                name_up=f"dec_up_{up_i}" if upsample else None,
            ))
            if attn:
                attn_i += 1
            if upsample:
                up_i += 1
        if level != 0:
            ds //= 2
    return units


def num_bank_entries(cfg: UNetConfig) -> int:
    """Bank sites in traversal order: encoder + middle + decoder."""
    enc = sum(1 for u in unet_plan(cfg)[0] if u["attn"])
    dec = sum(1 for u in decoder_plan(cfg) if u["attn"])
    return (enc + 1 + dec) * cfg.transformer_depth


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """A view: an NHWC tensor seen as NCHW (channels_last in memory)."""
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class UNet(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype: Optional[torch.dtype] = None
        mc = cfg.model_channels
        emb_dim = 4 * mc
        heads, depth, ctx_dim = cfg.num_heads, cfg.transformer_depth, cfg.context_dim

        def st(ch):
            return SpatialTransformer(ch, heads, ch // heads, depth, ctx_dim)

        def add_motion(name, ch):
            if cfg.use_motion_modules:
                self.add_module(name, TemporalTransformer(
                    ch, cfg.motion_num_heads, cfg.motion_max_len, cfg.motion_layers,
                    cfg.motion_attn_blocks))

        self.time_embed = TimestepEmbedMLP(mc)
        self.conv_in = conv3x3(cfg.in_channels, mc)
        units, skip_ch, _ = unet_plan(cfg)
        ch = mc
        res_i = down_i = attn_i = 0
        for u in units:
            if u["kind"] == "res":
                self.add_module(f"enc_res_{res_i}", ResBlock(ch, u["ch"], emb_dim))
                ch = u["ch"]
                if u["attn"]:
                    self.add_module(f"enc_attn_{attn_i}", st(ch))
                    attn_i += 1
                add_motion(f"enc_motion_{res_i}", ch)
                res_i += 1
            else:
                self.add_module(f"enc_down_{down_i}", Downsample(ch))
                down_i += 1
        mid_ch = mc * cfg.channel_mult[-1]
        self.mid_res_0 = ResBlock(ch, mid_ch, emb_dim)
        self.mid_attn = st(mid_ch)
        self.mid_res_1 = ResBlock(mid_ch, mid_ch, emb_dim)
        ch = mid_ch
        skips = list(skip_ch)
        for u in decoder_plan(cfg):
            self.add_module(u["name_res"], ResBlock(ch + skips.pop(), u["ch"], emb_dim))
            ch = u["ch"]
            if u["attn"]:
                self.add_module(u["name_attn"], st(ch))
            add_motion(u["name_mm"], ch)
            if u["upsample"]:
                self.add_module(u["name_up"], Upsample(ch))
        self.norm_out = GroupNorm32(ch, act=True)
        self.conv_out = conv3x3(ch, cfg.out_channels)

    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        context: Optional[torch.Tensor],
        *,
        bank: Optional[Bank] = None,
        collect_bank: bool = False,
        pose_residuals: Optional[Sequence[torch.Tensor]] = None,
        num_frames: int = 1,
    ):
        """x: (B, h, w, C), B = clips x num_frames; timesteps: (B,); context:
        (B, 77, context_dim); bank: entries (Bb, S_i, C_i), Bb in {1, B};
        pose_residuals: 13 NHWC tensors, [0..11] per encoder skip, [12] middle.
        Returns (eps (B, h, w, out_channels) fp32, bank_written)."""
        cfg = self.cfg
        if bank is not None and collect_bank:
            raise ValueError("bank write and read are exclusive")
        if bank is not None and len(bank) != num_bank_entries(cfg):
            raise ValueError(f"bank has {len(bank)} entries, expected "
                             f"{num_bank_entries(cfg)}")
        dtype = self.compute_dtype or self.conv_in.weight.dtype
        depth = cfg.transformer_depth
        bank_read = list(bank) if bank is not None else None
        bank_written: list[torch.Tensor] = []

        def take_bank():
            if bank_read is None:
                return None
            return tuple(bank_read.pop(0) for _ in range(depth))

        def residual(i):
            return nhwc_to_nchw(pose_residuals[i])

        def motion(h, name):
            if not cfg.use_motion_modules:
                return h
            return remat(cfg.remat, getattr(self, name), h, num_frames)

        emb = self.time_embed(timestep_embedding(timesteps, cfg.model_channels,
                                                 dtype=dtype))
        if context is not None:
            context = context.to(dtype)

        h = self.conv_in(nhwc_to_nchw(x.to(dtype)))
        hs = [h]
        units, _, _ = unet_plan(cfg)
        res_i = down_i = attn_i = 0
        for u in units:
            if u["kind"] == "res":
                h = remat(cfg.remat, getattr(self, f"enc_res_{res_i}"), h, emb)
                if u["attn"]:
                    h, written = remat(cfg.remat, getattr(self, f"enc_attn_{attn_i}"),
                                       h, context, take_bank(), collect_bank)
                    attn_i += 1
                    bank_written.extend(written)
                h = motion(h, f"enc_motion_{res_i}")
                res_i += 1
            else:
                h = getattr(self, f"enc_down_{down_i}")(h)
                down_i += 1
            hs.append(h)

        h = remat(cfg.remat, self.mid_res_0, h, emb)
        h, written = remat(cfg.remat, self.mid_attn, h, context, take_bank(), collect_bank)
        bank_written.extend(written)
        h = remat(cfg.remat, self.mid_res_1, h, emb)
        if pose_residuals is not None:
            h = h + residual(-1).to(h.dtype)

        for u in decoder_plan(cfg):
            skip = hs.pop()
            if pose_residuals is not None:
                skip = skip + residual(len(hs)).to(skip.dtype)
            h = remat(cfg.remat, getattr(self, u["name_res"]),
                      torch.cat([h, skip], dim=1), emb)
            if u["attn"]:
                h, written = remat(cfg.remat, getattr(self, u["name_attn"]),
                                   h, context, take_bank(), collect_bank)
                bank_written.extend(written)
            h = motion(h, u["name_mm"])
            if u["upsample"]:
                h = getattr(self, u["name_up"])(h)
        if bank_read:
            raise ValueError("unconsumed bank entries")

        h = self.conv_out(self.norm_out(h))
        return nchw_to_nhwc(h).float(), tuple(bank_written)
