"""SD1.5 / SDXL UNet with appearance-bank, pose-ControlNet and motion-module
hooks (PyTorch).

Counterpart of `magicdance_tpu.models.unet.UNet`:

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
  * `y` (B, adm_in_channels) -- SDXL's added vector, through `label_emb`
    (Linear-SiLU-Linear) into the time embedding; only a configuration with
    `adm_in_channels` > 0 takes it and has `label_emb`. The SDXL fields
    also give each level its own transformer depth (and the middle block
    its own), heads of `num_head_channels` channels, and linear transformer
    projections.
  * `bank_mask` (B,) -- a gate on the bank per batch row (fused CFG: cond
    rows 1, uncond rows 0, exactly plain self-attention).
  * `self_kv_pool` / `self_kv_min_seq` -- self-attention keys/values
    average-pooled at read/plain sites of at least `self_kv_min_seq` tokens
    (turbo, `SampleConfig.self_kv_downsample`); the write pass stays exact.
  * DeepCache (turbo): `collect_deep=True` also returns the hidden state
    entering the first decoder unit of level `deep_level`; `deep_cache_in=`
    that feature runs a shallow pass over levels 0..deep_level only
    (`shallow_plan`). A shallow pass fed the deep feature of the same (x, t)
    reproduces the full forward.

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
    {kind: "res"|"down", ch, attn, level, ds, depth}, depth the transformer
    blocks of its site."""
    units = []
    skip_ch = [cfg.model_channels]
    ch = cfg.model_channels
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        out_ch = cfg.model_channels * mult
        for _ in range(cfg.num_res_blocks):
            units.append(dict(kind="res", ch=out_ch, attn=ds in cfg.attention_resolutions,
                              level=level, ds=ds, depth=cfg.depth_at(level)))
            ch = out_ch
            skip_ch.append(ch)
        if level != len(cfg.channel_mult) - 1:
            units.append(dict(kind="down", ch=ch, attn=False, level=level, ds=ds, depth=0))
            ds *= 2
            skip_ch.append(ch)
    return units, skip_ch, ds


def decoder_plan(cfg: UNetConfig):
    """Decoder units in traversal order (deepest level first) with their
    module names: {level, ch, attn, ds, depth, upsample, name_res,
    name_attn, name_mm, name_up}. The forward loop and `num_bank_entries`
    both derive from it."""
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
                depth=cfg.depth_at(level),
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
    """Bank entries, one a transformer block, in traversal order: encoder +
    middle + decoder."""
    enc = sum(u["depth"] for u in unet_plan(cfg)[0] if u["attn"])
    dec = sum(u["depth"] for u in decoder_plan(cfg) if u["attn"])
    return enc + cfg.depth_middle + dec


def shallow_plan(cfg: UNetConfig, deep_level: int = 0):
    """DeepCache shallow pass over levels 0..deep_level: (n_enc_bank,
    n_dec_bank), the bank entries its encoder and decoder attention sites
    consume (the first n_enc_bank and the last n_dec_bank of the bank)."""
    enc_units, _, _ = unet_plan(cfg)
    n_enc = sum(u["depth"] for u in enc_units
                if u["kind"] == "res" and u["attn"] and u["level"] <= deep_level)
    n_dec = sum(u["depth"] for u in decoder_plan(cfg) if u["level"] <= deep_level and u["attn"])
    return n_enc, n_dec


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

        def st(ch, depth):
            return SpatialTransformer(ch, *cfg.heads_at(ch), depth, cfg.context_dim,
                                      cfg.use_linear_in_transformer)

        def add_motion(name, ch):
            if cfg.use_motion_modules:
                self.add_module(name, TemporalTransformer(
                    ch, cfg.motion_num_heads, cfg.motion_max_len, cfg.motion_layers,
                    cfg.motion_attn_blocks))

        self.time_embed = TimestepEmbedMLP(mc)
        if cfg.adm_in_channels > 0:
            self.label_emb = TimestepEmbedMLP(mc, cfg.adm_in_channels)
        self.conv_in = conv3x3(cfg.in_channels, mc)
        units, skip_ch, _ = unet_plan(cfg)
        ch = mc
        res_i = down_i = attn_i = 0
        for u in units:
            if u["kind"] == "res":
                self.add_module(f"enc_res_{res_i}", ResBlock(ch, u["ch"], emb_dim))
                ch = u["ch"]
                if u["attn"]:
                    self.add_module(f"enc_attn_{attn_i}", st(ch, u["depth"]))
                    attn_i += 1
                add_motion(f"enc_motion_{res_i}", ch)
                res_i += 1
            else:
                self.add_module(f"enc_down_{down_i}", Downsample(ch))
                down_i += 1
        mid_ch = mc * cfg.channel_mult[-1]
        self.mid_res_0 = ResBlock(ch, mid_ch, emb_dim)
        self.mid_attn = st(mid_ch, cfg.depth_middle)
        self.mid_res_1 = ResBlock(mid_ch, mid_ch, emb_dim)
        ch = mid_ch
        skips = list(skip_ch)
        for u in decoder_plan(cfg):
            self.add_module(u["name_res"], ResBlock(ch + skips.pop(), u["ch"], emb_dim))
            ch = u["ch"]
            if u["attn"]:
                self.add_module(u["name_attn"], st(ch, u["depth"]))
            add_motion(u["name_mm"], ch)
            if u["upsample"]:
                self.add_module(u["name_up"], Upsample(ch))
        self.norm_out = GroupNorm32(ch, act=True)
        self.conv_out = conv3x3(ch, cfg.out_channels, zero_init=True)

    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        context: Optional[torch.Tensor],
        *,
        y: Optional[torch.Tensor] = None,
        bank: Optional[Bank] = None,
        collect_bank: bool = False,
        pose_residuals: Optional[Sequence[torch.Tensor]] = None,
        num_frames: int = 1,
        bank_mask: Optional[torch.Tensor] = None,
        collect_deep: bool = False,
        deep_cache_in: Optional[torch.Tensor] = None,
        deep_level: int = 0,
        self_kv_pool: int = 1,
        self_kv_min_seq: int = 4096,
    ):
        """x: (B, h, w, C), B = clips x num_frames; timesteps: (B,); context:
        (B, 77, context_dim); y: (B, adm_in_channels), the added vector of a
        configuration that takes one; bank: entries (Bb, S_i, C_i), Bb in {1, B};
        pose_residuals: 13 NHWC tensors, [0..11] per encoder skip, [12] middle.
        Returns (eps (B, h, w, out_channels) fp32, bank_written), and the deep
        feature (NCHW, compute dtype) third when `collect_deep`."""
        cfg = self.cfg
        shallow = deep_cache_in is not None
        if bank is not None and collect_bank:
            raise ValueError("bank write and read are exclusive")
        if shallow and (collect_deep or collect_bank):
            raise ValueError("a shallow (DeepCache) pass neither collects the deep "
                             "feature nor writes the bank")
        if (shallow or collect_deep) and not 0 <= deep_level < len(cfg.channel_mult) - 1:
            raise ValueError(f"deep_level {deep_level} out of range for "
                             f"{len(cfg.channel_mult)} levels")
        if bank is not None and len(bank) != num_bank_entries(cfg):
            raise ValueError(f"bank has {len(bank)} entries, expected "
                             f"{num_bank_entries(cfg)}")
        if (y is not None) != (cfg.adm_in_channels > 0):
            raise ValueError(f"adm_in_channels {cfg.adm_in_channels} takes "
                             f"{'an' if cfg.adm_in_channels > 0 else 'no'} added vector y")
        dtype = self.compute_dtype or self.conv_in.weight.dtype
        if bank is not None and shallow:
            # the shallow levels' sites: the first entries (encoder) and the
            # last (decoder)
            n_enc0, n_dec0 = shallow_plan(cfg, deep_level)
            bank_read = list(bank[:n_enc0]) + (list(bank[-n_dec0:]) if n_dec0 else [])
        else:
            bank_read = list(bank) if bank is not None else None
        bank_written: list[torch.Tensor] = []

        def kv_pool_at(h):
            """Self-KV pool factor of the site at h's resolution: read/plain
            sites of at least self_kv_min_seq tokens; the write pass stays
            exact."""
            if (self_kv_pool > 1 and not collect_bank
                    and h.shape[2] * h.shape[3] >= self_kv_min_seq):
                return self_kv_pool
            return 1

        def take_bank(depth):
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
        if y is not None:
            emb = emb + self.label_emb(y.to(dtype))
        if context is not None:
            context = context.to(dtype)

        def attention(name, h, depth):
            h, written = remat(cfg.remat, getattr(self, name), h, context, take_bank(depth),
                               collect_bank, bank_mask, kv_pool_at(h))
            bank_written.extend(written)
            return h

        # a contiguous NHWC input makes every activation channels_last (rows
        # of channels, what the fused GroupNorm kernel takes), also when x
        # is a view such as a slice of the VAE's moments
        h = self.conv_in(nhwc_to_nchw(x.to(dtype).contiguous()))
        hs = [h]
        units, _, _ = unet_plan(cfg)
        res_i = down_i = attn_i = 0
        for u in units:
            if shallow and (u["level"] > deep_level
                            or (u["kind"] == "down" and u["level"] == deep_level)):
                break  # the deeper levels come from the cached feature
            if u["kind"] == "res":
                h = remat(cfg.remat, getattr(self, f"enc_res_{res_i}"), h, emb)
                if u["attn"]:
                    h = attention(f"enc_attn_{attn_i}", h, u["depth"])
                    attn_i += 1
                h = motion(h, f"enc_motion_{res_i}")
                res_i += 1
            else:
                h = getattr(self, f"enc_down_{down_i}")(h)
                down_i += 1
            hs.append(h)

        if not shallow:
            h = remat(cfg.remat, self.mid_res_0, h, emb)
            h = attention("mid_attn", h, cfg.depth_middle)
            h = remat(cfg.remat, self.mid_res_1, h, emb)
            if pose_residuals is not None:
                h = h + residual(-1).to(h.dtype)

        deep_feature = None
        dec_units = decoder_plan(cfg)
        if shallow:
            h = deep_cache_in.to(dtype)
            dec_units = [u for u in dec_units if u["level"] <= deep_level]
        for u in dec_units:
            if collect_deep and deep_feature is None and u["level"] == deep_level:
                deep_feature = h  # the hidden state entering level deep_level
            skip = hs.pop()
            if pose_residuals is not None:
                skip = skip + residual(len(hs)).to(skip.dtype)
            h = remat(cfg.remat, getattr(self, u["name_res"]),
                      torch.cat([h, skip], dim=1), emb)
            if u["attn"]:
                h = attention(u["name_attn"], h, u["depth"])
            h = motion(h, u["name_mm"])
            if u["upsample"]:
                h = getattr(self, u["name_up"])(h)
        if hs:
            raise ValueError("skip bookkeeping mismatch")
        if bank_read:
            raise ValueError("unconsumed bank entries")

        h = self.conv_out(self.norm_out(h))
        out = nchw_to_nhwc(h).float()
        if collect_deep:
            return out, tuple(bank_written), deep_feature
        return out, tuple(bank_written)
