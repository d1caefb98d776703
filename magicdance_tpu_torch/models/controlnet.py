"""Pose ControlNet: UNet-encoder copy + zero convolutions + hint CNN (PyTorch).

Counterpart of `magicdance_tpu.models.controlnet`: a stride-8 hint CNN embeds
the rendered skeleton map into latent resolution, the UNet encoder and middle
block run on `conv_in(x) + hint`, and 13 1x1 "zero" convolutions (zero at
initialisation in training) tap the residual stream: one per encoder skip
(12 at SD1.5 width) plus one after the middle block. The 13 residuals are
returned NHWC in fp32, in the order `UNet(pose_residuals=...)` consumes them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from magicdance_tpu_torch.config import ControlNetConfig, UNetConfig
from magicdance_tpu_torch.models.layers import (
    Downsample,
    ResBlock,
    SpatialTransformer,
    TimestepEmbedMLP,
    conv1x1,
    conv3x3,
)
from magicdance_tpu_torch.models.unet import nchw_to_nhwc, nhwc_to_nchw, unet_plan
from magicdance_tpu_torch.ops.schedules import timestep_embedding

HINT_WIDTHS = ((16, 1), (16, 1), (32, 2), (32, 1), (96, 2), (96, 1), (256, 2))


class HintEncoder(nn.Module):
    """Seven 3x3 convs with SiLU (three of stride 2) and a final 3x3 conv."""

    def __init__(self, hint_channels: int, model_channels: int):
        super().__init__()
        cin = hint_channels
        for i, (w, s) in enumerate(HINT_WIDTHS):
            self.add_module(f"conv_{i}", conv3x3(cin, w, stride=s))
            cin = w
        self.conv_out = conv3x3(cin, model_channels)

    def forward(self, hint: torch.Tensor) -> torch.Tensor:
        h = hint
        for i in range(len(HINT_WIDTHS)):
            h = F.silu(getattr(self, f"conv_{i}")(h))
        return self.conv_out(h)


def controlnet_unet_config(cfg: ControlNetConfig, in_channels: int) -> UNetConfig:
    return UNetConfig(
        in_channels=in_channels,
        model_channels=cfg.model_channels,
        channel_mult=cfg.channel_mult,
        num_res_blocks=cfg.num_res_blocks,
        attention_resolutions=cfg.attention_resolutions,
        num_heads=cfg.num_heads,
        transformer_depth=cfg.transformer_depth,
        context_dim=cfg.context_dim,
    )


class PoseControlNet(nn.Module):
    def __init__(self, cfg: ControlNetConfig, in_channels: int = 4):
        super().__init__()
        self.cfg = cfg
        self.ucfg = controlnet_unet_config(cfg, in_channels)
        mc = cfg.model_channels
        emb_dim = 4 * mc
        heads, depth, ctx_dim = cfg.num_heads, cfg.transformer_depth, cfg.context_dim
        self.time_embed = TimestepEmbedMLP(mc)
        self.hint_encoder = HintEncoder(cfg.hint_channels, mc)
        self.conv_in = conv3x3(in_channels, mc)
        self.zero_conv_0 = conv1x1(mc, mc)
        ch = mc
        res_i = down_i = attn_i = 0
        for zc, u in enumerate(unet_plan(self.ucfg)[0], start=1):
            if u["kind"] == "res":
                self.add_module(f"enc_res_{res_i}", ResBlock(ch, u["ch"], emb_dim))
                ch = u["ch"]
                res_i += 1
                if u["attn"]:
                    self.add_module(f"enc_attn_{attn_i}",
                                    SpatialTransformer(ch, heads, ch // heads, depth, ctx_dim))
                    attn_i += 1
            else:
                self.add_module(f"enc_down_{down_i}", Downsample(ch))
                down_i += 1
            self.add_module(f"zero_conv_{zc}", conv1x1(ch, ch))
        mid_ch = mc * cfg.channel_mult[-1]
        self.mid_res_0 = ResBlock(ch, mid_ch, emb_dim)
        self.mid_attn = SpatialTransformer(mid_ch, heads, mid_ch // heads, depth, ctx_dim)
        self.mid_res_1 = ResBlock(mid_ch, mid_ch, emb_dim)
        self.zero_conv_mid = conv1x1(mid_ch, mid_ch)

    def forward(self, x: torch.Tensor, hint: torch.Tensor, timesteps: torch.Tensor,
                context: Optional[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """x: (B, h, w, 4) noisy latent; hint: (B, 8h, 8w, 3) pose map in
        [0, 1]. Returns the 13 zero-conv residuals, NHWC, fp32."""
        dtype = self.conv_in.weight.dtype
        emb = self.time_embed(timestep_embedding(timesteps, self.cfg.model_channels,
                                                 dtype=dtype))
        if context is not None:
            context = context.to(dtype)
        guided = self.hint_encoder(nhwc_to_nchw(hint.to(dtype)))
        h = self.conv_in(nhwc_to_nchw(x.to(dtype))) + guided
        outs = [self.zero_conv_0(h)]
        res_i = down_i = attn_i = 0
        for zc, u in enumerate(unet_plan(self.ucfg)[0], start=1):
            if u["kind"] == "res":
                h = getattr(self, f"enc_res_{res_i}")(h, emb)
                res_i += 1
                if u["attn"]:
                    h, _ = getattr(self, f"enc_attn_{attn_i}")(h, context)
                    attn_i += 1
            else:
                h = getattr(self, f"enc_down_{down_i}")(h)
                down_i += 1
            outs.append(getattr(self, f"zero_conv_{zc}")(h))
        h = self.mid_res_0(h, emb)
        h, _ = self.mid_attn(h, context)
        h = self.mid_res_1(h, emb)
        outs.append(self.zero_conv_mid(h))
        return tuple(nchw_to_nhwc(o).float() for o in outs)
