"""AutoencoderKL -- the SD1.5 VAE (PyTorch).

Counterpart of `magicdance_tpu.models.vae`: ch 128, mult (1,2,4,4), 2 res
blocks, single-head attention in the middle blocks, z 4 channels double_z,
scale factor 0.18215 applied by `encode_to_latent`. Faithfulness notes:
GroupNorm(32) eps 1e-6 computed in fp32 with the SiLU before the cast back;
the encoder's downsample is an asymmetric (0,1)x(0,1) pad followed by a
VALID stride-2 conv; upsampling is nearest 2x. Public layout is NHWC.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from magicdance_tpu_torch.config import VAEConfig
from magicdance_tpu_torch.models.layers import conv1x1, conv3x3, group_norm_f32
from magicdance_tpu_torch.models.unet import nchw_to_nhwc, nhwc_to_nchw
from magicdance_tpu_torch.ops.attention import dot_product_attention


def _norm_silu(gn: nn.GroupNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.silu(group_norm_f32(gn, x)).to(dtype)


class VAEResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(32, in_channels, eps=1e-6)
        self.conv1 = conv3x3(in_channels, out_channels)
        self.norm2 = nn.GroupNorm(32, out_channels, eps=1e-6)
        self.conv2 = conv3x3(out_channels, out_channels)
        self.nin_shortcut = (conv1x1(in_channels, out_channels)
                             if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.conv1.weight.dtype
        h = self.conv1(_norm_silu(self.norm1, x, dtype))
        h = self.conv2(_norm_silu(self.norm2, h, dtype))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class VAEAttnBlock(nn.Module):
    """Single-head spatial self-attention via 1x1 convs. Its head is as wide
    as the block: 512 at SD1.5 width, beyond the kernels' D <= 256, so the
    dispatcher takes the plain math there (narrower VAEs may reach kernel A)."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = nn.GroupNorm(32, channels, eps=1e-6)
        self.q = conv1x1(channels, channels)
        self.k = conv1x1(channels, channels)
        self.v = conv1x1(channels, channels)
        self.proj_out = conv1x1(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        z = group_norm_f32(self.norm, x).to(self.q.weight.dtype)

        def seq(t):  # (B, HW, 1, C) with unit stride over C, as the kernels take
            return nchw_to_nhwc(t).contiguous().reshape(b, hh * ww, 1, c)

        out = dot_product_attention(seq(self.q(z)), seq(self.k(z)), seq(self.v(z)))
        out = nhwc_to_nchw(out.reshape(b, hh, ww, c))
        return x + self.proj_out(out)


class VAEDownsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class VAEUpsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3x3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.base_channels
        self.conv_in = conv3x3(cfg.in_channels, ch)
        for level, mult in enumerate(cfg.channel_mult):
            out = cfg.base_channels * mult
            for i in range(cfg.num_res_blocks):
                self.add_module(f"down_{level}_block_{i}", VAEResBlock(ch, out))
                ch = out
            if level != len(cfg.channel_mult) - 1:
                self.add_module(f"down_{level}_downsample", VAEDownsample(ch))
        self.mid_block_1 = VAEResBlock(ch, ch)
        self.mid_attn_1 = VAEAttnBlock(ch)
        self.mid_block_2 = VAEResBlock(ch, ch)
        self.norm_out = nn.GroupNorm(32, ch, eps=1e-6)
        self.conv_out = conv3x3(ch, 2 * cfg.z_channels if cfg.double_z else cfg.z_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dtype = self.conv_in.weight.dtype
        h = self.conv_in(x.to(dtype))
        for level in range(len(cfg.channel_mult)):
            for i in range(cfg.num_res_blocks):
                h = getattr(self, f"down_{level}_block_{i}")(h)
            if level != len(cfg.channel_mult) - 1:
                h = getattr(self, f"down_{level}_downsample")(h)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        return self.conv_out(_norm_silu(self.norm_out, h, dtype))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.base_channels * cfg.channel_mult[-1]
        self.conv_in = conv3x3(cfg.z_channels, ch)
        self.mid_block_1 = VAEResBlock(ch, ch)
        self.mid_attn_1 = VAEAttnBlock(ch)
        self.mid_block_2 = VAEResBlock(ch, ch)
        for level in reversed(range(len(cfg.channel_mult))):
            out = cfg.base_channels * cfg.channel_mult[level]
            for i in range(cfg.num_res_blocks + 1):
                self.add_module(f"up_{level}_block_{i}", VAEResBlock(ch, out))
                ch = out
            if level != 0:
                self.add_module(f"up_{level}_upsample", VAEUpsample(ch))
        self.norm_out = nn.GroupNorm(32, ch, eps=1e-6)
        self.conv_out = conv3x3(ch, cfg.out_channels)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dtype = self.conv_in.weight.dtype
        h = self.conv_in(z.to(dtype))
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        for level in reversed(range(len(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                h = getattr(self, f"up_{level}_block_{i}")(h)
            if level != 0:
                h = getattr(self, f"up_{level}_upsample")(h)
        return self.conv_out(_norm_silu(self.norm_out, h, dtype))


class GaussianPosterior(NamedTuple):
    """Diagonal Gaussian over latents, NHWC fp32."""

    mean: torch.Tensor
    logvar: torch.Tensor

    def mode(self) -> torch.Tensor:
        return self.mean


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        zc = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.quant_conv = conv1x1(zc, 2 * cfg.embed_dim)
        self.post_quant_conv = conv1x1(cfg.embed_dim, cfg.z_channels)

    def encode(self, x: torch.Tensor) -> GaussianPosterior:
        """x: (B, H, W, 3) in [-1, 1] -> posterior over (B, H/8, W/8, 4)."""
        moments = nchw_to_nhwc(self.quant_conv(self.encoder(nhwc_to_nchw(x))))
        mean, logvar = moments.chunk(2, dim=-1)
        logvar = logvar.clamp(-30.0, 20.0)
        return GaussianPosterior(mean.float(), logvar.float())

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z: (B, h, w, 4) decoder input -> (B, 8h, 8w, 3) image."""
        z = nhwc_to_nchw(z.to(self.post_quant_conv.weight.dtype))
        return nchw_to_nhwc(self.decoder(self.post_quant_conv(z)))


def encode_to_latent(posterior_mean_or_sample: torch.Tensor, scale_factor: float) -> torch.Tensor:
    """z -> scaled model latent (ref ddpm.py:655)."""
    return posterior_mean_or_sample * scale_factor


def latent_to_decoder_input(latent: torch.Tensor, scale_factor: float) -> torch.Tensor:
    return latent / scale_factor
