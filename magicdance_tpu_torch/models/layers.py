"""Building blocks of the SD1.5 UNet family (PyTorch).

Counterpart of `magicdance_tpu.models.layers`. Submodule names follow the
Flax module names (`norm_in.norm`, `conv_in`, `emb_proj`, `block_0.attn1.to_q`,
...), so `convert.from_jax` is a tree walk with per-leaf rules.

Layout: convolution blocks take and return (B, C, H, W) tensors; the UNet
enters them through a permute of its NHWC input, so activations are
channels_last in memory and no transpose copies happen inside. Norms run in
fp32 and cast back (ref openaimodel GroupNorm32). The appearance bank is
explicit: a transformer block returns its bank entry in write mode and
receives one in read mode.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from magicdance_tpu_torch.ops.attention import (
    attention_packed,
    bank_read_attention_packed,
)


def layer_norm_f32(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm computed in fp32 whatever the compute dtype, cast back."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(x.dtype)


def group_norm_f32(gn: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm over (B, C, H, W) computed in fp32 (result stays fp32)."""
    return F.group_norm(x.float(), gn.num_groups, gn.weight.float(),
                        gn.bias.float(), gn.eps)


class GroupNorm32(nn.Module):
    """GroupNorm(32) in fp32, cast back to the input dtype, optionally
    followed by SiLU in the input dtype. When C % 32 != 0 the group count is
    gcd(C, 32), as in the JAX package."""

    def __init__(self, channels: int, eps: float = 1e-5, act: bool = False,
                 num_groups: int = 32):
        super().__init__()
        groups = num_groups if channels % num_groups == 0 else math.gcd(channels, num_groups)
        self.norm = nn.GroupNorm(groups, channels, eps=eps)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = group_norm_f32(self.norm, x).to(x.dtype)
        return F.silu(h) if self.act else h


def conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1)


def conv1x1(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1)


class TimestepEmbedMLP(nn.Module):
    """model_channels -> 4*model_channels MLP over the sinusoidal embedding."""

    def __init__(self, model_channels: int):
        super().__init__()
        d = model_channels * 4
        self.fc1 = nn.Linear(model_channels, d)
        self.fc2 = nn.Linear(d, d)

    def forward(self, t_sinusoid: torch.Tensor) -> torch.Tensor:
        h = self.fc1(t_sinusoid.to(self.fc1.weight.dtype))
        return self.fc2(F.silu(h))


class ResBlock(nn.Module):
    """Residual block with timestep-embedding injection (SD1.5:
    use_scale_shift_norm=False)."""

    def __init__(self, in_channels: int, out_channels: int, emb_dim: int):
        super().__init__()
        self.norm_in = GroupNorm32(in_channels, act=True)
        self.conv_in = conv3x3(in_channels, out_channels)
        self.emb_proj = nn.Linear(emb_dim, out_channels)
        self.norm_out = GroupNorm32(out_channels, act=True)
        self.conv_out = conv3x3(out_channels, out_channels)
        self.skip = conv1x1(in_channels, out_channels) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(self.norm_in(x))
        e = self.emb_proj(F.silu(emb))
        h = h + e[:, :, None, None].to(h.dtype)
        h = self.conv_out(self.norm_out(h))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class Downsample(nn.Module):
    """Stride-2 3x3 conv with symmetric padding 1."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3x3(channels, channels, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest 2x upsample + 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3x3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class GEGLUFeedForward(nn.Module):
    """GEGLU MLP, mult 4. The gate uses the tanh-approximated GELU, which is
    what `flax.linen.gelu` computes by default."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.proj_in = nn.Linear(dim, inner * 2)
        self.proj_out = nn.Linear(inner, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj_in(x).chunk(2, dim=-1)
        return self.proj_out(h * F.gelu(gate, approximate="tanh"))


class CrossAttention(nn.Module):
    """Multi-head attention, q from x, k/v from context (or x). In bank-read
    mode the bank entry goes through the same to_k/to_v projections and the
    attention is one joint softmax over the layer's own keys and the bank's.
    q/k/v stay packed (B, S, H*D) into the kernels."""

    def __init__(self, query_dim: int, context_dim: Optional[int], num_heads: int,
                 head_dim: int):
        super().__init__()
        inner = num_heads * head_dim
        context_dim = query_dim if context_dim is None else context_dim
        self.num_heads = num_heads
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Linear(inner, query_dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                kv_extra: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        if kv_extra is not None:
            kb, vb = self.to_k(kv_extra), self.to_v(kv_extra)
            out = bank_read_attention_packed(q, k, v, kb, vb, num_heads=self.num_heads)
        else:
            out = attention_packed(q, k, v, num_heads=self.num_heads)
        return self.to_out(out)


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn(context) -> GEGLU FF, pre-LN residuals.

    write mode (collect=True): also returns norm1(x), the bank entry, taken
    before attn1. read mode (bank_entry given): attn1's keys/values are the
    union of norm1(x) and the bank entry. plain mode: vanilla self-attention
    (the CFG uncond pass)."""

    def __init__(self, dim: int, context_dim: int, num_heads: int, head_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, None, num_heads, head_dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, context_dim, num_heads, head_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor],
                bank_entry: Optional[torch.Tensor] = None, collect: bool = False):
        h = layer_norm_f32(self.norm1, x)
        written = h if collect else None
        x = x + self.attn1(h, kv_extra=bank_entry)
        x = x + self.attn2(layer_norm_f32(self.norm2, x), context=context)
        x = x + self.ff(layer_norm_f32(self.norm3, x))
        return x, written


class SpatialTransformer(nn.Module):
    """GroupNorm -> 1x1 proj_in -> transformer blocks over (B, HW, C) ->
    1x1 proj_out -> residual."""

    def __init__(self, channels: int, num_heads: int, head_dim: int, depth: int,
                 context_dim: int):
        super().__init__()
        inner = num_heads * head_dim
        self.depth = depth
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = conv1x1(channels, inner)
        for i in range(depth):
            self.add_module(f"block_{i}", BasicTransformerBlock(inner, context_dim,
                                                                num_heads, head_dim))
        self.proj_out = conv1x1(inner, channels)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor],
                bank_entries: Optional[Sequence[torch.Tensor]] = None,
                collect: bool = False):
        b, _, hh, ww = x.shape
        z = self.proj_in(self.norm(x))
        inner = z.shape[1]
        z = z.permute(0, 2, 3, 1).reshape(b, hh * ww, inner)
        written = []
        for i in range(self.depth):
            entry = bank_entries[i] if bank_entries is not None else None
            z, w_i = getattr(self, f"block_{i}")(z, context, bank_entry=entry,
                                                 collect=collect)
            if collect:
                written.append(w_i)
        z = z.reshape(b, hh, ww, inner).permute(0, 3, 1, 2)
        return x + self.proj_out(z), tuple(written)
