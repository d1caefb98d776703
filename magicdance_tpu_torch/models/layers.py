"""Building blocks of the SD1.5 UNet family (PyTorch).

Counterpart of `magicdance_tpu.models.layers`. Submodule names follow the
Flax module names (`norm_in.norm`, `conv_in`, `emb_proj`, `block_0.attn1.to_q`,
...), so `convert.from_jax` is a tree walk with per-leaf rules.

Layout: convolution blocks take and return (B, C, H, W) tensors; the UNet
enters them through a permute of its NHWC input, so activations are
channels_last in memory and no transpose copies happen inside. Norms run in
fp32 and cast back (ref openaimodel GroupNorm32). The appearance bank is
explicit: a transformer block returns its bank entry in write mode and
receives one in read mode. The temporal motion module (`TemporalTransformer`)
attends over the frame axis of (B*F, C, H, W) activations.

Precision: every product runs in the dtype of the activations it is given.
`Linear` and `Conv2d` cast their weights to that dtype at use, as a Flax
module with `dtype=bf16` casts its fp32 params: a bf16 denoiser may hold fp32
trainable master weights, whose gradients then come back in fp32 through the
cast, beside frozen weights stored in bf16. When the weights already have the
activations' dtype the cast is free. A frozen weight held in int8
(`models.quant`, `frozen_dtype="int8"`) is dequantized at use instead, to bf16
and then to the activations' dtype, as JAX dequantizes its frozen tree.

`zero_init=True` marks the layers the JAX package creates with zero kernels
(`conv_out` of a ResBlock and of the UNet, `proj_out` of the transformers,
the ControlNet's zero convs and hint output); `models.init` reads the mark.

`remat` runs a block under `torch.utils.checkpoint` (non-reentrant) when
grad mode is on: its activations are recomputed in the backward pass, as the
JAX package's `nn.remat` does for every ResBlock and SpatialTransformer.
"""

from __future__ import annotations

import math
import os
from collections import Counter
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn


class Linear(nn.Linear):
    """nn.Linear computing in its input's dtype (weights cast, or an int8
    weight dequantized, at use)."""

    def __init__(self, *args, zero_init: bool = False, **kw):
        super().__init__(*args, **kw)
        self.zero_init = zero_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, param_at(self, "weight", x.dtype), bias)


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in its input's dtype (weights cast, or an int8
    weight dequantized, at use)."""

    def __init__(self, *args, zero_init: bool = False, **kw):
        super().__init__(*args, **kw)
        self.zero_init = zero_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, param_at(self, "weight", x.dtype), bias)


def remat(enabled: bool, fn, *args):
    """fn(*args), recomputed in the backward pass when `enabled` and grad
    mode is on. The RNG state is not stashed: the blocks draw no random
    numbers in any path the JAX package can run (its dropout is the identity
    when serving and cannot train, see `train.trainer`). The recompute runs
    under the forward's `attention_impl`: on a GPU the backward, and so the
    recompute, runs on autograd's device thread, which does not see the
    caller's context."""
    if enabled and torch.is_grad_enabled():
        impl = current_impl()

        def run(*a):
            with attention_impl(impl), span("md.remat", _block_name, fn):
                return fn(*a)

        return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False,
                                                 preserve_rng_state=False)
    return fn(*args)

from magicdance_tpu_torch.ops.attention import (
    attention_impl,
    attention_packed,
    bank_read_attention_packed,
    current_impl,
)
from magicdance_tpu_torch.ops.kernels.groupnorm import groupnorm_act
from magicdance_tpu_torch.models.quant import param_at
from magicdance_tpu_torch.utils.profiling import dims, span


def _block_name(fn) -> str:
    return f" block={type(fn).__name__}"

# devices on which `GroupNorm32` may take the fused GroupNorm kernel K8
FUSED_GN_DEVICES = ("cuda",)
# the smallest grid (H*W) that takes K8. Timed on an H100 at every grid the
# SD1.5 UNets give at 512x512 (64-4096 positions, B = 1 and 16, C up to
# 2560): K8 ran 2.7-10.3x faster than the plain path everywhere, and at the
# 8x8 grids 1.5-1.9x faster with the 3x3 convolution that follows the norm
# (PERF.md, kernel table row 13). JAX's TPU threshold is 256; smaller grids
# were not timed and stay plain.
FUSED_GN_MIN_HW = 64
# `GroupNorm32` calls by the path they took, "k8" or "plain" (host-side; one
# increment a call; reset with GN_SITES.clear())
GN_SITES: Counter = Counter()


def layer_norm_f32(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm computed in fp32 whatever the compute dtype, cast back."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(x.dtype)


def group_norm_f32(gn: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm over (B, C, H, W) computed in fp32 (result stays fp32).

    When the affine parameters need a gradient and the input does not (a
    trainable norm behind frozen layers: the first motion module of stage 3)
    the affine is applied after an affine-free group norm: PyTorch's CPU
    group-norm backward crashes on a channels_last input in that case
    (torch 2.13)."""
    w, b = gn.weight.float(), gn.bias.float()
    needs_affine_grad = w.requires_grad or b.requires_grad
    if torch.is_grad_enabled() and needs_affine_grad and not x.requires_grad:
        y = F.group_norm(x.float(), gn.num_groups, None, None, gn.eps)
        return y * w[:, None, None] + b[:, None, None]
    return F.group_norm(x.float(), gn.num_groups, w, b, gn.eps)


class GroupNorm32(nn.Module):
    """GroupNorm(32) in fp32, cast back to the input dtype, optionally
    followed by SiLU in the input dtype. When C % 32 != 0 the group count is
    gcd(C, 32), as in the JAX package.

    On the card the norm and its SiLU (or none) run as kernel K8
    (`ops.kernels.groupnorm`, the epilogue on the fp32 affine output) where
    `fused_site` holds: grad mode off (an inference pass: training steps
    keep the plain path, every frozen block included), H*W >=
    FUSED_GN_MIN_HW, the groups dividing C. K8 takes the channels_last
    activations as rows of channels and returns channels_last; any other
    layout raises rather than being copied. ``MAGICDANCE_FUSED_GN=0`` keeps
    every call on the plain path (parity runs against the JAX package,
    whose switch it is)."""

    def __init__(self, channels: int, eps: float = 1e-5, act: bool = False,
                 num_groups: int = 32):
        super().__init__()
        groups = num_groups if channels % num_groups == 0 else math.gcd(channels, num_groups)
        self.norm = nn.GroupNorm(groups, channels, eps=eps)
        self.act = act

    def fused_site(self, x: torch.Tensor) -> bool:
        return (x.dim() == 4
                and os.environ.get("MAGICDANCE_FUSED_GN") != "0"
                and x.device.type in FUSED_GN_DEVICES
                and not torch.is_grad_enabled()
                and x.shape[2] * x.shape[3] >= FUSED_GN_MIN_HW
                and x.shape[1] % self.norm.num_groups == 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused_site(x):
            GN_SITES["k8"] += 1
            b, c, hh, ww = x.shape
            # (B, HW, C) rows of channels: a view of channels_last activations
            # (any other layout fails the kernel's unit channel stride)
            rows = x.permute(0, 2, 3, 1).view(b, hh * ww, c)
            y = groupnorm_act(rows, self.norm.weight, self.norm.bias, self.norm.num_groups,
                              self.norm.eps, "silu" if self.act else None)
            return y.view(b, hh, ww, c).permute(0, 3, 1, 2)
        GN_SITES["plain"] += 1
        h = group_norm_f32(self.norm, x).to(x.dtype)
        return F.silu(h) if self.act else h


def conv3x3(cin: int, cout: int, stride: int = 1, zero_init: bool = False) -> Conv2d:
    return Conv2d(cin, cout, 3, stride=stride, padding=1, zero_init=zero_init)


def conv1x1(cin: int, cout: int, zero_init: bool = False) -> Conv2d:
    return Conv2d(cin, cout, 1, zero_init=zero_init)


class TimestepEmbedMLP(nn.Module):
    """model_channels -> 4*model_channels MLP over the sinusoidal embedding;
    with `in_features`, the same MLP over another input (SDXL's `label_emb`
    over the added vector)."""

    def __init__(self, model_channels: int, in_features: Optional[int] = None):
        super().__init__()
        d = model_channels * 4
        self.fc1 = Linear(in_features or model_channels, d)
        self.fc2 = Linear(d, d)

    def forward(self, t_sinusoid: torch.Tensor) -> torch.Tensor:
        """t_sinusoid in the compute dtype."""
        return self.fc2(F.silu(self.fc1(t_sinusoid)))


class ResBlock(nn.Module):
    """Residual block with timestep-embedding injection (SD1.5:
    use_scale_shift_norm=False)."""

    def __init__(self, in_channels: int, out_channels: int, emb_dim: int):
        super().__init__()
        self.norm_in = GroupNorm32(in_channels, act=True)
        self.conv_in = conv3x3(in_channels, out_channels)
        self.emb_proj = Linear(emb_dim, out_channels)
        self.norm_out = GroupNorm32(out_channels, act=True)
        self.conv_out = conv3x3(out_channels, out_channels, zero_init=True)
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
    what `flax.linen.gelu` computes by default. `proj_in`'s output is
    [value | gate]; the tensor-parallel plan reorders its rows so that each
    rank's local output is its own [value | gate] pair."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.proj_in = Linear(dim, inner * 2)
        self.proj_out = Linear(inner, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj_in(x).chunk(2, dim=-1)
        return self.proj_out(h * F.gelu(gate, approximate="tanh"))


class CrossAttention(nn.Module):
    """Multi-head attention, q from x, k/v from context (or x). In bank-read
    mode the bank entry goes through the same to_k/to_v projections and the
    attention is one joint softmax over the layer's own keys and the bank's.
    q/k/v stay packed (B, S, H*D) into the kernels; the head count is read
    from their width, so under the tensor-parallel plan
    (`parallel.mesh.tensor_parallel_plan`) each rank attends over its own
    heads."""

    def __init__(self, query_dim: int, context_dim: Optional[int], num_heads: int,
                 head_dim: int):
        super().__init__()
        inner = num_heads * head_dim
        context_dim = query_dim if context_dim is None else context_dim
        self.head_dim = head_dim
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out = Linear(inner, query_dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                kv_extra: Optional[torch.Tensor] = None,
                bank_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        with span("md.attn", self.span_detail, x, context, kv_extra):
            ctx = x if context is None else context
            q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
            heads = q.shape[-1] // self.head_dim
            if kv_extra is not None:
                kb, vb = self.to_k(kv_extra), self.to_v(kv_extra)
                out = bank_read_attention_packed(q, k, v, kb, vb, num_heads=heads,
                                                 bank_mask=bank_mask)
            else:
                out = attention_packed(q, k, v, num_heads=heads)
            return self.to_out(out)

    def span_detail(self, x: torch.Tensor, context: Optional[torch.Tensor],
                    kv_extra: Optional[torch.Tensor]) -> str:
        """The call's shapes, as its `md.attn` span carries them: the queries'
        source (B x S x C), the keys' and values' (the context, or x),
        whether it is a cross-attention (the context given), the bank's (B x
        S x C, "0x0x0" without one), the inner width and the heads."""
        inner = self.to_q.out_features
        return (f" q={dims(x)} kv={dims(x if context is None else context)}"
                f" cross={int(context is not None)}"
                f" bank={'0x0x0' if kv_extra is None else dims(kv_extra)}"
                f" inner={inner} heads={inner // self.head_dim}")


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn(context) -> GEGLU FF, pre-LN residuals.

    write mode (collect=True): also returns norm1(x), the bank entry, taken
    before attn1. read mode (bank_entry given): attn1's keys/values are the
    union of norm1(x) and the bank entry, the bank gated per batch row by
    `bank_mask` when given (fused CFG). plain mode: vanilla self-attention
    (the CFG uncond pass).

    kv_pool > 1 (turbo, SampleConfig.self_kv_downsample): attn1's own
    keys/values come from norm1(x) average-pooled kv_pool x kv_pool in fp32
    over the site's (h, w) grid `hw` (tokens row-major over (h, w)); queries
    and outputs stay at full resolution. A grid not divisible by kv_pool
    stays exact."""

    def __init__(self, dim: int, context_dim: int, num_heads: int, head_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, None, num_heads, head_dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, context_dim, num_heads, head_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor],
                bank_entry: Optional[torch.Tensor] = None, collect: bool = False,
                bank_mask: Optional[torch.Tensor] = None, kv_pool: int = 1,
                hw: Optional[Tuple[int, int]] = None):
        h = layer_norm_f32(self.norm1, x)
        written = h if collect else None
        kv_self = None  # None: keys/values from h itself (exact)
        if kv_pool > 1 and hw is not None:
            if bank_mask is not None:
                raise ValueError("self-KV pooling with a gated bank_mask is not supported "
                                 "(as in the JAX package)")
            hh, ww = hw
            if hh % kv_pool == 0 and ww % kv_pool == 0:
                b, _, c = h.shape
                p = kv_pool
                kv_self = (h.reshape(b, hh // p, p, ww // p, p, c).float().mean(dim=(2, 4))
                           .reshape(b, (hh // p) * (ww // p), c).to(h.dtype))
        x = x + self.attn1(h, context=kv_self, kv_extra=bank_entry, bank_mask=bank_mask)
        x = x + self.attn2(layer_norm_f32(self.norm2, x), context=context)
        x = x + self.ff(layer_norm_f32(self.norm3, x))
        return x, written


class SpatialTransformer(nn.Module):
    """GroupNorm -> proj_in -> transformer blocks over (B, HW, C) ->
    proj_out -> residual. The projections are 1x1 convolutions (SD1.5) or,
    with `use_linear` (SDXL), linear layers on the tokens: the channels_last
    activations seen as (B, HW, C) rows, so neither way copies."""

    def __init__(self, channels: int, num_heads: int, head_dim: int, depth: int,
                 context_dim: int, use_linear: bool = False):
        super().__init__()
        inner = num_heads * head_dim
        self.depth = depth
        self.use_linear = use_linear
        self.norm = GroupNorm32(channels, eps=1e-6)
        if use_linear:
            self.proj_in = Linear(channels, inner)
        else:
            self.proj_in = conv1x1(channels, inner)
        for i in range(depth):
            self.add_module(f"block_{i}", BasicTransformerBlock(inner, context_dim,
                                                                num_heads, head_dim))
        if use_linear:
            self.proj_out = Linear(inner, channels, zero_init=True)
        else:
            self.proj_out = conv1x1(inner, channels, zero_init=True)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor],
                bank_entries: Optional[Sequence[torch.Tensor]] = None,
                collect: bool = False, bank_mask: Optional[torch.Tensor] = None,
                kv_pool: int = 1):
        b, c, hh, ww = x.shape
        if self.use_linear:
            z = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c))
            inner = z.shape[-1]
        else:
            z = self.proj_in(self.norm(x))
            inner = z.shape[1]
            z = z.permute(0, 2, 3, 1).reshape(b, hh * ww, inner)
        written = []
        for i in range(self.depth):
            entry = bank_entries[i] if bank_entries is not None else None
            z, w_i = getattr(self, f"block_{i}")(z, context, bank_entry=entry,
                                                 collect=collect, bank_mask=bank_mask,
                                                 kv_pool=kv_pool, hw=(hh, ww))
            if collect:
                written.append(w_i)
        if self.use_linear:
            z = self.proj_out(z)
            return x + z.reshape(b, hh, ww, c).permute(0, 3, 1, 2), tuple(written)
        z = z.reshape(b, hh, ww, inner).permute(0, 3, 1, 2)
        return x + self.proj_out(z), tuple(written)


class SinusoidalPositionalEncoding(nn.Module):
    """Fixed sinusoidal encoding over the frame axis (ref motion_module.py:
    227-245, max_len 24), added to (N, F, C) inputs. The table is built in
    fp32 numpy over the channel count C, as the JAX package builds it, and
    cast to the input's dtype at use; it is a buffer, not a parameter."""

    def __init__(self, channels: int, max_len: int = 24):
        super().__init__()
        position = np.arange(max_len)[:, None]
        div = np.exp(np.arange(0, channels, 2) * (-np.log(10000.0) / channels))
        pe = np.zeros((max_len, channels), dtype=np.float32)
        pe[:, 0::2] = np.sin(position * div)
        pe[:, 1::2] = np.cos(position * div)
        self.register_buffer("pe", torch.from_numpy(pe), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.pe[: x.shape[1]].to(x.dtype)[None]


class TemporalTransformer(nn.Module):
    """AnimateDiff temporal motion module (ref motion_module.py:50-331):
    GroupNorm (eps 1e-6) -> proj_in -> `num_layers` x (`attns_per_block` x
    {LayerNorm, frame PE, self-attention over the frames}, LayerNorm, GEGLU
    FF) -> zero-initialised proj_out -> residual.

    Takes (B*F, C, H, W) activations (frames folded into the batch, clip
    major) and attends over the F frames of every spatial position: the rows
    are reordered once to (B*H*W, F, C), frames inner, so each attention is
    a grouped site of B*H*W sequences of F rows, and restored after proj_out.
    Submodule names are the Flax ones (`norm_attn_i_j`, `pe_i_j`, `attn_i_j`,
    `norm_ff_i`, `ff_i`)."""

    def __init__(self, channels: int, num_heads: int, max_len: int = 24,
                 num_layers: int = 1, attns_per_block: int = 2):
        super().__init__()
        self.num_layers, self.attns_per_block = num_layers, attns_per_block
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = Linear(channels, channels)
        for i in range(num_layers):
            for j in range(attns_per_block):
                self.add_module(f"norm_attn_{i}_{j}", nn.LayerNorm(channels, eps=1e-5))
                self.add_module(f"pe_{i}_{j}",
                                SinusoidalPositionalEncoding(channels, max_len))
                self.add_module(f"attn_{i}_{j}", CrossAttention(
                    channels, None, num_heads, channels // num_heads))
            self.add_module(f"norm_ff_{i}", nn.LayerNorm(channels, eps=1e-5))
            self.add_module(f"ff_{i}", GEGLUFeedForward(channels))
        self.proj_out = Linear(channels, channels, zero_init=True)

    def forward(self, x: torch.Tensor, num_frames: int) -> torch.Tensor:
        bf, c, hh, ww = x.shape
        b = bf // num_frames
        z = self.norm(x).permute(0, 2, 3, 1)  # (B*F, H, W, C)
        z = z.reshape(b, num_frames, hh * ww, c).transpose(1, 2)
        z = self.proj_in(z.reshape(b * hh * ww, num_frames, c))
        for i in range(self.num_layers):
            for j in range(self.attns_per_block):
                h = layer_norm_f32(getattr(self, f"norm_attn_{i}_{j}"), z)
                h = getattr(self, f"pe_{i}_{j}")(h)
                z = z + getattr(self, f"attn_{i}_{j}")(h)
            h = layer_norm_f32(getattr(self, f"norm_ff_{i}"), z)
            z = z + getattr(self, f"ff_{i}")(h)
        z = self.proj_out(z).reshape(b, hh * ww, num_frames, c).transpose(1, 2)
        return x + z.reshape(bf, hh, ww, c).permute(0, 3, 1, 2)
