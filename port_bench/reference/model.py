"""Plain PyTorch reference of the MagicPose networks, in float32.

A frozen copy of the published SD1.5 architecture as the MagicDance
reference runs it (cldm_v15_reference_only_pose.yaml; AnimateDiff motion
modules for the temporal variant): the UNet with the appearance-bank hooks,
the pose ControlNet, the KL VAE and the CLIP ViT-L/14 text tower. Only
`torch` operations; nothing of the measured program is imported. Parameter
names follow the program's state-dict layout, so the benchmark can hand one
set of seeded weights to both.

Every product of the denoiser takes its operands through `Numerics.operand`:
the identity for the reference (fp32, TF32 off), a rounding to fp8 e4m3 with
a per-tensor scale for the precision control (`Numerics("fp8")`), whose
gradients come back through e5m2. The VAE
and CLIP follow `Numerics.encoders` instead (TF32 on in the control). Norms and
softmax stay fp32 in every mode. Attention is the textbook softmax(QK^T)V,
computed in chunks of rows so that the logits stay under `ATTN_CHUNK_BYTES`.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

ATTN_CHUNK_BYTES = 1 << 30


class Numerics:
    """How the reference rounds: "fp32" (none, TF32 off) or "fp8" (the
    control: denoiser operands through e4m3 with per-tensor scales, VAE and
    CLIP with TF32 on). `remat` recomputes blocks and attention chunks in
    the backward pass (memory only; the arithmetic is the same)."""

    def __init__(self, mode: str = "fp32", remat: bool = False):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"unknown numerics {mode!r}")
        self.mode = mode
        self.remat = remat

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "fp32":
            return x
        return _Fp8.apply(x)

    @contextlib.contextmanager
    def encoders(self):
        """The VAE / CLIP precision: full fp32, or TF32 in the control."""
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        on = self.mode == "fp8"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    def run(self, fn, *args):
        if self.remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                                     preserve_rng_state=False)
        return fn(*args)


def fp8_round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x through an fp8 format with one scale for the tensor (its largest
    magnitude to the format's largest finite value)."""
    amax = x.abs().amax().float().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return ((x * scale).to(dtype).to(x.dtype) / scale)


class _Fp8(torch.autograd.Function):
    """The control's operand: e4m3 going forward; the gradient that comes
    back through it in e5m2, scaled the same way (the usual fp8 recipe)."""

    @staticmethod
    def forward(ctx, x):
        return fp8_round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g, torch.float8_e5m2)


FP32 = Numerics()


class Linear(nn.Linear):
    def __init__(self, num: Numerics, cin: int, cout: int, bias: bool = True):
        super().__init__(cin, cout, bias=bias, device="meta")
        self.num = num

    def forward(self, x):
        q = self.num.operand
        return F.linear(q(x), q(self.weight), self.bias)


class Conv2d(nn.Conv2d):
    def __init__(self, num: Numerics, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0):
        super().__init__(cin, cout, k, stride=stride, padding=padding, device="meta")
        self.num = num

    def forward(self, x):
        q = self.num.operand
        return self._conv_forward(q(x), q(self.weight), self.bias)


def conv3(num, cin, cout, stride=1):
    return Conv2d(num, cin, cout, 3, stride, 1)


def conv1(num, cin, cout):
    return Conv2d(num, cin, cout, 1)


class GroupNorm32(nn.Module):
    """GroupNorm(32, or gcd(C, 32)) in fp32, optionally followed by SiLU."""

    def __init__(self, channels: int, eps: float = 1e-5, act: bool = False):
        super().__init__()
        g = 32 if channels % 32 == 0 else math.gcd(channels, 32)
        self.norm = nn.GroupNorm(g, channels, eps=eps, device="meta")
        self.act = act

    def forward(self, x):
        # contiguous: PyTorch's CPU group-norm backward crashes on a
        # channels_last input that needs no gradient when the weight does
        h = self.norm(x.contiguous())
        return F.silu(h) if self.act else h


def layer_norm(dim):
    return nn.LayerNorm(dim, eps=1e-5, device="meta")


def attention(num: Numerics, q, k, v, scale: float):
    """softmax(q k^T * scale) v over (N, S, D) tensors, rows in chunks."""
    n, sq, _ = q.shape
    per_row = sq * k.shape[1] * 4 * 3
    step = max(1, ATTN_CHUNK_BYTES // per_row)
    op = num.operand

    def core(qc, kc, vc):
        p = torch.softmax(op(qc) @ op(kc).transpose(1, 2) * scale, dim=-1)
        return op(p) @ op(vc)

    outs = []
    for i in range(0, n, step):
        args = (q[i:i + step], k[i:i + step], v[i:i + step])
        if num.remat and torch.is_grad_enabled() and q.requires_grad:
            outs.append(torch.utils.checkpoint.checkpoint(core, *args, use_reentrant=False))
        else:
            outs.append(core(*args))
    return torch.cat(outs)


def timestep_embedding(t, dim: int, max_period: int = 10000):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimeEmbed(nn.Module):
    def __init__(self, num, mc):
        super().__init__()
        self.fc1 = Linear(num, mc, 4 * mc)
        self.fc2 = Linear(num, 4 * mc, 4 * mc)

    def forward(self, x):
        return self.fc2(F.silu(self.fc1(x)))


class ResBlock(nn.Module):
    def __init__(self, num, cin, cout, emb):
        super().__init__()
        self.norm_in = GroupNorm32(cin, act=True)
        self.conv_in = conv3(num, cin, cout)
        self.emb_proj = Linear(num, emb, cout)
        self.norm_out = GroupNorm32(cout, act=True)
        self.conv_out = conv3(num, cout, cout)
        self.skip = conv1(num, cin, cout) if cin != cout else None

    def forward(self, x, emb):
        h = self.conv_in(self.norm_in(x)) + self.emb_proj(F.silu(emb))[:, :, None, None]
        h = self.conv_out(self.norm_out(h))
        return (self.skip(x) if self.skip is not None else x) + h


class Attention(nn.Module):
    """Multi-head attention; with `bank` the keys/values are the union of
    the layer's own tokens and the bank's (one joint softmax)."""

    def __init__(self, num, dim, ctx_dim, heads, head_dim):
        super().__init__()
        inner = heads * head_dim
        self.num, self.heads, self.head_dim = num, heads, head_dim
        self.to_q = Linear(num, dim, inner, bias=False)
        self.to_k = Linear(num, ctx_dim, inner, bias=False)
        self.to_v = Linear(num, ctx_dim, inner, bias=False)
        self.to_out = Linear(num, inner, dim)

    def forward(self, x, context=None, bank=None):
        ctx = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        b = x.shape[0]
        if bank is not None:
            kb, vb = self.to_k(bank), self.to_v(bank)
            k = torch.cat([k, kb.expand(b, -1, -1)], dim=1)
            v = torch.cat([v, vb.expand(b, -1, -1)], dim=1)
        h, d = self.heads, self.head_dim

        def split(t):
            return t.reshape(t.shape[0], t.shape[1], h, d).transpose(1, 2).reshape(-1, t.shape[1], d)

        k, v = k.expand(b, -1, -1), v.expand(b, -1, -1)
        o = attention(self.num, split(q), split(k), split(v), d ** -0.5)
        o = o.reshape(b, h, -1, d).transpose(1, 2).reshape(b, -1, h * d)
        return self.to_out(o)


class FeedForward(nn.Module):
    def __init__(self, num, dim):
        super().__init__()
        self.proj_in = Linear(num, dim, dim * 8)
        self.proj_out = Linear(num, dim * 4, dim)

    def forward(self, x):
        h, gate = self.proj_in(x).chunk(2, dim=-1)
        return self.proj_out(h * F.gelu(gate, approximate="tanh"))


class Block(nn.Module):
    def __init__(self, num, dim, ctx_dim, heads, head_dim):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.attn1 = Attention(num, dim, dim, heads, head_dim)
        self.norm2 = layer_norm(dim)
        self.attn2 = Attention(num, dim, ctx_dim, heads, head_dim)
        self.norm3 = layer_norm(dim)
        self.ff = FeedForward(num, dim)

    def forward(self, x, context, bank=None, collect=False):
        h = self.norm1(x)
        x = x + self.attn1(h, bank=bank)
        x = x + self.attn2(self.norm2(x), context=context)
        x = x + self.ff(self.norm3(x))
        return x, (h if collect else None)


class SpatialTransformer(nn.Module):
    def __init__(self, num, ch, heads, depth, ctx_dim):
        super().__init__()
        self.depth = depth
        self.norm = GroupNorm32(ch, eps=1e-6)
        self.proj_in = conv1(num, ch, ch)
        for i in range(depth):
            self.add_module(f"block_{i}", Block(num, ch, ctx_dim, heads, ch // heads))
        self.proj_out = conv1(num, ch, ch)

    def forward(self, x, context, bank=None, collect=False):
        b, c, hh, ww = x.shape
        z = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        written = []
        for i in range(self.depth):
            z, w = getattr(self, f"block_{i}")(z, context, None if bank is None else bank[i],
                                               collect)
            written.append(w)
        z = z.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return x + self.proj_out(z), written


def frame_encoding(frames: int, ch: int, device) -> torch.Tensor:
    """The motion module's sinusoidal encoding of the frame index (F, C),
    derived in float64 and rounded to float32."""
    pos = torch.arange(frames, dtype=torch.float64, device=device)[:, None]
    div = torch.exp(torch.arange(0, ch, 2, dtype=torch.float64, device=device)
                    * (-math.log(10000.0) / ch))
    pe = torch.zeros(frames, ch, dtype=torch.float64, device=device)
    pe[:, 0::2], pe[:, 1::2] = torch.sin(pos * div), torch.cos(pos * div)
    return pe.float()


class MotionModule(nn.Module):
    """AnimateDiff temporal transformer over the frames of (B*F, C, H, W)."""

    def __init__(self, num, ch, heads, layers=1, attns=2):
        super().__init__()
        self.layers, self.attns = layers, attns
        self.norm = GroupNorm32(ch, eps=1e-6)
        self.proj_in = Linear(num, ch, ch)
        for i in range(layers):
            for j in range(attns):
                self.add_module(f"norm_attn_{i}_{j}", layer_norm(ch))
                self.add_module(f"attn_{i}_{j}", Attention(num, ch, ch, heads, ch // heads))
            self.add_module(f"norm_ff_{i}", layer_norm(ch))
            self.add_module(f"ff_{i}", FeedForward(num, ch))
        self.proj_out = Linear(num, ch, ch)

    def forward(self, x, frames):
        bf, c, hh, ww = x.shape
        b = bf // frames
        z = self.norm(x).permute(0, 2, 3, 1).reshape(b, frames, hh * ww, c).transpose(1, 2)
        z = self.proj_in(z.reshape(b * hh * ww, frames, c))
        for i in range(self.layers):
            for j in range(self.attns):
                h = getattr(self, f"norm_attn_{i}_{j}")(z) + frame_encoding(frames, c, z.device)
                z = z + getattr(self, f"attn_{i}_{j}")(h)
            z = z + getattr(self, f"ff_{i}")(getattr(self, f"norm_ff_{i}")(z))
        z = self.proj_out(z).reshape(b, hh * ww, frames, c).transpose(1, 2)
        return x + z.reshape(bf, hh, ww, c).permute(0, 3, 1, 2)


def encoder_plan(u: dict):
    """[(kind, out_ch, attn)] of the UNet encoder, and the skip channels."""
    mc = u["model_channels"]
    units, skips, ch, ds = [], [mc], mc, 1
    for level, mult in enumerate(u["channel_mult"]):
        for _ in range(u["num_res_blocks"]):
            ch = mc * mult
            units.append(("res", ch, ds in u["attention_resolutions"]))
            skips.append(ch)
        if level != len(u["channel_mult"]) - 1:
            units.append(("down", ch, False))
            ds *= 2
            skips.append(ch)
    return units, skips, ds


def decoder_plan(u: dict):
    """[(ch, attn, upsample)] of the UNet decoder, deepest level first."""
    mc, levels = u["model_channels"], len(u["channel_mult"])
    out, ds = [], 2 ** (levels - 1)
    for level in reversed(range(levels)):
        for i in range(u["num_res_blocks"] + 1):
            out.append((mc * u["channel_mult"][level], ds in u["attention_resolutions"],
                        level != 0 and i == u["num_res_blocks"]))
        if level != 0:
            ds //= 2
    return out


class UNet(nn.Module):
    """SD1.5 UNet. `collect=True` returns the bank (norm1 of every
    transformer block's input, traversal order); `bank=` reads one;
    `residuals=` adds the 13 ControlNet residuals; motion modules after
    every encoder res unit and every decoder unit when `motion`."""

    def __init__(self, num, u: dict, in_channels: int, motion: bool):
        super().__init__()
        self.u, self.motion, self.num = u, motion, num
        mc, heads, depth, ctx = (u["model_channels"], u["num_heads"], u["transformer_depth"],
                                 u["context_dim"])
        emb = 4 * mc
        self.time_embed = TimeEmbed(num, mc)
        self.conv_in = conv3(num, in_channels, mc)

        def mm(name, ch):
            if motion:
                self.add_module(name, MotionModule(num, ch, u["motion_num_heads"],
                                                   u["motion_layers"], u["motion_attn_blocks"]))

        units, skips, _ = encoder_plan(u)
        ch, r, d, a = mc, 0, 0, 0
        for kind, out, attn in units:
            if kind == "res":
                self.add_module(f"enc_res_{r}", ResBlock(num, ch, out, emb))
                ch = out
                if attn:
                    self.add_module(f"enc_attn_{a}", SpatialTransformer(num, ch, heads, depth, ctx))
                    a += 1
                mm(f"enc_motion_{r}", ch)
                r += 1
            else:
                self.add_module(f"enc_down_{d}", nn.Module())
                getattr(self, f"enc_down_{d}").conv = conv3(num, ch, ch, stride=2)
                d += 1
        self.mid_res_0 = ResBlock(num, ch, ch, emb)
        self.mid_attn = SpatialTransformer(num, ch, heads, depth, ctx)
        self.mid_res_1 = ResBlock(num, ch, ch, emb)
        skips = list(skips)
        a = up = 0
        for i, (out, attn, upsample) in enumerate(decoder_plan(u)):
            self.add_module(f"dec_res_{i}", ResBlock(num, ch + skips.pop(), out, emb))
            ch = out
            if attn:
                self.add_module(f"dec_attn_{a}", SpatialTransformer(num, ch, heads, depth, ctx))
                a += 1
            mm(f"dec_motion_{i}", ch)
            if upsample:
                self.add_module(f"dec_up_{up}", nn.Module())
                getattr(self, f"dec_up_{up}").conv = conv3(num, ch, ch)
                up += 1
        self.norm_out = GroupNorm32(ch, act=True)
        self.conv_out = conv3(num, ch, u["out_channels"])

    def forward(self, x, t, context, bank=None, collect=False, residuals=None, frames=1):
        run = self.num.run
        depth = self.u["transformer_depth"]
        bank = list(bank) if bank is not None else None
        written = []
        emb = self.time_embed(timestep_embedding(t, self.u["model_channels"]))

        def attn(name, h):
            entries = [bank.pop(0) for _ in range(depth)] if bank is not None else None
            h, w = run(lambda hh: getattr(self, name)(hh, context, entries, collect), h)
            written.extend(w)
            return h

        def motion(name, h):
            return run(getattr(self, name), h, frames) if self.motion else h

        h = self.conv_in(x.permute(0, 3, 1, 2))
        hs = [h]
        r = d = a = 0
        for kind, _, has_attn in encoder_plan(self.u)[0]:
            if kind == "res":
                h = run(getattr(self, f"enc_res_{r}"), h, emb)
                if has_attn:
                    h = attn(f"enc_attn_{a}", h)
                    a += 1
                h = motion(f"enc_motion_{r}", h)
                r += 1
            else:
                h = getattr(self, f"enc_down_{d}").conv(h)
                d += 1
            hs.append(h)
        h = run(self.mid_res_0, h, emb)
        h = attn("mid_attn", h)
        h = run(self.mid_res_1, h, emb)
        if residuals is not None:
            h = h + residuals[-1].permute(0, 3, 1, 2)
        a = up = 0
        for i, (_, has_attn, upsample) in enumerate(decoder_plan(self.u)):
            skip = hs.pop()
            if residuals is not None:
                skip = skip + residuals[len(hs)].permute(0, 3, 1, 2)
            h = run(getattr(self, f"dec_res_{i}"), torch.cat([h, skip], dim=1), emb)
            if has_attn:
                h = attn(f"dec_attn_{a}", h)
                a += 1
            h = motion(f"dec_motion_{i}", h)
            if upsample:
                h = getattr(self, f"dec_up_{up}").conv(F.interpolate(h, scale_factor=2,
                                                                     mode="nearest"))
                up += 1
        out = self.conv_out(self.norm_out(h)).permute(0, 2, 3, 1)
        return out, written


HINT_WIDTHS = ((16, 1), (16, 1), (32, 2), (32, 1), (96, 2), (96, 1), (256, 2))


class ControlNet(nn.Module):
    """Pose ControlNet: hint CNN, UNet-encoder copy, 13 zero convolutions."""

    def __init__(self, num, c: dict, in_channels: int):
        super().__init__()
        self.c, self.num = c, num
        mc, heads, depth, ctx = (c["model_channels"], c["num_heads"], c["transformer_depth"],
                                 c["context_dim"])
        emb = 4 * mc
        self.time_embed = TimeEmbed(num, mc)
        self.hint_encoder = nn.Module()
        cin = c["hint_channels"]
        for i, (w, s) in enumerate(HINT_WIDTHS):
            self.hint_encoder.add_module(f"conv_{i}", conv3(num, cin, w, s))
            cin = w
        self.hint_encoder.conv_out = conv3(num, cin, mc)
        self.conv_in = conv3(num, in_channels, mc)
        self.zero_conv_0 = conv1(num, mc, mc)
        ch, r, d, a = mc, 0, 0, 0
        for z, (kind, out, attn) in enumerate(encoder_plan(c)[0], start=1):
            if kind == "res":
                self.add_module(f"enc_res_{r}", ResBlock(num, ch, out, emb))
                ch = out
                r += 1
                if attn:
                    self.add_module(f"enc_attn_{a}", SpatialTransformer(num, ch, heads, depth, ctx))
                    a += 1
            else:
                self.add_module(f"enc_down_{d}", nn.Module())
                getattr(self, f"enc_down_{d}").conv = conv3(num, ch, ch, stride=2)
                d += 1
            self.add_module(f"zero_conv_{z}", conv1(num, ch, ch))
        self.mid_res_0 = ResBlock(num, ch, ch, emb)
        self.mid_attn = SpatialTransformer(num, ch, heads, depth, ctx)
        self.mid_res_1 = ResBlock(num, ch, ch, emb)
        self.zero_conv_mid = conv1(num, ch, ch)

    def forward(self, x, hint, t, context):
        run = self.num.run
        emb = self.time_embed(timestep_embedding(t, self.c["model_channels"]))
        g = hint.permute(0, 3, 1, 2)
        for i in range(len(HINT_WIDTHS)):
            g = F.silu(getattr(self.hint_encoder, f"conv_{i}")(g))
        h = self.conv_in(x.permute(0, 3, 1, 2)) + self.hint_encoder.conv_out(g)
        outs = [self.zero_conv_0(h)]
        r = d = a = 0
        for z, (kind, _, attn) in enumerate(encoder_plan(self.c)[0], start=1):
            if kind == "res":
                h = run(getattr(self, f"enc_res_{r}"), h, emb)
                r += 1
                if attn:
                    h = run(lambda hh, n=f"enc_attn_{a}": getattr(self, n)(hh, context)[0], h)
                    a += 1
            else:
                h = getattr(self, f"enc_down_{d}").conv(h)
                d += 1
            outs.append(getattr(self, f"zero_conv_{z}")(h))
        h = run(self.mid_res_0, h, emb)
        h = run(lambda hh: self.mid_attn(hh, context)[0], h)
        h = run(self.mid_res_1, h, emb)
        outs.append(self.zero_conv_mid(h))
        return [o.permute(0, 2, 3, 1) for o in outs]


class MagicPose(nn.Module):
    """Main UNet, appearance UNet (bank writer) and pose ControlNet."""

    def __init__(self, cfg: dict, num: Numerics = FP32):
        super().__init__()
        u = cfg["unet"]
        motion = cfg["variant"] == "appearance_pose_temporal"
        self.unet = UNet(num, u, u["in_channels"], motion)
        self.appearance_unet = UNet(num, u, u["out_channels"], False)
        self.pose_control = ControlNet(num, cfg["pose_control"], u["in_channels"])

    def bank(self, ref_latent, t, context):
        return self.appearance_unet(ref_latent, t, context, collect=True)[1]

    def cond(self, x, t, context, bank, hint, frames=1):
        res = self.pose_control(x, hint, t, context)
        return self.unet(x, t, context, bank=bank, residuals=res, frames=frames)[0]

    def uncond(self, x, t, context, frames=1):
        return self.unet(x, t, context, frames=frames)[0]


class VAEResBlock(nn.Module):
    def __init__(self, num, cin, cout):
        super().__init__()
        self.norm1 = nn.GroupNorm(32, cin, eps=1e-6, device="meta")
        self.conv1 = conv3(num, cin, cout)
        self.norm2 = nn.GroupNorm(32, cout, eps=1e-6, device="meta")
        self.conv2 = conv3(num, cout, cout)
        self.nin_shortcut = conv1(num, cin, cout) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return (self.nin_shortcut(x) if self.nin_shortcut is not None else x) + h


class VAEAttn(nn.Module):
    def __init__(self, num, ch):
        super().__init__()
        self.num = num
        self.norm = nn.GroupNorm(32, ch, eps=1e-6, device="meta")
        self.q, self.k, self.v, self.proj_out = (conv1(num, ch, ch) for _ in range(4))

    def forward(self, x):
        b, c, hh, ww = x.shape
        z = self.norm(x)

        def seq(t):
            return t.permute(0, 2, 3, 1).reshape(b, hh * ww, c)

        o = attention(self.num, seq(self.q(z)), seq(self.k(z)), seq(self.v(z)), c ** -0.5)
        return x + self.proj_out(o.reshape(b, hh, ww, c).permute(0, 3, 1, 2))


class VAE(nn.Module):
    """AutoencoderKL (SD1.5): NHWC in and out."""

    def __init__(self, v: dict, num: Numerics = FP32):
        super().__init__()
        num = FP32  # the VAE's precision is set by `Numerics.encoders`
        base, mult, nres = v["base_channels"], v["channel_mult"], v["num_res_blocks"]
        enc, dec = nn.Module(), nn.Module()
        self.encoder, self.decoder = enc, dec
        ch = base
        enc.conv_in = conv3(num, v["in_channels"], ch)
        for level, m in enumerate(mult):
            for i in range(nres):
                enc.add_module(f"down_{level}_block_{i}", VAEResBlock(num, ch, base * m))
                ch = base * m
            if level != len(mult) - 1:
                enc.add_module(f"down_{level}_downsample", nn.Module())
                getattr(enc, f"down_{level}_downsample").conv = Conv2d(num, ch, ch, 3, 2, 0)
        enc.mid_block_1, enc.mid_attn_1, enc.mid_block_2 = (
            VAEResBlock(num, ch, ch), VAEAttn(num, ch), VAEResBlock(num, ch, ch))
        enc.norm_out = nn.GroupNorm(32, ch, eps=1e-6, device="meta")
        enc.conv_out = conv3(num, ch, 2 * v["z_channels"])
        ch = base * mult[-1]
        dec.conv_in = conv3(num, v["z_channels"], ch)
        dec.mid_block_1, dec.mid_attn_1, dec.mid_block_2 = (
            VAEResBlock(num, ch, ch), VAEAttn(num, ch), VAEResBlock(num, ch, ch))
        for level in reversed(range(len(mult))):
            for i in range(nres + 1):
                dec.add_module(f"up_{level}_block_{i}", VAEResBlock(num, ch, base * mult[level]))
                ch = base * mult[level]
            if level != 0:
                dec.add_module(f"up_{level}_upsample", nn.Module())
                getattr(dec, f"up_{level}_upsample").conv = conv3(num, ch, ch)
        dec.norm_out = nn.GroupNorm(32, ch, eps=1e-6, device="meta")
        dec.conv_out = conv3(num, ch, v["out_channels"])
        self.quant_conv = conv1(num, 2 * v["z_channels"], 2 * v["embed_dim"])
        self.post_quant_conv = conv1(num, v["embed_dim"], v["z_channels"])
        self.v = v

    def encode(self, x):
        """(B, H, W, 3) -> (mean, logvar), each (B, H/8, W/8, 4)."""
        e, mult, nres = self.encoder, self.v["channel_mult"], self.v["num_res_blocks"]
        h = e.conv_in(x.permute(0, 3, 1, 2))
        for level in range(len(mult)):
            for i in range(nres):
                h = getattr(e, f"down_{level}_block_{i}")(h)
            if level != len(mult) - 1:
                h = getattr(e, f"down_{level}_downsample").conv(F.pad(h, (0, 1, 0, 1)))
        h = e.mid_block_2(e.mid_attn_1(e.mid_block_1(h)))
        h = self.quant_conv(e.conv_out(F.silu(e.norm_out(h)))).permute(0, 2, 3, 1)
        mean, logvar = h.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z):
        """(B, h, w, 4) decoder input -> (B, 8h, 8w, 3)."""
        d, mult, nres = self.decoder, self.v["channel_mult"], self.v["num_res_blocks"]
        h = d.conv_in(self.post_quant_conv(z.permute(0, 3, 1, 2)))
        h = d.mid_block_2(d.mid_attn_1(d.mid_block_1(h)))
        for level in reversed(range(len(mult))):
            for i in range(nres + 1):
                h = getattr(d, f"up_{level}_block_{i}")(h)
            if level != 0:
                h = getattr(d, f"up_{level}_upsample").conv(
                    F.interpolate(h, scale_factor=2, mode="nearest"))
        return d.conv_out(F.silu(d.norm_out(h))).permute(0, 2, 3, 1)


class CLIPText(nn.Module):
    """CLIP ViT-L/14 text tower: last hidden state (B, S, 768)."""

    def __init__(self, c: dict):
        super().__init__()
        num, w = FP32, c["hidden_size"]
        self.heads, self.layers = c["num_heads"], c["num_layers"]
        self.token_embedding = nn.Embedding(c["vocab_size"], w, device="meta")
        self.position_embedding = nn.Parameter(torch.empty(c["max_length"], w, device="meta"))
        for i in range(self.layers):
            layer = nn.Module()
            layer.layer_norm1, layer.layer_norm2 = layer_norm(w), layer_norm(w)
            layer.self_attn = nn.Module()
            for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
                setattr(layer.self_attn, n, Linear(num, w, w))
            layer.fc1, layer.fc2 = Linear(num, w, 4 * w), Linear(num, 4 * w, w)
            self.add_module(f"layer_{i}", layer)
        self.final_layer_norm = layer_norm(w)

    def forward(self, ids):
        b, s = ids.shape
        x = self.token_embedding(ids.long()) + self.position_embedding[None, :s]
        mask = torch.triu(torch.full((s, s), float("-inf"), device=x.device), diagonal=1)
        hd = x.shape[-1] // self.heads
        for i in range(self.layers):
            layer = getattr(self, f"layer_{i}")
            a = layer.self_attn
            h = layer.layer_norm1(x)

            def split(t):
                return t.reshape(b, s, self.heads, hd).transpose(1, 2)

            q, k, v = split(a.q_proj(h)), split(a.k_proj(h)), split(a.v_proj(h))
            p = torch.softmax(q @ k.transpose(-1, -2) * hd ** -0.5 + mask, dim=-1)
            x = x + a.out_proj((p @ v).transpose(1, 2).reshape(b, s, -1))
            h = layer.fc1(layer.layer_norm2(x))
            x = x + layer.fc2(h * torch.sigmoid(1.702 * h))
        return self.final_layer_norm(x)
