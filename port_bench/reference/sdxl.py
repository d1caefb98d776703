"""The SDXL MagicPose reference family (`"reference": "sdxl"`): plain PyTorch
in fp32, built from `model.py`'s Numerics-aware pieces, so the fp8 control
of `control.py` applies to it unchanged.

SDXL base 1.0 (Stability-AI/generative-models configs/inference/
sd_xl_base.yaml) in the MagicPose structure: the UNet (channels 320 x
[1, 2, 4], attention at downsample 2 and 4 only, per-level transformer
depth [1, 2, 10] and 10 in the middle, 64-wide heads, linear transformer
projections, context 2048, `label_emb` over the 2816-wide added vector), an
appearance copy of it writing the bank (one entry a transformer block: 70),
a pose ControlNet of its encoder (the shape of the diffusers config of
thibaud/controlnet-openpose-sdxl-1.0: SD1.5's hint CNN, its own
`label_emb`, 9 skip residuals and the middle one), SD1.5's KL VAE and the
two text towers: CLIP ViT-L/14 (hidden state 11 of 12, quick-GELU, no final
norm, ids padded with EOS) and OpenCLIP ViT-bigG/14 (32 layers, 1280 wide,
exact GELU; the penultimate output into the context, `ln_final` of the last
layer at the EOT token times `text_projection` for the pooled embedding;
ids padded with 0 after EOT), side by side in a 2048-wide context. The
added vector is the pooled embedding, then 256-wide sinusoids of
original_size (H, W), crop_coords_top_left (0, 0) and target_size (H, W).
`sample` is `sample.py`'s DDIM loop (the image recipe) with the vector
given to every pass.

Departures from the published model, each the SD1.5 reference's too or a
setting of the benchmark:
- the GEGLU gate is the tanh-approximated GELU (`model.FeedForward`, as the
  port computes it); SDXL's is the exact GELU;
- the towers' last layers run only where an output reads them: the CLIP-L
  tower stops after 11 layers (its 12th layer's output is unused);
- DDIM-50 with the legacy DDPM discretization (MagicPose's sampler) in
  place of generative-models' EDM Euler; SD1.5's linear eps schedule;
- the uncond pass takes the empty prompt's context and vector, not
  diffusers' zeroed negative embeddings, and has no control branch
  ("controlnet_important");
- parameter names are the program's state-dict keys, and the text towers
  are one network, "clip", with `tower_l` and `tower_g`.

No training traffic uses this family yet: `ReferenceTrainer` refuses.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference.model import (
    FP32,
    HINT_WIDTHS,
    VAE,
    Block,
    GroupNorm32,
    Linear,
    Numerics,
    ResBlock,
    TimeEmbed,
    conv1,
    conv3,
    layer_norm,
    timestep_embedding,
)
from port_bench.reference.sample import ddim_table, decode, empty_ids

__all__ = ["MagicPoseXL", "TextTowers", "ReferenceTrainer", "added_vector", "decode",
           "networks", "sample"]


def depth_at(u: dict, level: int) -> int:
    d = u["transformer_depth"]
    return d if isinstance(d, int) else d[level]


def depth_middle(u: dict) -> int:
    """The middle block's depth: the deepest level's."""
    return depth_at(u, len(u["channel_mult"]) - 1)


def heads_at(u: dict, ch: int) -> tuple:
    """(heads, head width) at `ch` channels: heads of `num_head_channels`."""
    return ch // u["num_head_channels"], u["num_head_channels"]


def encoder_plan(u: dict):
    """[(kind, out_ch, attn, level)] of the encoder, and the skip channels."""
    mc = u["model_channels"]
    units, skips, ch, ds = [], [mc], mc, 1
    for level, mult in enumerate(u["channel_mult"]):
        for _ in range(u["num_res_blocks"]):
            ch = mc * mult
            units.append(("res", ch, ds in u["attention_resolutions"], level))
            skips.append(ch)
        if level != len(u["channel_mult"]) - 1:
            units.append(("down", ch, False, level))
            ds *= 2
            skips.append(ch)
    return units, skips


def decoder_plan(u: dict):
    """[(ch, attn, upsample, level)] of the decoder, deepest level first."""
    mc, levels = u["model_channels"], len(u["channel_mult"])
    out, ds = [], 2 ** (levels - 1)
    for level in reversed(range(levels)):
        for i in range(u["num_res_blocks"] + 1):
            out.append((mc * u["channel_mult"][level], ds in u["attention_resolutions"],
                        level != 0 and i == u["num_res_blocks"], level))
        if level != 0:
            ds //= 2
    return out


class LabelEmbed(nn.Module):
    """`label_emb`: Linear(adm, 4 mc), SiLU, Linear(4 mc, 4 mc)."""

    def __init__(self, num, adm: int, mc: int):
        super().__init__()
        self.fc1 = Linear(num, adm, 4 * mc)
        self.fc2 = Linear(num, 4 * mc, 4 * mc)

    def forward(self, y):
        return self.fc2(F.silu(self.fc1(y)))


class SpatialTransformer(nn.Module):
    """GroupNorm, linear proj_in on the tokens, `depth` blocks, linear
    proj_out, residual."""

    def __init__(self, num, ch, u: dict, depth: int):
        super().__init__()
        heads, hd = heads_at(u, ch)
        inner = heads * hd
        self.depth = depth
        self.norm = GroupNorm32(ch, eps=1e-6)
        self.proj_in = Linear(num, ch, inner)
        for i in range(depth):
            self.add_module(f"block_{i}", Block(num, inner, u["context_dim"], heads, hd))
        self.proj_out = Linear(num, inner, ch)

    def forward(self, x, context, bank=None, collect=False):
        b, c, hh, ww = x.shape
        z = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c))
        written = []
        for i in range(self.depth):
            z, w = getattr(self, f"block_{i}")(z, context, None if bank is None else bank[i],
                                               collect)
            written.append(w)
        z = self.proj_out(z).reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return x + z, written


def embedding(module, t, y):
    """The time embedding plus `label_emb` of the added vector."""
    return module.time_embed(timestep_embedding(t, module.u["model_channels"])) \
        + module.label_emb(y)


class UNetXL(nn.Module):
    """SDXL UNet. `collect=True` returns the bank (norm1 of every transformer
    block's input, traversal order); `bank=` reads one; `residuals=` adds
    the ControlNet's residuals (one per encoder skip, then the middle)."""

    def __init__(self, num, u: dict, in_channels: int):
        super().__init__()
        self.u, self.num = u, num
        mc = u["model_channels"]
        emb = 4 * mc
        self.time_embed = TimeEmbed(num, mc)
        self.label_emb = LabelEmbed(num, u["adm_in_channels"], mc)
        self.conv_in = conv3(num, in_channels, mc)
        units, skips = encoder_plan(u)
        ch, r, d, a = mc, 0, 0, 0
        for kind, out, attn, level in units:
            if kind == "res":
                self.add_module(f"enc_res_{r}", ResBlock(num, ch, out, emb))
                ch = out
                if attn:
                    self.add_module(f"enc_attn_{a}",
                                    SpatialTransformer(num, ch, u, depth_at(u, level)))
                    a += 1
                r += 1
            else:
                self.add_module(f"enc_down_{d}", nn.Module())
                getattr(self, f"enc_down_{d}").conv = conv3(num, ch, ch, stride=2)
                d += 1
        self.mid_res_0 = ResBlock(num, ch, ch, emb)
        self.mid_attn = SpatialTransformer(num, ch, u, depth_middle(u))
        self.mid_res_1 = ResBlock(num, ch, ch, emb)
        a = up = 0
        for i, (out, attn, upsample, level) in enumerate(decoder_plan(u)):
            self.add_module(f"dec_res_{i}", ResBlock(num, ch + skips.pop(), out, emb))
            ch = out
            if attn:
                self.add_module(f"dec_attn_{a}",
                                SpatialTransformer(num, ch, u, depth_at(u, level)))
                a += 1
            if upsample:
                self.add_module(f"dec_up_{up}", nn.Module())
                getattr(self, f"dec_up_{up}").conv = conv3(num, ch, ch)
                up += 1
        self.norm_out = GroupNorm32(ch, act=True)
        self.conv_out = conv3(num, ch, u["out_channels"])

    def forward(self, x, t, context, y, bank=None, collect=False, residuals=None):
        run = self.num.run
        bank = list(bank) if bank is not None else None
        written = []
        emb = embedding(self, t, y)

        def attn(name, h, depth):
            entries = [bank.pop(0) for _ in range(depth)] if bank is not None else None
            h, w = run(lambda hh: getattr(self, name)(hh, context, entries, collect), h)
            written.extend(w)
            return h

        h = self.conv_in(x.permute(0, 3, 1, 2))
        hs = [h]
        r = d = a = 0
        for kind, _, has_attn, level in encoder_plan(self.u)[0]:
            if kind == "res":
                h = run(getattr(self, f"enc_res_{r}"), h, emb)
                if has_attn:
                    h = attn(f"enc_attn_{a}", h, depth_at(self.u, level))
                    a += 1
                r += 1
            else:
                h = getattr(self, f"enc_down_{d}").conv(h)
                d += 1
            hs.append(h)
        h = run(self.mid_res_0, h, emb)
        h = attn("mid_attn", h, depth_middle(self.u))
        h = run(self.mid_res_1, h, emb)
        if residuals is not None:
            h = h + residuals[-1].permute(0, 3, 1, 2)
        a = up = 0
        for i, (_, has_attn, upsample, level) in enumerate(decoder_plan(self.u)):
            skip = hs.pop()
            if residuals is not None:
                skip = skip + residuals[len(hs)].permute(0, 3, 1, 2)
            h = run(getattr(self, f"dec_res_{i}"), torch.cat([h, skip], dim=1), emb)
            if has_attn:
                h = attn(f"dec_attn_{a}", h, depth_at(self.u, level))
                a += 1
            if upsample:
                h = getattr(self, f"dec_up_{up}").conv(F.interpolate(h, scale_factor=2,
                                                                     mode="nearest"))
                up += 1
        out = self.conv_out(self.norm_out(h)).permute(0, 2, 3, 1)
        return out, written


class ControlNetXL(nn.Module):
    """Pose ControlNet of the SDXL encoder: hint CNN, encoder copy with its
    own `label_emb`, a zero convolution per encoder skip and the middle."""

    def __init__(self, num, c: dict, in_channels: int):
        super().__init__()
        self.u, self.num = c, num
        mc = c["model_channels"]
        emb = 4 * mc
        self.time_embed = TimeEmbed(num, mc)
        self.label_emb = LabelEmbed(num, c["adm_in_channels"], mc)
        self.hint_encoder = nn.Module()
        cin = c["hint_channels"]
        for i, (w, s) in enumerate(HINT_WIDTHS):
            self.hint_encoder.add_module(f"conv_{i}", conv3(num, cin, w, s))
            cin = w
        self.hint_encoder.conv_out = conv3(num, cin, mc)
        self.conv_in = conv3(num, in_channels, mc)
        self.zero_conv_0 = conv1(num, mc, mc)
        ch, r, d, a = mc, 0, 0, 0
        for z, (kind, out, attn, level) in enumerate(encoder_plan(c)[0], start=1):
            if kind == "res":
                self.add_module(f"enc_res_{r}", ResBlock(num, ch, out, emb))
                ch = out
                r += 1
                if attn:
                    self.add_module(f"enc_attn_{a}",
                                    SpatialTransformer(num, ch, c, depth_at(c, level)))
                    a += 1
            else:
                self.add_module(f"enc_down_{d}", nn.Module())
                getattr(self, f"enc_down_{d}").conv = conv3(num, ch, ch, stride=2)
                d += 1
            self.add_module(f"zero_conv_{z}", conv1(num, ch, ch))
        self.mid_res_0 = ResBlock(num, ch, ch, emb)
        self.mid_attn = SpatialTransformer(num, ch, c, depth_middle(c))
        self.mid_res_1 = ResBlock(num, ch, ch, emb)
        self.zero_conv_mid = conv1(num, ch, ch)

    def forward(self, x, hint, t, context, y):
        run = self.num.run
        emb = embedding(self, t, y)
        g = hint.permute(0, 3, 1, 2)
        for i in range(len(HINT_WIDTHS)):
            g = F.silu(getattr(self.hint_encoder, f"conv_{i}")(g))
        h = self.conv_in(x.permute(0, 3, 1, 2)) + self.hint_encoder.conv_out(g)
        outs = [self.zero_conv_0(h)]
        r = d = a = 0
        for z, (kind, _, attn, _) in enumerate(encoder_plan(self.u)[0], start=1):
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


class MagicPoseXL(nn.Module):
    """Main UNet, appearance UNet (bank writer) and pose ControlNet."""

    def __init__(self, cfg: dict, num: Numerics = FP32):
        super().__init__()
        if cfg["variant"] != "appearance_pose":
            raise ValueError(f"the sdxl reference is the appearance_pose variant, not "
                             f"{cfg['variant']!r}")
        u = cfg["unet"]
        self.unet = UNetXL(num, u, u["in_channels"])
        self.appearance_unet = UNetXL(num, u, u["out_channels"])
        self.pose_control = ControlNetXL(num, cfg["pose_control"], u["in_channels"])

    def bank(self, ref_latent, t, context, y):
        return self.appearance_unet(ref_latent, t, context, y, collect=True)[1]

    def cond(self, x, t, context, y, bank, hint):
        res = self.pose_control(x, hint, t, context, y)
        return self.unet(x, t, context, y, bank=bank, residuals=res)[0]

    def uncond(self, x, t, context, y):
        return self.unet(x, t, context, y)[0]


class TextTower(nn.Module):
    """A CLIP text transformer: (penultimate or last hidden state, pooled
    embedding or None)."""

    def __init__(self, c: dict):
        super().__init__()
        num, w = FP32, c["hidden_size"]
        self.c = c
        self.token_embedding = nn.Embedding(c["vocab_size"], w, device="meta")
        self.position_embedding = nn.Parameter(torch.empty(c["max_length"], w, device="meta"))
        for i in range(c["num_layers"]):
            layer = nn.Module()
            layer.layer_norm1, layer.layer_norm2 = layer_norm(w), layer_norm(w)
            layer.self_attn = nn.Module()
            for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
                setattr(layer.self_attn, n, Linear(num, w, w))
            layer.fc1, layer.fc2 = Linear(num, w, 4 * w), Linear(num, 4 * w, w)
            self.add_module(f"layer_{i}", layer)
        self.final_layer_norm = layer_norm(w)
        if c["projection_dim"]:
            self.text_projection = nn.Parameter(torch.empty(w, c["projection_dim"],
                                                            device="meta"))

    def act(self, h):
        if self.c["hidden_act"] == "gelu":
            return F.gelu(h)
        return h * torch.sigmoid(1.702 * h)

    def layer(self, i, x, mask):
        b, s, w = x.shape
        heads = self.c["num_heads"]
        hd = w // heads
        layer = getattr(self, f"layer_{i}")
        a = layer.self_attn
        h = layer.layer_norm1(x)

        def split(t):
            return t.reshape(b, s, heads, hd).transpose(1, 2)

        q, k, v = split(a.q_proj(h)), split(a.k_proj(h)), split(a.v_proj(h))
        p = torch.softmax(q @ k.transpose(-1, -2) * hd ** -0.5 + mask, dim=-1)
        x = x + a.out_proj((p @ v).transpose(1, 2).reshape(b, s, w))
        return x + layer.fc2(self.act(layer.fc1(layer.layer_norm2(x))))

    def forward(self, ids):
        c = self.c
        pad = c["pad_token_id"]
        eot = (ids == c["eos_token_id"]).int().argmax(dim=1)
        if pad is not None:
            pos = torch.arange(ids.shape[1], device=ids.device)[None]
            ids = torch.where(pos > eot[:, None], torch.full_like(ids, pad), ids)
        b, s = ids.shape
        x = self.token_embedding(ids.long()) + self.position_embedding[None, :s]
        mask = torch.triu(torch.full((s, s), float("-inf"), device=x.device), diagonal=1)
        n = c["num_layers"]
        penultimate = c["output_layer"] == "penultimate"
        hidden = None
        for i in range(n):
            if penultimate and i == n - 1:
                hidden = x
                if not c["projection_dim"]:
                    return hidden, None
            x = self.layer(i, x, mask)
        last = self.final_layer_norm(x)
        if not c["projection_dim"]:
            return last, None
        pooled = last[torch.arange(b, device=x.device), eot] @ self.text_projection
        return (last if hidden is None else hidden), pooled


class TextTowers(nn.Module):
    """CLIP ViT-L/14 and OpenCLIP ViT-bigG/14 on the same prompt: the
    context (their hidden states side by side) and bigG's pooled embedding."""

    def __init__(self, cl: dict, cg: dict):
        super().__init__()
        self.tower_l, self.tower_g = TextTower(cl), TextTower(cg)

    def forward(self, ids):
        h_l, _ = self.tower_l(ids)
        h_g, pooled = self.tower_g(ids)
        return torch.cat([h_l, h_g], dim=-1), pooled


def added_vector(pooled, height: int, width: int):
    """The pooled embedding, then the 256-wide sinusoids (sd_xl_base.yaml's
    outdim) of original_size (height, width), crop_coords_top_left (0, 0)
    and target_size (height, width)."""
    sizes = [height, width, 0, 0, height, width]
    return torch.cat([pooled] + [timestep_embedding(torch.full((1,), float(v),
                                                               device=pooled.device), 256)
                                 .expand(pooled.shape[0], -1) for v in sizes], dim=1)


def networks(model_cfg: dict, num: Numerics = FP32) -> dict:
    """The networks on the meta device, parameters named as the program's
    state-dict keys."""
    return {"model": MagicPoseXL(model_cfg, num), "vae": VAE(model_cfg["vae"]),
            "clip": TextTowers(model_cfg["clip"], model_cfg["clip_g"])}


@torch.no_grad()
def sample(nets: dict, model_cfg: dict, pose, ref_image, x_T, steps: int, scale: float,
           num: Numerics, video: bool = False, offsets=None, window: int = 16,
           stride: int = 12):
    """The latents (F, h, w, 4) of one image request, before the decode:
    `sample.sample`'s recipe with the added vector of the empty prompt and
    the pose maps' size given to every pass."""
    if video:
        raise NotImplementedError("the sdxl reference samples images; no video traffic "
                                  "uses this family")
    model, vae, clip = nets["model"], nets["vae"], nets["clip"]
    sf = model_cfg["vae"]["scale_factor"]
    with num.encoders():
        ctx, pooled = clip(empty_ids(1).to(x_T.device))
        ref_lat = vae.encode(ref_image)[0] * sf
    y = added_vector(pooled, pose.shape[1], pose.shape[2])
    ts, a, a_prev = ddim_table(model_cfg["diffusion"], steps)
    n = x_T.shape[0]
    x = x_T.float().clone()
    for i in range(steps):
        step = steps - 1 - i
        t1 = torch.full((1,), int(ts[step]), device=x.device)
        bank = model.bank(ref_lat, t1, ctx, y)
        tb = t1.expand(n)
        ec = model.cond(x, tb, ctx, y, bank, pose)
        eu = model.uncond(x, tb, ctx, y)
        eps = eu + scale * (ec - eu)
        al, ap = float(a[step]), float(a_prev[step])
        pred_x0 = (x - (1.0 - al) ** 0.5 * eps) / al ** 0.5
        x = ap ** 0.5 * pred_x0 + max(1.0 - ap, 0.0) ** 0.5 * eps
    return x


class ReferenceTrainer:
    """No training traffic uses the sdxl family yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("the sdxl reference family has no training step: no "
                                  "training traffic uses this family yet")
