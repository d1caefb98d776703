"""Device time of kernel K8 (fused GroupNorm with a SiLU or identity
epilogue) and of kernel G (grouped temporal attention, forward and backward)
at every shape the full-width serving and stage-3 training paths give them,
in bf16.

K8: every (B, HW, C, epilogue) at which one DDIM step of the 16-frame image
request (16 pose maps at 512x512; the appearance UNet's write pass at B = 1,
the ControlNet and the main UNet's two passes at B = 16) calls
`GroupNorm32`, with its calls per step (two launches each), all of which
take K8 on the card: each timed on K8 and on the plain path it replaced
(`GroupNorm32`'s fp32 group norm, the cast back and SiLU), the 8x8 sites
(`layers.FUSED_GN_MIN_HW`'s evidence) also each with the 3x3 convolution
that follows a norm (C to C channels), since the plain path hands that
convolution an NCHW tensor and K8 a channels_last one. The video request's
sites have the same shapes at B = 16 (its motion modules' norms are the
transformers' shapes). G: every motion-module shape
of a 16-frame window, packed (N, 16, H*D) with H = 8: the forward at 20
launches per video DDIM step each, the backward (dq, dk, dv from q, k, v and
dO) at 10 launches per stage-3 training step each. Correctness is
`chip_smoke.py`'s job (phases 10 and 14); here each call is only checked to
have launched its kernels (two for K8, none on the plain path). To time
another checkout, copy this file into it (the K8 cases need its
`groupnorm_act`) and run both in turns (old, new, new, old) on one card.

Usage, on a machine with an NVIDIA GPU, from the root of a checkout:

    python -m magicdance_tpu_torch.scripts.bench_gn_grouped [--json PATH]
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from magicdance_tpu_torch.device import resolve_device
from magicdance_tpu_torch.models import layers
from magicdance_tpu_torch.ops import kernels as K
from magicdance_tpu_torch.ops.kernels import grouped as G
from magicdance_tpu_torch.ops.kernels import groupnorm as GN
from magicdance_tpu_torch.utils.timing import card_line, device_time_ms

# (B, HW, C, act): GroupNorm32 calls per DDIM step of the 16-frame image
# request with H*W >= 256; act "silu" (ResBlocks, the UNet's output norm,
# eps 1e-5) or None (transformer norms, eps 1e-6)
GN_SITES = {
    (1, 4096, 320, "silu"): 8, (1, 4096, 320, None): 5, (1, 4096, 640, "silu"): 2,
    (1, 4096, 960, "silu"): 1, (1, 1024, 320, "silu"): 1, (1, 1024, 640, "silu"): 6,
    (1, 1024, 640, None): 5, (1, 1024, 960, "silu"): 1, (1, 1024, 1280, "silu"): 1,
    (1, 1024, 1920, "silu"): 1, (1, 256, 640, "silu"): 1, (1, 256, 1280, "silu"): 6,
    (1, 256, 1280, None): 5, (1, 256, 1920, "silu"): 1, (1, 256, 2560, "silu"): 2,
    (16, 4096, 320, "silu"): 20, (16, 4096, 320, None): 12, (16, 4096, 640, "silu"): 4,
    (16, 4096, 960, "silu"): 2, (16, 1024, 320, "silu"): 3, (16, 1024, 640, "silu"): 15,
    (16, 1024, 640, None): 12, (16, 1024, 960, "silu"): 2, (16, 1024, 1280, "silu"): 2,
    (16, 1024, 1920, "silu"): 2, (16, 256, 640, "silu"): 3, (16, 256, 1280, "silu"): 15,
    (16, 256, 1280, None): 12, (16, 256, 1920, "silu"): 2, (16, 256, 2560, "silu"): 4,
}
# the same request's 8x8 calls
GN_SMALL_SITES = {
    (1, 64, 1280, "silu"): 11, (1, 64, 1280, None): 1, (1, 64, 2560, "silu"): 3,
    (16, 64, 1280, "silu"): 30, (16, 64, 1280, None): 3, (16, 64, 2560, "silu"): 6,
}
# (N, S, H, D): G forward launches per video DDIM step (cond + uncond)
GROUPED_SITES = {(4096, 16, 8, 40): 20, (1024, 16, 8, 80): 20, (256, 16, 8, 160): 20,
                 (64, 16, 8, 160): 20}
# (N, S, H, D): G backward launches per stage-3 training step
GROUPED_BWD_SITES = {(4096, 16, 8, 40): 10, (1024, 16, 8, 80): 10, (256, 16, 8, 160): 10,
                     (64, 16, 8, 160): 10}


def _plain(norm: layers.GroupNorm32, x: torch.Tensor) -> torch.Tensor:
    """`GroupNorm32`'s plain path (its forward off the kernel)."""
    h = layers.group_norm_f32(norm.norm, x).to(x.dtype)
    return F.silu(h) if norm.act else h


def cases(dev):
    """(label, group, launch counter or None, launches per call, calls per
    step, fn) for every K8 and G site: each GroupNorm site on K8 and on the
    plain path, weighted by its calls per DDIM step of the 16-frame image
    request (group "H*W >= 256" or "8x8"), at the 8x8 sites also each path
    followed by a 3x3 convolution;
    G's forward weighted by its launches per video DDIM step, G's backward
    by its launches per stage-3 training step."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    for sites, group in ((GN_SITES, "H*W >= 256"), (GN_SMALL_SITES, "8x8")):
        for (b, hw, c, act), per_step in sites.items():
            side = int(round(hw ** 0.5))
            norm = layers.GroupNorm32(c, eps=1e-5 if act else 1e-6, act=act == "silu")
            with torch.no_grad():
                norm.norm.weight.copy_(torch.randn(c, generator=gen, device=dev) * 0.2 + 1)
                norm.norm.bias.copy_(torch.randn(c, generator=gen, device=dev) * 0.2)
            norm = norm.to(dev, torch.bfloat16)
            x = rnd(b, side, side, c).permute(0, 3, 1, 2)  # NCHW, channels_last
            rows = x.permute(0, 2, 3, 1).view(b, hw, c)
            gn = norm.norm
            shape = f"({b}, {hw}, {c}) {act}"
            k8 = (lambda rows=rows, gn=gn, act=act:
                  GN.groupnorm_act(rows, gn.weight, gn.bias, gn.num_groups, gn.eps, act))
            plain = (lambda norm=norm, x=x: _plain(norm, x))
            yield f"K8 (B, HW, C) = {shape}", group, "groupnorm_silu", 2, per_step, k8
            yield f"plain (B, HW, C) = {shape}", group, None, 0, per_step, plain
            if sites is GN_SITES:
                continue
            conv = layers.conv3x3(c, c).to(dev, torch.bfloat16)

            def k8_conv(k8=k8, conv=conv, b=b, side=side, c=c):
                return conv(k8().view(b, side, side, c).permute(0, 3, 1, 2))

            yield (f"K8 + conv (B, HW, C) = {shape}", group, "groupnorm_silu", 2, per_step,
                   k8_conv)
            yield (f"plain + conv (B, HW, C) = {shape}", group, None, 0, per_step,
                   lambda conv=conv, plain=plain: conv(plain()))
    for (n, s, h, d), per_step in GROUPED_SITES.items():
        q, k, v = (rnd(n, s, h * d) for _ in range(3))
        yield (f"G forward (N, S, D) = ({n}, {s}, {d})", "video step", "grouped", 1, per_step,
               lambda q=q, k=k, v=v, h=h: G.grouped_attention(q, k, v, None, h))
    for (n, s, h, d), per_step in GROUPED_BWD_SITES.items():
        q, k, v, g = (rnd(n, s, h * d) for _ in range(4))
        yield (f"G backward (N, S, D) = ({n}, {s}, {d})", "stage-3 step", "grouped_bwd", 1,
               per_step,
               lambda q=q, k=k, v=v, g=g, h=h: G.grouped_attention_bwd(q, k, v, g, None, h))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None, help="also write the rows to this path")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line()
    out = []
    totals = {}
    with torch.no_grad():
        for label, group, counter, launches, per_step, fn in cases(dev):
            K.reset_launches()
            fn()
            torch.cuda.synchronize()
            got = {m: n for m, n in K.LAUNCHES.items() if n}
            if got != ({counter: launches} if counter else {}):
                raise AssertionError(f"{label}: launches {got}")
            ms = device_time_ms(fn)
            key = f"{label.split(' (')[0]}, {group}"
            totals[key] = totals.get(key, 0.0) + per_step * ms
            out.append(dict(label=label, group=group, ms=ms, calls_per_step=per_step))
            print(f"  {label:48s} {ms:.4f} ms  x{per_step}/step  ({card})", flush=True)
    for key, ms in totals.items():
        print(f"  {key}: {ms:.4f} ms a step  ({card})", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=card, rows=out, per_step_ms=totals), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
