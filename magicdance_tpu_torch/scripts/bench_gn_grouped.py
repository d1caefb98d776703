"""Device time of kernel K8 (fused GroupNorm+SiLU) and of kernel G (grouped
temporal attention, forward and backward) at every shape the full-width
serving and stage-3 training paths give them, in bf16.

K8: every (B, HW, C) at which one DDIM step of the image request (two pose
maps at 512x512, `MAGICDANCE_FUSED_GN=1`) calls it, with its launches per
step (the appearance UNet's write pass at B = 1, the ControlNet and the main
UNet's two passes at B = 2), and the first level of the 16-frame video
request, (16, 4096, 320). G: every motion-module shape of a 16-frame window,
packed (N, 16, H*D) with H = 8: the forward at 20 launches per video DDIM
step each, the backward (dq, dk, dv from q, k, v and dO) at 10 launches per
stage-3 training step each. The script calls only the wrappers
`ops.kernels.groupnorm.groupnorm_silu`, `ops.kernels.grouped.grouped_attention`
and `ops.kernels.grouped.grouped_attention_bwd`, whose interfaces have not
changed since the kernels were first ported, so the same file copied into an older
checkout times that checkout's kernels: compare two checkouts in one run on
one card, in turns (old, new, new, old). Correctness is `chip_smoke.py`'s
job (phases 10 and 14); here each call is only checked to have launched its
kernel once.

Usage, on a machine with an NVIDIA GPU, from the root of a checkout:

    python -m magicdance_tpu_torch.scripts.bench_gn_grouped [--json PATH]
"""

from __future__ import annotations

import argparse
import json

import torch

from magicdance_tpu_torch.device import resolve_device
from magicdance_tpu_torch.ops import kernels as K
from magicdance_tpu_torch.ops.kernels import grouped as G
from magicdance_tpu_torch.ops.kernels import groupnorm as GN
from magicdance_tpu_torch.utils.timing import card_line, device_time_ms

# (B, HW, C): K8 launches per DDIM step of the fused-GN image request
GN_SITES = {
    (1, 4096, 320): 8, (2, 4096, 320): 20, (1, 4096, 640): 2, (2, 4096, 640): 4,
    (1, 4096, 960): 1, (2, 4096, 960): 2, (1, 1024, 320): 1, (2, 1024, 320): 3,
    (1, 1024, 640): 6, (2, 1024, 640): 15, (1, 1024, 960): 1, (2, 1024, 960): 2,
    (1, 1024, 1280): 1, (2, 1024, 1280): 2, (1, 1024, 1920): 1, (2, 1024, 1920): 2,
    (1, 256, 640): 1, (2, 256, 640): 3, (1, 256, 1280): 6, (2, 256, 1280): 15,
    (1, 256, 1920): 1, (2, 256, 1920): 2, (1, 256, 2560): 2, (2, 256, 2560): 4,
}
GN_VIDEO_SITES = ((16, 4096, 320),)
GROUPS, EPS = 32, 1e-5
# (N, S, H, D): G forward launches per video DDIM step (cond + uncond)
GROUPED_SITES = {(4096, 16, 8, 40): 20, (1024, 16, 8, 80): 20, (256, 16, 8, 160): 20,
                 (64, 16, 8, 160): 20}
# (N, S, H, D): G backward launches per stage-3 training step
GROUPED_BWD_SITES = {(4096, 16, 8, 40): 10, (1024, 16, 8, 80): 10, (256, 16, 8, 160): 10,
                     (64, 16, 8, 160): 10}


def cases(dev):
    """(label, launch counter, launches per step, fn) for every K8 and G
    site: K8's image sites weighted by their launches per fused-GN DDIM
    step, its video site by 0, G's forward by its launches per video DDIM
    step, G's backward by its launches per stage-3 training step."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    sites = [(s, n) for s, n in GN_SITES.items()] + [(s, 0) for s in GN_VIDEO_SITES]
    for (b, hw, c), per_step in sites:
        x = rnd(b, hw, c)
        w = torch.randn(c, generator=gen, device=dev) * 0.2 + 1
        bias = torch.randn(c, generator=gen, device=dev) * 0.2
        yield (f"K8 (B, HW, C) = ({b}, {hw}, {c})", "groupnorm_silu", per_step,
               lambda x=x, w=w, bias=bias: GN.groupnorm_silu(x, w, bias, GROUPS, EPS))
    for (n, s, h, d), per_step in GROUPED_SITES.items():
        q, k, v = (rnd(n, s, h * d) for _ in range(3))
        yield (f"G forward (N, S, D) = ({n}, {s}, {d})", "grouped", per_step,
               lambda q=q, k=k, v=v, h=h: G.grouped_attention(q, k, v, None, h))
    for (n, s, h, d), per_step in GROUPED_BWD_SITES.items():
        q, k, v, g = (rnd(n, s, h * d) for _ in range(4))
        yield (f"G backward (N, S, D) = ({n}, {s}, {d})", "grouped_bwd", per_step,
               lambda q=q, k=k, v=v, g=g, h=h: G.grouped_attention_bwd(q, k, v, g, None, h))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None, help="also write the rows to this path")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line()
    out = []
    totals = {"groupnorm_silu": 0.0, "grouped": 0.0, "grouped_bwd": 0.0}
    for label, counter, per_step, fn in cases(dev):
        K.reset_launches()
        fn()
        torch.cuda.synchronize()
        if K.LAUNCHES[counter] != 1:
            raise AssertionError(f"{label}: launches {K.LAUNCHES}")
        ms = device_time_ms(fn)
        totals[counter] += per_step * ms
        out.append(dict(label=label, ms=ms, launches_per_step=per_step))
        print(f"  {label:40s} {ms:.4f} ms  x{per_step}/step  ({card})", flush=True)
    print(f"  K8 per fused-GN image DDIM step: {totals['groupnorm_silu']:.4f} ms  ({card})",
          flush=True)
    print(f"  G forward per video DDIM step: {totals['grouped']:.4f} ms  ({card})", flush=True)
    print(f"  G backward per stage-3 step: {totals['grouped_bwd']:.4f} ms  ({card})", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=card, rows=out, per_step_ms=totals), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
