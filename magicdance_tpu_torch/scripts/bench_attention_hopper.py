"""Device time of bf16 kernels A and B on their two bodies, the Hopper body
(`csrc/attention_wgmma.cuh`, body "wgmma") and attention_tc
(`csrc/attention_mma.cuh`, body "mma_sync"), over query and key lengths:
the measurement behind the size rule of `ops.kernels.attention.attention_body`.

For each head width D of the model (40, 80, 160; H = 8) it runs A over Sk
keys and B over Sk self keys and a batch-1 bank of Sk keys, at every query
length Sq and key count Sk of a grid up to the width's image length S (4096,
1024, 256), with B = 16 S / Sq sequences (the rows of a 16-frame pass at
that width; fewer where K and V would pass 512 MiB). The two bodies run in
turns (a, b, b, a) on one card and each reports its mean, so that a drift
of the card's clock falls on both alike. Each row also names the body that
`attention_body` picks there. Correctness is `chip_smoke.py`'s job; here
each call is only checked to have launched its kernel once.

Usage, on a machine with an NVIDIA GPU, from the root of a checkout:

    python -m magicdance_tpu_torch.scripts.bench_attention_hopper [--json PATH]
"""

from __future__ import annotations

import argparse
import json

import torch

from magicdance_tpu_torch.device import resolve_device
from magicdance_tpu_torch.ops import kernels as K
from magicdance_tpu_torch.ops.kernels import build
from magicdance_tpu_torch.ops.kernels.attention import attention_body
from magicdance_tpu_torch.utils.timing import card_line, device_time_ms

SITES = ((40, 4096), (80, 1024), (160, 256))  # (D, image length S)
HEADS = 8
QUERY_LENGTHS = (16, 64, 128, 256, 1024, 4096)
KEY_COUNTS = (16, 77, 128, 256, 512, 1024, 4096)
KV_BYTES = 1 << 29  # per K or V tensor


def grid():
    """(D, Sq, Sk, B) of every timed shape."""
    for d, s in SITES:
        for sq in (x for x in QUERY_LENGTHS if x <= s):
            for sk in (x for x in KEY_COUNTS if x <= s or x == 77):
                b = max(1, min(16 * s // sq, KV_BYTES // (sk * HEADS * d * 2)))
                yield d, sq, sk, b


def in_turns(variants: dict) -> dict:
    """{name: fn}: each timed twice, in the order a, b, b, a; the mean."""
    names = list(variants)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(device_time_ms(variants[n]))
    return {n: sum(t) / len(t) for n, t in times.items()}


def run() -> dict:
    dev = resolve_device(None)
    card = card_line()
    print(card, flush=True)
    build.build(("self_attention", "two_source_attention"))
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    rows = []
    for d, sq, sk, b in grid():
        q = rnd(b, sq, HEADS, d)
        k, v, kb, vb = rnd(b, sk, HEADS, d), rnd(b, sk, HEADS, d), rnd(1, sk, HEADS, d), \
            rnd(1, sk, HEADS, d)
        for kernel, counter, fn, keys in (
                ("A", "self_attention",
                 lambda body: K.self_attention(q, k, v, body=body), (sk,)),
                ("B", "two_source_attention",
                 lambda body: K.two_source_attention(q, k, v, kb, vb, body=body), (sk, sk))):
            K.reset_launches()
            fn(None)
            torch.cuda.synchronize()
            assert K.LAUNCHES[counter] == 1, (kernel, dict(K.LAUNCHES))
            t = in_turns({body: (lambda body=body: fn(body)) for body in ("wgmma", "mma_sync")})
            row = dict(kernel=kernel, B=b, Sq=sq, Sk=sk, D=d, wgmma_ms=t["wgmma"],
                       mma_sync_ms=t["mma_sync"],
                       chosen=attention_body(torch.bfloat16, d, rows=sq, keys=keys))
            rows.append(row)
            print(f"{kernel} B={b:5d} Sq={sq:5d} Sk={sk:5d} D={d:3d}  wgmma {t['wgmma']:.4f} ms  "
                  f"mma_sync {t['mma_sync']:.4f} ms  ({t['mma_sync'] / t['wgmma']:.2f}x)  "
                  f"chosen {row['chosen']}", flush=True)
        del q, k, v, kb, vb
        torch.cuda.empty_cache()
    return dict(card=card, rows=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None, help="also write the rows to this path")
    args = ap.parse_args(argv)
    res = run()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
