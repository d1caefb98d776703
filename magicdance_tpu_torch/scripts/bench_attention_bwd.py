"""Device time of the attention backward kernels C (dQ) and D (dK/dV) at
every shape the full-width training steps give them, in bf16, H = 8.

Stage 2 (B = 2 images, 512x512): C with one source and with two (a bank of
batch 2), D, at (S, D) = (4096, 40), (1024, 80), (256, 160). Stage 3 (a
16-frame clip reading one reference's bank): C with two sources (bank batch
1) and D on the self source, at the same (S, D). The script calls only the
wrappers `ops.kernels.flash_vjp.attention_dq` and `attention_dkv`, whose
interface has not changed since the kernels were first ported, so the same
file copied into an older checkout times that checkout's kernels: compare
two checkouts in one run on one card, in turns (old, new, new, old).
Correctness is `chip_smoke.py`'s job (phase 7); here each call is only
checked to have launched its kernel once.

Usage, on a machine with an NVIDIA GPU, from the root of a checkout:

    python -m magicdance_tpu_torch.scripts.bench_attention_bwd [--json PATH]
"""

from __future__ import annotations

import argparse
import json

import torch

from magicdance_tpu_torch.device import resolve_device
from magicdance_tpu_torch.ops import kernels as K
from magicdance_tpu_torch.ops.kernels import flash_vjp as V
from magicdance_tpu_torch.utils.timing import card_line, device_time_ms

SITES = ((4096, 40), (1024, 80), (256, 160))
HEADS = 8


def cases(dev):
    """(label, launch counter, fn) for every stage-2 and stage-3 call; the
    LSE from the forward kernels, delta from their output."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    for b, bank_b, stage in ((2, 2, "stage 2"), (16, 1, "stage 3")):
        for s, d in SITES:
            q, k, v, dout = (rnd(b, s, HEADS, d) for _ in range(4))
            kb, vb = (rnd(bank_b, s, HEADS, d) for _ in range(2))
            shape = f"{stage} ({b}, {s}, {d})"
            if stage == "stage 2":
                out, lse = V.self_attention_lse(q, k, v)
                delta = V.attention_delta(dout, out)
                yield (f"C one source {shape}", "attention_dq",
                       lambda q=q, k=k, v=v, o=dout, l=lse, t=delta:
                       V.attention_dq(q, k, v, o, l, t))
            out, lse = V.two_source_attention_lse(q, k, v, kb, vb)
            delta = V.attention_delta(dout, out)
            yield (f"C two sources {shape} bank {bank_b}", "attention_dq_two_source",
                   lambda q=q, k=k, v=v, o=dout, l=lse, t=delta, kb=kb, vb=vb:
                   V.attention_dq(q, k, v, o, l, t, None, kb, vb))
            yield (f"D self source {shape}", "attention_dkv",
                   lambda q=q, k=k, v=v, o=dout, l=lse, t=delta:
                   V.attention_dkv(k, v, q, o, l, t))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None, help="also write the rows to this path")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line()
    print(card, flush=True)
    out = []
    for label, counter, fn in cases(dev):
        K.reset_launches()
        fn()
        torch.cuda.synchronize()
        if K.LAUNCHES[counter] != 1:
            raise AssertionError(f"{label}: launches {K.LAUNCHES}")
        ms = device_time_ms(fn)
        out.append(dict(label=label, ms=ms))
        print(f"  {label:45s} {ms:.4f} ms", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=card, rows=out), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
