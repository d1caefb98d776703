"""Device time of the bf16 attention kernels on their two bodies, the Hopper
body ("wgmma": `csrc/attention_wgmma.cuh` for A and B,
`csrc/attention_bwd_wgmma.cuh` for C and D) and the mma.sync body
("mma_sync": `attention_tc` of `csrc/attention_mma.cuh`, `attention_dq_tc` /
`attention_dkv_tc` of `csrc/attention_bwd_mma.cuh`), over query and key
lengths: the measurement behind the size rule of
`ops.kernels.attention.attention_body`.

Forward (A, B). For each head width D of the model (40, 80, 160; H = 8) it
runs A over Sk keys and B over Sk self keys and a batch-1 bank of Sk keys,
at every query length Sq and key count Sk of a grid up to the width's image
length S (4096, 1024, 256), with B = 16 S / Sq sequences (the rows of a
16-frame pass at that width; fewer where K and V would pass 512 MiB).

Backward (C, D). At the same widths, query lengths and key counts from 16
(the temporal sites) and 64 up to S, plus the text encoder's 77 keys, at B =
2 S / Sq and 16 S / Sq sequences (a stage-2 and a stage-3 step's rows): C
with one source ("C") and with a second, batch-1 source of Sk keys ("C2"),
D on a source of batch B ("D") and, at 16 S / Sq, on a batch-1 source read
by every batch ("Dshared"). Where `dkv_split` splits D's query walk, D's
Hopper body is also timed unsplit ("wgmma_nosplit"). The delta and LSE are
random: the time does not depend on them.

SDXL (`--kernels SDXL`). A and B at the 64-wide heads of the
`magicpose-sdxl` UNet at 1024x1024, 8 rows: the bank read at 64x64 (4096
queries over 4096 self keys and a batch-1 bank of 4096, 10 heads) and at
32x32 (1024 + 1024, 20 heads), the self-attention of the write, ControlNet
and uncond passes at both, and the cross-attention over the prompt's 77
keys (the plain path serves it: fewer than 256 keys). Beside both bodies:
the plain version, one `F.scaled_dot_product_attention` call (the
library), and the least time (matmul FLOPs over 989 TFLOP/s or each input
read and the output written once over 3.35 TB/s; the exponentials, one a
logit, 16 per SM and clock on 132 SMs at 1.98 GHz).

The bodies run in turns (a, b, b, a) on one card and each reports its mean,
so that a drift of the card's clock falls on both alike. Each row also names
the body that `attention_body` picks there. Correctness is `chip_smoke.py`'s
job (the SDXL shapes: phase 27); here each call is only checked to have
launched its kernel once.

Usage, on a machine with an NVIDIA GPU, from the root of a checkout:

    python -m magicdance_tpu_torch.scripts.bench_attention_hopper [--json PATH]
        [--kernels AB,CD,SDXL]
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from magicdance_tpu_torch.device import resolve_device
from magicdance_tpu_torch.ops import kernels as K
from magicdance_tpu_torch.ops.kernels import build
from magicdance_tpu_torch.ops.kernels import flash_vjp as V
from magicdance_tpu_torch.ops.kernels.attention import (
    WGMMA_MAX_DKV,
    attention_body,
    self_attention_ref,
    two_source_attention_ref,
)
from magicdance_tpu_torch.utils.timing import card_line, device_time_ms

SITES = ((40, 4096), (80, 1024), (160, 256))  # (D, image length S)
HEADS = 8
QUERY_LENGTHS = (16, 64, 128, 256, 1024, 4096)
KEY_COUNTS = (16, 77, 128, 256, 512, 1024, 4096)
KV_BYTES = 1 << 29  # per K or V tensor
BWD_QUERY_LENGTHS = (16, 64, 256, 1024, 4096)
BWD_KEY_COUNTS = (16, 64, 77, 256, 1024, 4096)
BWD_FRAMES = (2, 16)  # B = frames x S / Sq
BWD_MIN_S = 0.1  # seconds of work a timing
# (kernel, B, Sq, Sk, bank keys, H) at D = 64: the sdxl-pose.serve-f4 shapes
SDXL_D = 64
SDXL_SHAPES = (("B", 8, 4096, 4096, 4096, 10), ("B", 8, 1024, 1024, 1024, 20),
               ("A", 8, 4096, 4096, 0, 10), ("A", 8, 1024, 1024, 0, 20),
               ("A", 8, 4096, 77, 0, 10), ("A", 8, 1024, 77, 0, 20))
PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_EXP = 989e12, 3.35e12, 132 * 16 * 1.98e9


def grid():
    """(D, Sq, Sk, B) of every timed shape."""
    for d, s in SITES:
        for sq in (x for x in QUERY_LENGTHS if x <= s):
            for sk in (x for x in KEY_COUNTS if x <= s or x == 77):
                b = max(1, min(16 * s // sq, KV_BYTES // (sk * HEADS * d * 2)))
                yield d, sq, sk, b


def bwd_grid():
    """(D, Sq, Sk, B, frames) of every timed C / D shape (a shape the
    memory cap gives the same B at both frame counts comes once)."""
    for d, s in SITES:
        for sq in (x for x in BWD_QUERY_LENGTHS if x <= s):
            for sk in (x for x in BWD_KEY_COUNTS if x <= s or x == 77):
                seen = set()
                for frames in BWD_FRAMES:
                    b = max(1, min(frames * s // sq, KV_BYTES // (sk * HEADS * d * 2)))
                    if b not in seen:
                        seen.add(b)
                        yield d, sq, sk, b, frames


def in_turns(variants: dict, min_total_s: float = 0.25) -> dict:
    """{name: fn}: each timed twice, in the order a, b, b, a; the mean."""
    names = list(variants)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(device_time_ms(variants[n], min_total_s=min_total_s))
    return {n: sum(t) / len(t) for n, t in times.items()}


def run(kernels=("AB", "CD")) -> dict:
    dev = resolve_device(None)
    card = card_line()
    print(card, flush=True)
    build.build(("self_attention", "two_source_attention", "attention_dq", "attention_dkv"))
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    rows = forward_rows(rnd) if "AB" in kernels else []
    if "CD" in kernels:
        rows += backward_rows(rnd)
    if "SDXL" in kernels:
        rows += sdxl_rows(rnd)
    return dict(card=card, rows=rows)


def bound_ms(b, sq, h, d, keys) -> tuple:
    """(least time of the work, what bounds it, least time of the
    exponentials) in ms; `keys`: (batch, length) of each K/V source."""
    flops = sum(4.0 * b * h * sq * sk * d for _, sk in keys)
    nbytes = 2 * h * d * (2 * b * sq + sum(2 * bb * sk for bb, sk in keys))
    t_ops, t_mem = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    exp = b * h * sq * sum(sk for _, sk in keys) / PEAK_EXP * 1e3
    return (t_ops, "operations", exp) if t_ops >= t_mem else (t_mem, "bytes", exp)


def sdxl_rows(rnd) -> list:
    rows = []
    d = SDXL_D
    for kernel, b, sq, sk, bank, h in SDXL_SHAPES:
        q, k, v = rnd(b, sq, h, d), rnd(b, sk, h, d), rnd(b, sk, h, d)
        keys = ((b, sk),)
        if bank:
            kb, vb = rnd(1, bank, h, d), rnd(1, bank, h, d)
            keys += ((1, bank),)

            def fn(body, q=q, k=k, v=v, kb=kb, vb=vb):
                return K.two_source_attention(q, k, v, kb, vb, body=body)

            def plain(q=q, k=k, v=v, kb=kb, vb=vb):
                return two_source_attention_ref(q, k, v, kb, vb)

            kk = torch.cat([k, kb.expand(b, -1, -1, -1)], dim=1).transpose(1, 2)
            vv = torch.cat([v, vb.expand(b, -1, -1, -1)], dim=1).transpose(1, 2)
        else:
            def fn(body, q=q, k=k, v=v):
                return K.self_attention(q, k, v, body=body)

            def plain(q=q, k=k, v=v):
                return self_attention_ref(q, k, v)

            kk, vv = k.transpose(1, 2), v.transpose(1, 2)
        qq = q.transpose(1, 2)
        t = in_turns({body: (lambda body=body: fn(body)) for body in ("wgmma", "mma_sync")})
        plain_ms = device_time_ms(plain, min_total_s=0.1, max_iters=5)
        lib_ms = device_time_ms(lambda: F.scaled_dot_product_attention(qq, kk, vv))
        bound, by, exp = bound_ms(b, sq, h, d, keys)
        chosen = attention_body(torch.bfloat16, d, rows=sq, keys=tuple(n for _, n in keys))
        rows.append(dict(kernel=kernel, B=b, Sq=sq, Sk=sk, bank=bank, H=h, D=d,
                         wgmma_ms=t["wgmma"], mma_sync_ms=t["mma_sync"], plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound, bound_by=by, exp_bound_ms=exp,
                         chosen=chosen))
        print(f"SDXL {kernel} B={b} Sq={sq} Sk={sk}+{bank} H={h} D={d}  wgmma "
              f"{t['wgmma']:.4f} ms  mma_sync {t['mma_sync']:.4f} ms  plain {plain_ms:.4f} ms  "
              f"library {lib_ms:.4f} ms  bound {bound:.4f} ms ({by}; exp {exp:.4f})  "
              f"chosen {chosen}", flush=True)
        del q, k, v, kk, vv, qq
        torch.cuda.empty_cache()
    return rows


def forward_rows(rnd) -> list:
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
    return rows


def backward_rows(rnd) -> list:
    rows = []
    for d, sq, sk, b, frames in bwd_grid():
        q, dout = rnd(b, sq, HEADS, d), rnd(b, sq, HEADS, d)
        k, v, kb, vb = rnd(b, sk, HEADS, d), rnd(b, sk, HEADS, d), rnd(1, sk, HEADS, d), \
            rnd(1, sk, HEADS, d)
        lse = torch.randn(b, HEADS, sq, device=q.device) + 5.0
        delta = torch.randn(b, HEADS, sq, device=q.device)
        cases = [
            ("C", "attention_dq", "dq", (sk,),
             lambda body: V.attention_dq(q, k, v, dout, lse, delta, body=body)),
            ("C2", "attention_dq_two_source", "dq", (sk, sk),
             lambda body: V.attention_dq(q, k, v, dout, lse, delta, None, kb, vb, body=body)),
            ("D", "attention_dkv", "dkv", (sk,),
             lambda body, n=None: V.attention_dkv(k, v, q, dout, lse, delta, body=body,
                                                  nsplit=n))]
        if frames == max(BWD_FRAMES):
            cases.append(("Dshared", "attention_dkv", "dkv", (sk,),
                          lambda body, n=None: V.attention_dkv(kb, vb, q, dout, lse, delta,
                                                               body=body, nsplit=n)))
        for kernel, counter, kind, keys, fn in cases:
            if kind == "dkv" and d > WGMMA_MAX_DKV:
                continue
            K.reset_launches()
            fn(None)
            torch.cuda.synchronize()
            assert K.LAUNCHES[counter] == 1, (kernel, dict(K.LAUNCHES))
            variants = {body: (lambda body=body: fn(body)) for body in ("wgmma", "mma_sync")}
            nsplit = 1
            if kind == "dkv":
                bk = 1 if kernel == "Dshared" else b
                nsplit = V.dkv_split(bk, sk, HEADS, (b if bk == 1 else 1) * sq)
                if nsplit > 1:
                    variants["wgmma_nosplit"] = lambda: fn("wgmma", 1)
            t = in_turns(variants, BWD_MIN_S)
            row = dict(kernel=kernel, B=b, Sq=sq, Sk=sk, D=d, frames=frames, nsplit=nsplit,
                       wgmma_ms=t["wgmma"], mma_sync_ms=t["mma_sync"],
                       wgmma_nosplit_ms=t.get("wgmma_nosplit"),
                       chosen=attention_body(torch.bfloat16, d, rows=sq, keys=keys, kernel=kind))
            rows.append(row)
            print(f"{kernel:7s} B={b:5d} Sq={sq:5d} Sk={sk:5d} D={d:3d}  wgmma {t['wgmma']:.4f} ms"
                  + (f" (x{nsplit}; unsplit {t['wgmma_nosplit']:.4f})" if nsplit > 1 else "")
                  + f"  mma_sync {t['mma_sync']:.4f} ms  ({t['mma_sync'] / t['wgmma']:.2f}x)  "
                  f"chosen {row['chosen']}", flush=True)
        del q, k, v, kb, vb, dout, lse, delta
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None, help="also write the rows to this path")
    ap.add_argument("--kernels", default="AB,CD",
                    help="AB (forward), CD (backward), SDXL (the sdxl cell's forward "
                         "shapes), comma-separated")
    args = ap.parse_args(argv)
    res = run(tuple(args.kernels.split(",")))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
