"""Probe: can packing G = 3 heads of D = 40 into one tensor-core tile beat
per-head attention on an NVIDIA H100?

The port's counterpart of the JAX package's `scripts/bench_head_packing.py`
(a probe of the TPU's 128 x 128 matrix unit), asked again of the card.

The card's account. The H100's tensor cores contract bf16 operands 16 deep
(`mma.sync.m16n8k16` and `wgmma` alike) and produce output in n8 column
tiles. One head of D = 40 therefore pads to 48 for the QK^T contraction
(1.2x) and fills 5 n8 output tiles exactly (1.0x); on the TPU it padded to
128 lanes (3.2x), which is what made packing worth asking about there.
Packing G = 3 heads block-diagonally contracts over G*D = 120 (padded to
128) and writes 15 output tiles for every key of all three heads: 128/48 =
2.7x the QK^T and 3x the PV tensor-core work of per-head attention, for the
same number of exponentials and 3x the K/V bytes. The probes measure what
the card does:

  P1  QK^T contraction scaling: (256, K) x (K, 4096), batch 64, K in
      {40, 80, 120, 128, 256}, `torch.bmm` in bf16 (fp32 accumulation inside
      the GEMM). k16 tensor cores predict time growing with ceil(K / 16)
      once the GEMM is bound by operations, not flat up to 128.
  P2  PV output scaling: (256, 4096) x (4096, N), batch 64, N in
      {40, 120, 128, 256}.
  P3  Kernel K9 (`ops.kernels.packed.packed_attention`, K/V packed
      block-diagonally beforehand, packing cost excluded) against kernel A
      (`ops.kernels.self_attention`, per head, BSNH) on the same workload:
      B = 32, H = 6, S = 4096, D = 40, G = 3, bf16; both times and the max
      error between the two outputs. Then K9 at G = 1 on the same heads
      (the same function per head, D = 40): in bf16 K9 runs its Hopper body
      (wgmma, TMA) at G*D = 120 and at 40 alike, so the two ratios to kernel
      A (mma.sync) say what that body gains with and without packing.
  P4  int8 vs bf16 tensor-core rate at the hot shapes (M, K, N) =
      (256, 40, 4096), (256, 4096, 128), (4096, 320, 320), batch 64 folded
      into the rows: `torch._int_mm` on (64*M, K) x (K, N) int8 against
      `torch.mm` in bf16 on the same shapes.

P1, P2 and P4 time library GEMMs (as the JAX script timed XLA's
dot_general); P3 times the port's hand-written kernels. Every time is device
time from CUDA events (`utils.timing.device_time_ms`).

Usage, on a machine with an NVIDIA GPU:

    python -m magicdance_tpu_torch.scripts.bench_head_packing [--json PATH]
"""

from __future__ import annotations

import argparse
import json

import torch

from magicdance_tpu_torch.device import resolve_device
from magicdance_tpu_torch.ops import kernels as K
from magicdance_tpu_torch.ops.kernels.packed import (
    blockdiag,
    pack_heads,
    packed_attention,
    unpack_heads,
)
from magicdance_tpu_torch.utils.timing import card_line, device_time_ms

BATCH = 64
P3_SHAPE = dict(B=32, H=6, S=4096, D=40, G=3)  # H = 6 so that G = 3 divides it


def _randn(gen: torch.Generator, *shape, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.randn(*shape, generator=gen, device=gen.device).to(dtype)


def probe_contraction(dev: torch.device, log=print) -> list[dict]:
    log(f"== P1: QK^T contraction scaling (256,K)x(K,4096) bf16, batch {BATCH} ==")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, base = [], None
    for k in (40, 80, 120, 128, 256):
        a, b = _randn(gen, BATCH, 256, k), _randn(gen, BATCH, k, 4096)
        ms = device_time_ms(lambda: torch.bmm(a, b))
        base = base or ms
        rows.append(dict(K=k, ms=ms, vs_first=ms / base))
        log(f"  K={k:4d}: {ms:8.4f} ms   ({ms / base:4.2f}x vs K=40)")
    return rows


def probe_output(dev: torch.device, log=print) -> list[dict]:
    log(f"== P2: PV output scaling (256,4096)x(4096,N) bf16, batch {BATCH} ==")
    gen = torch.Generator(device=dev).manual_seed(1)
    rows, base = [], None
    for n in (40, 120, 128, 256):
        a, b = _randn(gen, BATCH, 256, 4096), _randn(gen, BATCH, 4096, n)
        ms = device_time_ms(lambda: torch.bmm(a, b))
        base = base or ms
        rows.append(dict(N=n, ms=ms, vs_first=ms / base))
        log(f"  N={n:4d}: {ms:8.4f} ms   ({ms / base:4.2f}x vs N=40)")
    return rows


def probe_packed(dev: torch.device, log=print) -> dict:
    sh = P3_SHAPE
    b, h, s, d, g = sh["B"], sh["H"], sh["S"], sh["D"], sh["G"]
    log(f"== P3: block-diagonal packed kernel K9 vs per-head kernel A "
        f"(B={b}, H={h}, S={s}, D={d}, G={g}, bf16) ==")
    gen = torch.Generator(device=dev).manual_seed(2)
    scale = d ** -0.5
    q, k, v = (_randn(gen, b, s, h, d) for _ in range(3))
    per_head_ms = device_time_ms(lambda: K.self_attention(q, k, v, scale))
    # packed beforehand: the packing cost stays out of the time (packing's best case)
    qp, kbd, vbd = pack_heads(q, g), blockdiag(k, g), blockdiag(v, g)
    packed_ms = device_time_ms(lambda: packed_attention(qp, kbd, vbd, g, scale))
    ref = K.self_attention(q, k, v, scale)
    got = unpack_heads(packed_attention(qp, kbd, vbd, g, scale), b, g)
    err = (got.float() - ref.float()).abs().max().item()
    rms = ref.float().pow(2).mean().sqrt().item()
    # G = 1: one head per packed row, the same function per head
    q1, k1, v1 = pack_heads(q, 1), pack_heads(k, 1), pack_heads(v, 1)
    g1_ms = device_time_ms(lambda: packed_attention(q1, k1, v1, 1, scale))
    got1 = unpack_heads(packed_attention(q1, k1, v1, 1, scale), b, 1)
    err1 = (got1.float() - ref.float()).abs().max().item()
    log(f"  per-head kernel A          : {per_head_ms:8.4f} ms")
    log(f"  block-diag packed K9 (G={g}) : {packed_ms:8.4f} ms  (packing cost excluded)  "
        f"{packed_ms / per_head_ms:4.2f}x  maxerr {err:.2e} (A's output rms {rms:.2e})")
    log(f"  per-head K9 (G=1)          : {g1_ms:8.4f} ms  {g1_ms / per_head_ms:4.2f}x  "
        f"maxerr {err1:.2e}")
    return dict(shape=sh, per_head_ms=per_head_ms, packed_ms=packed_ms,
                packed_over_per_head=packed_ms / per_head_ms, max_abs_err=err, rms=rms,
                g1_ms=g1_ms, g1_over_per_head=g1_ms / per_head_ms, g1_max_abs_err=err1)


def probe_int8(dev: torch.device, log=print) -> list[dict]:
    log(f"== P4: int8 vs bf16 tensor-core rate at the hot shapes, batch {BATCH} folded "
        f"into the rows ==")
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for m, k, n in ((256, 40, 4096), (256, 4096, 128), (4096, 320, 320)):
        ab, bb = _randn(gen, BATCH * m, k), _randn(gen, k, n)
        ai = torch.randint(-127, 127, (BATCH * m, k), generator=gen, device=dev,
                           dtype=torch.int8)
        bi = torch.randint(-127, 127, (k, n), generator=gen, device=dev, dtype=torch.int8)
        tb = device_time_ms(lambda: torch.mm(ab, bb))
        ti = device_time_ms(lambda: torch._int_mm(ai, bi))
        rows.append(dict(M=m, K=k, N=n, bf16_ms=tb, int8_ms=ti, bf16_over_int8=tb / ti))
        log(f"  ({m},{k})x({k},{n}): bf16 {tb:8.4f} ms  int8 {ti:8.4f} ms  ({tb / ti:4.2f}x)")
    return rows


def run_all(dev: torch.device, log=print) -> dict:
    """P1-P4 in order; returns every number."""
    return dict(P1=probe_contraction(dev, log), P2=probe_output(dev, log),
                P3=probe_packed(dev, log), P4=probe_int8(dev, log))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None, help="also write the numbers to this path")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    result = dict(card=card, **run_all(dev, lambda m: print(m, flush=True)))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
