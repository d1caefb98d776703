"""Kernel parity gate: every attention kernel (forward and backward) and the
fused GroupNorm+SiLU held against independent fp32 math before anything is
timed.

Counterpart of `magicdance_tpu.ops.kernel_gate`. The inputs go through the
port's own dispatch -- `ops.attention` (kernels A, B, B gated and G without a
gradient) and, with a gradient, the autograd Functions of
`ops.kernels.flash_vjp` (A/B with the LSE output, C, D, G's backward) -- so on
the card the hand-written kernels run, and on the CPU their plain versions.
Each result is compared with a reference written here: fp32 einsum logits,
softmax and PV product over the same (rounded) inputs, keys and values of
two sources concatenated, a batch-1 bank broadcast to the query batch (the
counterpart of JAX's `_xla_attention`, not the kernels' plain twins).
Gradients are those of sum(sin(out)), as in JAX. K8 is held against
F.group_norm then F.silu in fp32.

Tolerances (the repo's bf16 rule): bf16 forward max|diff| <= min(5e-2, 0.1 x
RMS of the reference), bf16 gradients <= min(1e-1, 0.1 x RMS); fp32 forward
2e-4, fp32 gradients 2e-4 x max(1, max|reference|).

`run_gate()` runs the production cases (`GATE_CASES`: every case of the JAX
gate, then the main path's shapes at H = 8, then K8) and returns "ok"; any
deviation raises AssertionError naming the worst case. Standalone:

    python -m magicdance_tpu_torch.ops.kernel_gate [--device cpu]
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from magicdance_tpu_torch.device import resolve_device
from magicdance_tpu_torch.ops import attention as A
from magicdance_tpu_torch.ops.kernels import groupnorm

BF16_FWD, BF16_GRAD, REL_RMS = 5e-2, 1e-1, 0.1
FP32_TOL = 2e-4


@dataclass(frozen=True)
class Case:
    """One gate case.

    kind: "bsnh" (BSNH self-attention), "packed" ((B, S, H*D) self-attention),
    "two_source" (bank read, BSNH), "two_source_packed", "gated" (bank read
    gated per row: the first half of the rows read the bank, the rest do
    not), "grouped" (packed self-attention over N sequences of S frames) or
    "groupnorm" (K8). shape: (B, S, H, D) for attention (N, S, H, D for
    "grouped"), (B, HW, C, groups) for "groupnorm". bank: the bank's
    length (bank batch 1) for the two-source kinds. grads: also dq/dk/dv
    (and dkb/dvb for a bank read)."""

    label: str
    kind: str
    shape: tuple
    bank: int = 0
    grads: bool = False
    dtype: str = "bfloat16"


GATE_CASES: tuple = (
    # the JAX gate's cases, one for one (kernel_gate.py:52-160)
    Case("bsnh", "bsnh", (2, 1024, 2, 40), grads=True),
    Case("packed", "packed", (2, 1024, 2, 40)),
    Case("two_source", "two_source", (2, 1024, 2, 40), bank=1024, grads=True),
    Case("two_source_packed", "two_source_packed", (2, 1024, 2, 40), bank=1024),
    Case("two_source_gated", "gated", (2, 1024, 2, 40), bank=1024),
    Case("grouped", "grouped", (256, 16, 8, 40), grads=True),
    # the main path's shapes at H = 8: self-attention and the batch-1 bank
    # reads of the three attention levels at 512x512, the gated read of
    # fused CFG, the first motion-module level
    *(Case(f"bsnh_s{s}_d{d}", "bsnh", (2, s, 8, d), grads=True)
      for s, d in ((4096, 40), (1024, 80), (256, 160))),
    *(Case(f"two_source_s{s}_d{d}", "two_source", (2, s, 8, d), bank=s, grads=True)
      for s, d in ((4096, 40), (1024, 80), (256, 160))),
    Case("two_source_gated_s4096_d40", "gated", (4, 4096, 8, 40), bank=4096),
    Case("grouped_n4096_d40", "grouped", (4096, 16, 8, 40), grads=True),
    # K8 at the first level of the image UNet
    Case("groupnorm_silu", "groupnorm", (2, 4096, 320, 32)),
)


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _tolerance(want: torch.Tensor, dtype: torch.dtype, grad: bool) -> float:
    if dtype == torch.float32:
        return FP32_TOL * (max(1.0, want.abs().max().item()) if grad else 1.0)
    rms = want.float().pow(2).mean().sqrt().item()
    return min(BF16_GRAD if grad else BF16_FWD, REL_RMS * rms)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v in fp32 over BSNH tensors."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v.float())


def _randn(shape, seed: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    d = (got.float() - want.float()).abs().max().item()
    return d if math.isfinite(d) else math.inf


def _loss(out: torch.Tensor) -> torch.Tensor:
    return torch.sin(out.float()).sum()


def _grads(fn, ref_fn, inputs: Sequence[torch.Tensor]):
    """Gradients of sum(sin(fn(*inputs))) through the dispatch (inputs in
    their dtype) and of sum(sin(ref_fn(*inputs))) in fp32."""
    xs = [t.detach().clone().requires_grad_(True) for t in inputs]
    got = torch.autograd.grad(_loss(fn(*xs)), xs)
    xr = [t.detach().float().requires_grad_(True) for t in inputs]
    want = torch.autograd.grad(_loss(ref_fn(*xr)), xr)
    return got, want


def _attention_case(case: Case, dev: torch.device, seed: int):
    """[(check name, got, want, grad)] of one attention case."""
    dt = _dtype(case.dtype)
    b, s, h, d = case.shape
    scale = d ** -0.5
    q, k, v = (_randn((b, s, h, d), seed + i, dt, dev) for i in range(3))
    out = []

    def add(name, got, want, grad=False):
        out.append((f"{case.label}_{name}", got, want, grad))

    if case.kind in ("bsnh", "packed"):
        def ref(q_, k_, v_):
            return reference_attention(q_, k_, v_, scale)
        with torch.no_grad():
            if case.kind == "bsnh":
                add("fwd", A.dot_product_attention(q, k, v, scale=scale), ref(q, k, v))
            else:
                pk = [t.reshape(b, s, h * d) for t in (q, k, v)]
                add("fwd", A.attention_packed(*pk, num_heads=h, scale=scale),
                    ref(q, k, v).reshape(b, s, h * d))
        if case.grads:
            got, want = _grads(lambda *t: A.dot_product_attention(*t, scale=scale), ref, (q, k, v))
            for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
                add(name, g_, w_, True)
        return out

    if case.kind == "grouped":
        def ref(q_, k_, v_):
            return reference_attention(*(t.reshape(b, s, h, d) for t in (q_, k_, v_)),
                                       scale).reshape(b, s, h * d)

        def fn(q_, k_, v_):
            return A.attention_packed(q_, k_, v_, num_heads=h, scale=scale)
        pk = [t.reshape(b, s, h * d) for t in (q, k, v)]
        with torch.no_grad():
            add("fwd", fn(*pk), ref(*pk))
        if case.grads:
            got, want = _grads(fn, ref, pk)
            for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
                add(name, g_, w_, True)
        return out

    # bank reads: a batch-1 bank of case.bank positions, broadcast
    kb, vb = (_randn((1, case.bank, h, d), seed + 3 + i, dt, dev) for i in range(2))

    def ref2(q_, k_, v_, kb_, vb_):
        n = q_.shape[0]
        return reference_attention(q_, torch.cat([k_, kb_.expand(n, -1, -1, -1)], dim=1),
                                   torch.cat([v_, vb_.expand(n, -1, -1, -1)], dim=1), scale)

    with torch.no_grad():
        if case.kind == "two_source":
            add("fwd", A.bank_read_attention(q, k, v, kb, vb, scale=scale),
                ref2(q, k, v, kb, vb))
        elif case.kind == "two_source_packed":
            pk = [t.reshape(t.shape[0], t.shape[1], h * d) for t in (q, k, v, kb, vb)]
            add("fwd", A.bank_read_attention_packed(*pk, num_heads=h, scale=scale),
                ref2(q, k, v, kb, vb).reshape(b, s, h * d))
        else:  # gated: the first half of the rows read the bank
            mask = torch.cat([torch.ones(b - b // 2), torch.zeros(b // 2)]).to(dev)
            got = A.bank_read_attention(q, k, v, kb, vb, scale=scale, bank_mask=mask)
            r = b - b // 2
            add("read", got[:r], ref2(q[:r], k[:r], v[:r], kb, vb))
            add("plain", got[r:], reference_attention(q[r:], k[r:], v[r:], scale))
    if case.grads:
        got, want = _grads(lambda *t: A.bank_read_attention(*t, scale=scale), ref2,
                           (q, k, v, kb, vb))
        for name, g_, w_ in zip(("dq", "dk", "dv", "dkb", "dvb"), got, want):
            add(name, g_, w_, True)
    return out


def _groupnorm_case(case: Case, dev: torch.device, seed: int):
    dt = _dtype(case.dtype)
    b, hw, c, groups = case.shape
    x = _randn((b, hw, c), seed, dt, dev)
    w = 1.0 + 0.1 * _randn((c,), seed + 1, torch.float32, dev)
    bias = 0.1 * _randn((c,), seed + 2, torch.float32, dev)
    eps = 1e-5
    with torch.no_grad():
        got = groupnorm.groupnorm_act(x, w, bias, groups, eps, "silu")
        want = F.silu(F.group_norm(x.float().transpose(1, 2), groups, w, bias, eps)).transpose(1, 2)
    return [(f"{case.label}_fwd", got, want, False)]


def run_gate(device="cuda", cases: Optional[Sequence[Case]] = None,
             verbose: bool = False) -> str:
    """Forward and gradient parity of the kernels through the port's dispatch
    on `device` (the card unless the caller asks for the CPU), over `cases`
    (default `GATE_CASES`). Raises AssertionError naming the worst check
    (largest deviation over its tolerance); returns "ok"."""
    dev = resolve_device(device)
    results = []
    for i, case in enumerate(GATE_CASES if cases is None else cases):
        checks = (_groupnorm_case(case, dev, 100 * i) if case.kind == "groupnorm"
                  else _attention_case(case, dev, 100 * i))
        for name, got, want, grad in checks:
            if tuple(got.shape) != tuple(want.shape):
                raise AssertionError(f"kernel parity FAILED [{name}]: shape "
                                     f"{tuple(got.shape)} != {tuple(want.shape)}")
            results.append(dict(name=name, err=_err(got, want), dtype=case.dtype,
                                tol=_tolerance(want, _dtype(case.dtype), grad)))
        del checks
    worst = max(results, key=lambda r: r["err"] / r["tol"] if r["tol"] > 0 else math.inf)
    if verbose:
        for r in results:
            print(f"  {r['name']:36s} max|diff| = {r['err']:.3e}  (tol {r['tol']:.1e}, "
                  f"{r['dtype']})", flush=True)
        print(f"  worst: {worst['name']}, {worst['err'] / worst['tol']:.2f} x its tolerance",
              flush=True)
    bad = [r for r in results if not r["err"] <= r["tol"]]
    if bad:
        raise AssertionError(f"kernel parity FAILED [{worst['name']}]: max|diff|="
                             f"{worst['err']:.3e} > {worst['tol']:.1e} ({len(bad)} of "
                             f"{len(results)} checks failed)")
    return "ok"


if __name__ == "__main__":
    import argparse
    import time

    ap = argparse.ArgumentParser(description="kernel parity gate")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    t0 = time.perf_counter()
    dev = resolve_device(args.device)
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
    print(run_gate(dev, verbose=True), f"({time.perf_counter() - t0:.1f} s)")
