#!/usr/bin/env python3
"""Smoke run of the PyTorch port (magicdance_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, in order; every check raises, so any failure exits non-zero:
  1. card, torch and CUDA versions; TF32 off in cuBLAS and cuDNN for the
     whole run, so the compared (phases 3-4) and the timed (phases 5-6)
     configurations are the same; the pipeline also runs its fp32 work
     (VAE, CLIP) in full fp32 by itself.
  2. build the CUDA kernels from ops/kernels/csrc (one nvcc per source, all
     at once) and print the build time and the ptxas resource report.
  3. hold each kernel against its plain PyTorch version at every shape the
     main path gives it (bf16: max-abs <= min(5e-2, 0.1 x the RMS of the
     plain output), since these outputs are far below O(1); fp32: max-abs
     <= 2e-4), plus a
     BSNH-strided, a ragged and a separate-bank-batch case; time kernel,
     plain version, the library call (F.scaled_dot_product_attention, a
     yardstick only) and the bound max(FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s).
  4. small-input reference: a narrow model at 128x128 (S = 256 at the
     first level, so the kernels run) sampled on the card (fp32, kernels)
     and on the CPU (plain path) from the same weights and x_T must agree.
  5. the main path at full SD1.5 width: MagicPosePipeline(ModelConfig())
     with a bf16 denoiser, seeded random weights (every leaf), two requests
     of F = 2 pose maps at 512x512 with the default SampleConfig (DDIM-50,
     CFG 7); asserts finite (2, 512, 512, 3) outputs and exactly 36
     self-attention and 15 two-source kernel launches per DDIM step.
  6. time of each piece of a request (CLIP, VAE encode, the four passes of
     one DDIM step, VAE decode) on the card, and for one call the host's
     enqueue time beside its wall time, after the main path's counts.
  7. the `kernels` JSON line, the card line, then the result line.

Exits non-zero without a result when torch.cuda.is_available() is false or
the port's package is not beside this script.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

BF16_TOL = 5e-2  # magicdance_tpu/ops/kernel_gate.py:52
# bf16 is also held to a tenth of the plain output's RMS: with randn q/k/v
# the outputs are ~sqrt(e / S_kv) (0.02-0.1), so 5e-2 alone would pass a
# kernel whose error is the size of its output
BF16_REL_TOL = 0.1
FP32_TOL = 2e-4
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12      # H100 SXM HBM3

KERNELS = {
    "self_attention": dict(
        source="magicdance_tpu_torch/ops/kernels/csrc/self_attention.cu",
        replaces="magicdance_tpu/ops/pallas/flash.py:286 (_attn_kernel_fused); "
                 "magicdance_tpu/ops/pallas/flash.py:76 (_attn_kernel)"),
    "two_source_attention": dict(
        source="magicdance_tpu_torch/ops/kernels/csrc/two_source_attention.cu",
        replaces="magicdance_tpu/ops/pallas/flash.py:308 (_attn2_kernel_fused); "
                 "magicdance_tpu/ops/pallas/flash.py:97 (_attn2_kernel_nomask)"),
}
SELF_PER_STEP = 36
TWO_SOURCE_PER_STEP = 15


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "cpu model unknown"


def cuda_time_ms(fn, min_total_s: float = 0.25, max_iters: int = 50) -> float:
    """Mean time of fn() on the card from CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t0
    n = max(3, min(max_iters, int(min_total_s / max(once, 1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def attention_bound_ms(b, sq, h, d, kv, itemsize=2) -> tuple[float, str]:
    """kv: list of (batch, length) per K/V source. Least time for the work:
    the matmul FLOPs over the bf16 peak vs each input read and the output
    written once over the memory rate."""
    flops = sum(4.0 * b * h * sq * sk * d for _, sk in kv)
    nbytes = itemsize * h * d * (2 * b * sq + sum(2 * bb * sk for bb, sk in kv))
    t_ops, t_mem = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------


def main_path_shapes(frames: int):
    """(kernel, B, S, D, bank_batch, launches per DDIM step) at SD1.5 width,
    512x512, `frames` pose maps: the write pass (B = 1) and the ControlNet and
    uncond passes (B = F) for self-attention; bank reads (B = F, bank batch 1)
    for two-source attention."""
    sites = ((4096, 40), (1024, 80), (256, 160))
    out = []
    for s, d in sites:
        out.append(("self_attention", 1, s, d, None, 5))
        out.append(("self_attention", frames, s, d, None, 7))
    for s, d in sites:
        out.append(("two_source_attention", frames, s, d, 1, 5))
    return out


def check_kernels(frames: int, heads: int = 8):
    import torch
    import torch.nn.functional as F

    from magicdance_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    errs = {"self_attention": 0.0, "two_source_attention": 0.0}
    ratios = {"self_attention": 0.0, "two_source_attention": 0.0}
    checked = {"self_attention": 0, "two_source_attention": 0}
    rows = []

    def check(name, got, want, tol, label):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rms = want.float().pow(2).mean().sqrt().item()
        if got.dtype == torch.bfloat16:
            tol = min(tol, BF16_REL_TOL * rms)
        if not (err <= tol):
            raise AssertionError(f"{name} {label}: max|kernel - plain| = {err:.3e} > "
                                 f"{tol:.3e} (plain rms {rms:.3e})")
        errs[name] = max(errs[name], err)
        ratios[name] = max(ratios[name], err / rms)
        checked[name] += 1
        log(f"  ok  {name:22s} {label:48s} max_abs_err={err:.3e} rms={rms:.3e} "
            f"(tol {tol:.3e})")

    # every main-path shape, in bf16 (timed) and fp32
    for name, b, s, d, bb, per_step in main_path_shapes(frames):
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            q, k, v = (rnd(b, s, heads, d, dtype=dtype) for _ in range(3))
            if name == "self_attention":
                args = (q, k, v)
                kern, plain = K.self_attention, K.self_attention_ref
                kv = [(b, s)]
            else:
                kb, vb = rnd(bb, s, heads, d, dtype=dtype), rnd(bb, s, heads, d, dtype=dtype)
                args = (q, k, v, kb, vb)
                kern, plain = K.two_source_attention, K.two_source_attention_ref
                kv = [(b, s), (bb, s)]
            label = f"{str(dtype)[6:]} B={b} S={s} D={d}" + (f" bank_batch={bb}" if bb else "")
            got = kern(*args)
            want = plain(*args)
            check(name, got, want, tol, label)
            if dtype != torch.bfloat16:
                continue
            ms = cuda_time_ms(lambda: kern(*args))
            plain_ms = cuda_time_ms(lambda: plain(*args), min_total_s=0.1, max_iters=5)
            qh = q.transpose(1, 2)
            if name == "self_attention":
                kh, vh = k.transpose(1, 2), v.transpose(1, 2)
            else:
                kh = torch.cat([k, kb.expand(b, -1, -1, -1)], dim=1).transpose(1, 2)
                vh = torch.cat([v, vb.expand(b, -1, -1, -1)], dim=1).transpose(1, 2)
            lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
            bound, bound_by = attention_bound_ms(b, s, heads, d, kv)
            rows.append(dict(kernel=name, B=b, S=s, D=d, H=heads, bank_batch=bb,
                             launches_per_step=per_step, kernel_ms=ms,
                             plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                             bound_by=bound_by))
            log(f"      kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={lib_ms:.4f} bound_ms={bound:.4f} ({bound_by})")
            del q, k, v, args
            torch.cuda.empty_cache()

    # two-source attention with a per-frame bank (bank batch B)
    for s, d in ((4096, 40), (1024, 80), (256, 160)):
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            q, k, v, kb, vb = (rnd(frames, s, heads, d, dtype=dtype) for _ in range(5))
            check("two_source_attention", K.two_source_attention(q, k, v, kb, vb),
                  K.two_source_attention_ref(q, k, v, kb, vb), tol,
                  f"{str(dtype)[6:]} B={frames} S={s} D={d} bank_batch={frames}")

    # layouts and edges the main path does not show: a BSNH view of a
    # (B, H, S, D) tensor, a ragged length, a per-frame bank of another length
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
        tag = str(dtype)[6:]
        q, k, v = (rnd(2, heads, 1024, 80, dtype=dtype).transpose(1, 2) for _ in range(3))
        check("self_attention", K.self_attention(q, k, v),
              K.self_attention_ref(q, k, v), tol, f"{tag} BSNH-strided B=2 S=1024 D=80")
        q, k, v = (rnd(3, 300, 4, 48, dtype=dtype) for _ in range(3))
        check("self_attention", K.self_attention(q, k, v),
              K.self_attention_ref(q, k, v), tol, f"{tag} ragged B=3 S=300 D=48")
        kb, vb = rnd(3, 200, 4, 48, dtype=dtype), rnd(3, 200, 4, 48, dtype=dtype)
        check("two_source_attention", K.two_source_attention(q, k, v, kb, vb),
              K.two_source_attention_ref(q, k, v, kb, vb), tol,
              f"{tag} ragged B=3 S=300 bank B=3 Sb=200 D=48")
        q, k, v = (rnd(2, 256, 2, 256, dtype=dtype) for _ in range(3))
        check("self_attention", K.self_attention(q, k, v),
              K.self_attention_ref(q, k, v), tol, f"{tag} B=2 S=256 D=256")
    return rows, errs, ratios, checked


# --------------------------------------------------------------------------
# phase 4: small-input reference (card with kernels vs CPU plain path)
# --------------------------------------------------------------------------


def small_reference_check():
    import torch

    from magicdance_tpu_torch.config import (
        CLIPTextConfig, ControlNetConfig, ModelConfig, SampleConfig, UNetConfig,
        VAEConfig)
    from magicdance_tpu_torch.ops import kernels as K
    from magicdance_tpu_torch.pipeline import MagicPosePipeline

    narrow = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                  attention_resolutions=(1, 2), num_heads=2, context_dim=16)
    cfg = ModelConfig(unet=UNetConfig(**narrow), pose_control=ControlNetConfig(**narrow),
                      vae=VAEConfig(base_channels=32, channel_mult=(1, 1, 2, 2),
                                    num_res_blocks=1),
                      clip=CLIPTextConfig(hidden_size=16, num_layers=1, num_heads=2),
                      latent_size=16, dtype="float32")
    g = torch.Generator().manual_seed(7)
    pose = torch.rand(2, 128, 128, 3, generator=g)
    ref = torch.rand(1, 128, 128, 3, generator=g) * 2 - 1
    x_T = torch.randn(1, 16, 16, 4, generator=g).expand(2, -1, -1, -1)
    scfg = SampleConfig(steps=4)
    cpu = MagicPosePipeline(cfg, device="cpu")
    cpu.init_params(seed=3, scale=0.1)
    gpu = MagicPosePipeline(cfg, device="cuda")
    gpu.model.load_state_dict(cpu.model.state_dict())
    gpu.vae.load_state_dict(cpu.vae.state_dict())
    gpu.clip.load_state_dict(cpu.clip.state_dict())
    want = cpu.sample_frames(pose, ref, scfg, x_T=x_T)
    K.reset_launches()
    got = gpu.sample_frames(pose, ref, scfg, x_T=x_T).cpu()
    launches = dict(K.LAUNCHES)
    if launches["self_attention"] == 0 or launches["two_source_attention"] == 0:
        raise AssertionError(f"small reference run did not reach the kernels: {launches}")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    # fp32 throughout; CFG x7 over 4 steps amplifies summation-order
    # differences between the card (kernels, cuDNN) and the CPU (plain math)
    tol = 1e-4 * max(1.0, scale)
    if not (err <= tol and torch.isfinite(got).all()):
        raise AssertionError(f"card vs CPU reference: max abs err {err:.3e} > {tol:.3e}")
    log(f"  ok  narrow 128x128 4-step CFG-7 sample, card (kernels) vs CPU (plain): "
        f"max_abs_err={err:.3e} (tol {tol:.1e}, |out|max={scale:.3f}), launches {launches}")


# --------------------------------------------------------------------------
# phase 5: the main path
# --------------------------------------------------------------------------


def main_path(requests: int, frames: int, steps: int):
    import torch

    from magicdance_tpu_torch.config import ModelConfig, SampleConfig
    from magicdance_tpu_torch.ops import kernels as K
    from magicdance_tpu_torch.pipeline import MagicPosePipeline

    t0 = time.perf_counter()
    pipe = MagicPosePipeline(ModelConfig(), device="cuda")
    pipe.init_params(seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (pipe.model, pipe.vae, pipe.clip)
                   for p in m.parameters())
    log(f"  pipeline built, {n_params / 1e9:.3f} B parameters, seeded random "
        f"weights, {time.perf_counter() - t0:.1f} s")
    scfg = SampleConfig(steps=steps)
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = []
    for _ in range(requests):
        pose = torch.rand(frames, 512, 512, 3, generator=gen, device="cuda")
        ref = torch.rand(1, 512, 512, 3, generator=gen, device="cuda") * 2 - 1
        inputs.append((pose, ref))
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    secs = []
    for pose, ref in inputs:
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pipe.sample_frames(pose, ref, scfg, generator=gen)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        if tuple(out.shape) != (frames, 512, 512, 3) or not torch.isfinite(out).all():
            raise AssertionError(f"bad output {tuple(out.shape)}, finite="
                                 f"{bool(torch.isfinite(out).all())}")
    launches = dict(K.LAUNCHES)
    expect = {"self_attention": SELF_PER_STEP * steps * requests,
              "two_source_attention": TWO_SOURCE_PER_STEP * steps * requests}
    if launches != expect:
        raise AssertionError(f"kernel launches {launches}, expected {expect} "
                             f"({SELF_PER_STEP} + {TWO_SOURCE_PER_STEP} per DDIM step)")
    peak = torch.cuda.max_memory_allocated()
    log(f"  {requests} requests x {frames} frames, DDIM-{steps}, CFG {scfg.cfg_scale}: "
        f"seconds per request {[round(s, 3) for s in secs]}, frames/s "
        f"{[round(frames / s, 4) for s in secs]}, peak memory {peak / 2**30:.2f} GiB")
    log(f"  launches {launches} = {SELF_PER_STEP} self + {TWO_SOURCE_PER_STEP} "
        f"two-source per DDIM step")
    return pipe, dict(seconds_per_request=secs, frames=frames, steps=steps,
                      frames_per_s=[frames / s for s in secs], peak_bytes=peak,
                      launches=launches)


def host_enqueue_ms(fn) -> tuple[float, float]:
    """One call of fn() from an idle card: the host time until fn() returns
    (its launches enqueued) and until the card has finished. When the two
    are about equal the card waited on the host's launches."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3


def step_breakdown(pipe, frames: int):
    """Time of each piece of a request, on the main path's inputs: CLIP, VAE
    encode, the four passes of one DDIM step, VAE decode. `ms` is the CUDA
    event time of back-to-back calls (idle gaps left by a slow host
    included); `enqueue_ms` / `wall_ms` come from one call (host_enqueue_ms)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(5)
    m = pipe.model
    x = torch.randn(frames, 64, 64, 4, generator=gen, device="cuda")
    t = torch.full((frames,), 501, dtype=torch.int64, device="cuda")
    hint = torch.rand(frames, 512, 512, 3, generator=gen, device="cuda")
    ref = torch.rand(1, 512, 512, 3, generator=gen, device="cuda") * 2 - 1
    with torch.inference_mode():
        ctx = pipe.encode_empty(1).expand(frames, -1, -1)
        ref_lat = pipe.encode_reference(ref)
        bank = m.compute_bank(ref_lat, t[:1], ctx[:1])
        res = m.compute_control_residuals(x, hint, t, ctx)
        parts = {
            "clip": lambda: pipe.encode_empty(1),
            "vae_encode": lambda: pipe.encode_reference(ref),
            "bank_write": lambda: m.compute_bank(ref_lat, t[:1], ctx[:1]),
            "controlnet": lambda: m.compute_control_residuals(x, hint, t, ctx),
            "cond_read": lambda: m.unet(x, t, ctx, bank=bank, pose_residuals=res),
            "uncond": lambda: m(x, t, ctx, uc=True),
            "vae_decode": lambda: pipe.decode_latents(x),
        }
        ms = {k: cuda_time_ms(f, min_total_s=0.3, max_iters=20) for k, f in parts.items()}
        host = {k: host_enqueue_ms(f) for k, f in parts.items()}
    step = sum(ms[k] for k in ("bank_write", "controlnet", "cond_read", "uncond"))
    log("  " + ", ".join(f"{k}={v:.2f} ms" for k, v in ms.items())
        + f"; one DDIM step (four passes) {step:.2f} ms")
    log("  one call, host enqueue / wall: " + ", ".join(
        f"{k}={e:.2f}/{w:.2f} ms" for k, (e, w) in host.items()))
    return dict(ms, ddim_step=step, enqueue_ms={k: e for k, (e, _) in host.items()},
                wall_ms={k: w for k, (_, w) in host.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--report", default=None,
                    help="also write every measurement as JSON to this path")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from magicdance_tpu_torch.config import SampleConfig
        from magicdance_tpu_torch.ops.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script: {e}",
              file=sys.stderr)
        return 2

    frames, requests = 2, 2
    log("== phase 1: card")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  {card}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    # eager launches at B = 2 may leave the card waiting on the host, so the
    # host's model and load go beside every end-to-end time
    log(f"  host: {cpu_model()}, {os.cpu_count()} CPUs, load average "
        f"{' '.join(f'{x:.2f}' for x in os.getloadavg())}")
    log(f"  tf32 for every phase: cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")

    log("== phase 2: build")
    t0 = time.perf_counter()
    paths = build.build()
    log(f"  built {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for name in paths:
        text = build.build_log(name) or ""
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill", text))
        log(f"  {name}: {len(regs)} instantiations, registers per thread "
            f"{min(regs, default=0)}-{max(regs, default=0)}, spill bytes {spills}")

    log("== phase 3: kernels vs plain versions")
    rows, errs, ratios, checked = check_kernels(frames)

    log("== phase 4: small-input reference")
    small_reference_check()

    steps = SampleConfig().steps
    log(f"== phase 5: main path (full SD1.5 width, 512x512, DDIM-{steps})")
    pipe, e2e = main_path(requests, frames, steps)

    log("== phase 6: where one request's time goes (time per piece)")
    e2e["breakdown_ms"] = step_breakdown(pipe, frames)

    kernels = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]

        def per_step(key):
            return sum(r[key] * r["launches_per_step"] for r in mine)

        by = {}
        for r in mine:
            by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + r["bound_ms"] * r["launches_per_step"]
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            launches=e2e["launches"][name], max_abs_err=errs[name],
            ms=per_step("kernel_ms"), plain_ms=per_step("plain_ms"),
            bound_ms=per_step("bound_ms"),
            bound_by=max(by, key=by.get), library_ms=per_step("library_ms"),
            per="one DDIM step of the main path (sum over its launches)",
            max_err_over_rms=ratios[name],
            check=f"{checked[name]} shapes within tolerance"))
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(dict(card=card, shapes=rows, main_path=e2e, kernels=kernels), f,
                      indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
