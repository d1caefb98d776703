#!/usr/bin/env python3
"""Smoke run of the PyTorch port (magicdance_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, in order; every check raises, so any failure exits non-zero:
  1. card, torch and CUDA versions; TF32 off in cuBLAS and cuDNN for the
     whole run, so the compared (phases 3-4) and the timed (phases 5-6)
     configurations are the same; the pipeline also runs its fp32 work
     (VAE, CLIP) in full fp32 by itself.
  2. build the CUDA kernels from ops/kernels/csrc (one nvcc per source, all
     at once) and print the build time and the ptxas resource report, with
     the registers and spill bytes of each tensor-core instantiation (the
     bf16 bodies of kernels A, B, B gated and K9: `md::tc::attention_tc`;
     of C: `attention_dq_tc`; of D: `attention_dkv_tc`; of G's forward:
     `grouped_tc`; of G's backward: `grouped_bwd_tc`), of K8's two kernels
     (`md::gn::gn_stats`, `gn_apply`) and the CUDA-core instantiations by
     type (none in bf16 for A, B, C, D and G, forward and backward); G's
     backward must not spill at the full-width motion widths (D = 40, 80,
     160 at BN = 16).
  2b. the kernel gate (`ops/kernel_gate.py::run_gate`, before any timed
     phase): every case of the JAX gate and the main path's shapes at H = 8
     (D = 40, 80, 160, batch-1 banks, the gated read, G at (4096, 16, 40)),
     forward and gradients, and K8 at (2, 4096, 320), through the port's
     dispatch against fp32 reference math; each check's deviation, the
     gate's wall time and its launches (every kernel must be reached).
  3. hold each kernel against its plain PyTorch version at every shape the
     main path gives it (kernels A and B run their tensor-core body in bf16
     and their CUDA-core body in fp32) (bf16: max-abs <= min(5e-2, 0.1 x the
     RMS of the plain output), since these outputs are far below O(1); fp32:
     max-abs <= 2e-4), plus a
     BSNH-strided, a ragged and a separate-bank-batch case, and kernel B at
     the video path's bank reads (16 frames, bank batch 1, bf16; the plain
     version run two frames at a time); time kernel,
     plain version, the library call (F.scaled_dot_product_attention, a
     yardstick only) and the bound max(FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s);
     kernel, plain and library times are device time, the timed calls
     queued behind a sleep kernel so that the host's launch rate does not
     enter them (`utils.timing.device_time_ms`).
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
  7. the training kernels against their plain versions at every attention
     shape of the full-width stage-2 training step at B = 2, 512x512: the
     forward with LSE (kernels A/B) and kernels C (dQ) and D (dK/dV), for
     self-attention and bank reads with bank batch 2, in bf16 and fp32, plus
     a batch-1 bank (frame-summed dK/dV), a ragged and a BSNH-strided case;
     then C (two sources, a batch-1 bank) and D (self source) at every
     (16, S, 8, D) of the stage-3 step (4 / 5 / 5 launches per step at S =
     4096 / 1024 / 256), bf16, the plain versions run two frames at a time.
     Gates: o and LSE as phase 3; gradients fp32 <= 2e-4 x max(1, max
     |plain|), bf16 <= min(1e-1, 0.1 x the RMS of the plain gradient).
     Times kernel, plain version, library call (the backward of
     F.scaled_dot_product_attention through torch.autograd.grad, K/V
     concatenated for two sources; a yardstick only) and the bound, with the
     operations each kernel does: 4, 6 and 8 x Sq x Skv x D per (batch, head,
     source) for the forward, dQ and dK/dV.
  8. small-input training reference: one narrow stage-2 train step at
     128x128 (S = 256 reaches the kernels) on the card and on the CPU from
     the same weights, batch and draws (fp32): loss, every trainable
     gradient and the parameters after two steps agree, and every training
     kernel ran exactly as often as the launch plan says.
  9. the training path at full SD1.5 width: Trainer on the stage-2 preset
     (bf16 denoiser, remat on, frozen weights in bf16), seeded random
     weights, synthetic seeded batches of B = 2 at 512x512, warm-up 1, 4
     steps: finite losses, frozen weights bit-identical, trainable weights
     moved, and in every step exactly the launches the plan derives (printed
     with its formula); seconds per step, images/s, peak memory, and one
     step's split into encode, forward, backward and optimizer.
  10. the grouped (temporal) kernel G, forward and backward (dq, dk, dv),
     against its plain versions at every full-width motion-module shape of a
     16-frame window at 512x512 ((h*w, 16, C) for C = 320, 640, 1280, 1280;
     bf16, timed against its bound and F.scaled_dot_product_attention on
     (h*w, H, 16, D) as the yardstick), one shape in fp32, one frame per clip
     (S = 1) and a two-window batch; gates as phases 3 and 7; the bf16
     backward runs twice at the first motion shape and must give the same
     bits. In bf16 the forward and the backward run on the tensor cores
     (`grouped_tc`, `grouped_bwd_tc`), in fp32 on the CUDA cores.
  11. small-input video references on a narrow temporal model at 128x128:
     overlap sampling of F = 10 frames in windows of 4, stride 3, 3 steps of
     CFG 7, on the card (kernels A, B, G) and the CPU (plain versions) with
     the same weights, x_T and window offsets; and one stage-3 train step,
     card vs CPU; both held to their exact launch plans.
  12. the video path at full SD1.5 width with the 20 AnimateDiff motion
     modules: two requests of 16 pose maps at 512x512 through
     `sample_frames(video=True)` (one 16-frame window, default SampleConfig),
     finite (16, 512, 512, 3) outputs and exactly 36 self-attention + 15
     two-source + 80 grouped launches per DDIM step (`serving_launch_plan`);
     seconds per request, frames/s, peak memory, and one DDIM step's split.
  13. stage-3 training at full SD1.5 width: the stage3_motion() preset, one
     clip of 16 frames at 512x512 per step, remat on, 3 steps: finite losses,
     frozen weights bit-identical, motion modules moved, every step exactly
     the launches of `stage3_launch_plan`; s/step, clips/s, peak memory and
     the encode / forward / backward / optimizer split.
  14. kernel B's gated mode (fused CFG) against its plain version at every
     fused-CFG shape ((2F, S, 8, D) for (S, D) = (4096, 40), (1024, 80),
     (256, 160), a batch-1 bank, cond gates 1 and uncond gates 0, and one
     case with gates of 0.5), kernels A and B at the pooled self-key lengths
     of the turbo stacks (S_k = 1024 and 256 at S = 4096), and K8 (fused
     GroupNorm+SiLU: a statistics kernel over row chunks in clusters of 8,
     then the apply kernel) at every (B, HW >= 256, C) where the appearance
     UNet, the ControlNet and the main UNet call it, read from the model by
     forward hooks, and at the 16-frame video request's first level (16,
     4096, 320); each K8 case runs twice and must give the same bits; bf16
     timed against the bound, the plain version and the library call (SDPA
     over the concatenated keys with a boolean mask hiding the bank from
     gate-0 rows; F.group_norm then F.silu).
  15. narrow models at 128x128, card vs CPU in fp32, each held to its launch
     plan: a fused-CFG sample, bench.py's `turbo` and `turbo_max` stacks, the
     `turbo` stack through the overlap sampler (temporal model), and an exact
     sample with MAGICDANCE_FUSED_GN=1.
  16. full SD1.5 width, 2 requests x F = 2 at 512x512 each, in turns: the
     exact recipe, fused_cfg=True (DDIM-50), MAGICDANCE_FUSED_GN=1 (DDIM-50),
     the `turbo` stack (DDIM-50), `turbo_max` (DDIM-20), the exact recipe
     again; every request held to its launch plan (`request_launch_plan`,
     from the sampler's own host masks); seconds per request, frames/s and
     peak memory, beside phase 5's exact requests.
  17. the temporal model at full width, 2 requests x 16 frames at 512x512,
     one window, DDIM-50, under the `turbo` stack, held to its launch plan,
     beside phase 12's exact video requests.
  18. the head-packing probe and kernel K9: K9 against its plain version at
     the probe's shape (BG 64, S 4096, G 3, D 40, block-diagonal K/V from
     random heads) and a small ragged shape (random K/V), bf16 and fp32,
     timed against its bound, the plain version and the library call (SDPA
     on the unpacked per-head tensors); kernel A against its plain version
     on the same unpacked tensors (BSNH 32, 4096, 6, 40, bf16 and fp32),
     the shape P3 gives it; then the probe itself
     (`magicdance_tpu_torch.scripts.bench_head_packing`, P1-P4) as the
     slice's path, with the counts at 0 before it: P3 runs K9 and kernel A
     at (32, 4096, 6, 40) BSNH and their outputs must agree.
  19. DUAL_CONTROL image serving (the pose and an image ControlNet, no
     appearance branch): a narrow model at 128x128 sampled on the card and
     the CPU from the same weights (fp32, held to its launch plan); then at
     full SD1.5 width, 2 requests x F = 2 at 512x512 with image hints,
     DDIM-50, CFG 7, exact then under the `turbo` stack (the `pose_every`
     cache holds both ControlNets' summed residuals), every request held to
     `request_launch_plan` (no bank, so kernel A only: two ControlNets of 6
     sites, the cond and uncond passes of 15, per exact step).
  20. the PLMS, DPM-Solver++ 2M and 3M (SDE, sde_eta = 1) samplers at full
     width (APPEARANCE_POSE), one request of F = 2 at 512x512 each, 25
     steps, CFG 7, composed as a user does (the pipeline's CLIP and VAE, the
     sampler, the decode): finite images, two model calls and one bank write
     per step and the exact DDIM step's launches per step; seconds per
     request.
  21. one exact image DDIM step profiled with `utils/profiling.trace`
     (torch.profiler, CPU and CUDA activity): the ten device operations
     with the most total time and their counts, the Chrome trace written to
     chiprun_out/profile/ddim_step.json.
  22. a reference checkpoint through the sampling CLI at full SD1.5 width:
     a seeded state dict in the reference's current key layout
     (`convert.torch_convert.reference_key_map(ModelConfig())`, one draw per
     key at its reference shape) saved as an fp16 `.th` under chiprun_out/
     (deleted at the end); `cli.sample.build_pipeline` with `--checkpoint`
     it: every loaded parameter bit-equal to its drawn tensor cast to the
     parameter's dtype; one request through `cli.sample.generate` on numpy
     inputs (a seeded uint8 reference, F = 2 pose maps, 512x512, DDIM-50,
     CFG 7) held to `request_launch_plan` and to uint8 frames from finite
     images; then `--video` without a checkpoint (16 frames, one window,
     DDIM-10) held to the video plan (kernels A, B and G); the file's
     bytes, the seconds to save, to load and convert and of each request,
     and the peak memory, with the card's name and power limit.
  23. OpenPose: the body, hand and face nets (`models.openpose`, plain
     convolutions and max-pools, no hand kernel) from seeded state dicts in
     the reference checkpoints' key layouts through the port's converters,
     on the card and on the CPU at the detector's inputs (368x368: a 512x512
     frame resized to BOXSIZE and padded to stride 8; a hand or face ROI),
     fp32, held to 2e-4 x max(1, max|CPU|); each net's milliseconds on the
     card; with cv2 installed, the whole `OpenposeDetector` on one seeded
     512x512 frame on both devices (equal keypoint counts) and its
     milliseconds per frame.
  24. evaluation: a seeded TikTok-layout tree (2 videos, each a reference and
     8 targets at 512x512) through `cli.eval.main` at full SD1.5 width with
     random weights, DDIM-50, CFG 7, --batch 8 (one F = 8 request a video),
     the launches held to the request plan, seconds per request and
     frames/s; `metrics.center.get_all_eval_scores` on the written tree with
     every type (l1 mae ssim psnr lpips fid fid-img is fvd fid-vid) through
     seeded full-width reference-layout files (LPIPS VGG16, torchvision
     InceptionV3, I3D, 3D-ResNet50), FID-Img with 2 frames a video, the CLIP
     ViT-L/14 image similarity: finite, SSIM in [0, 1], fid-img = fid, and
     fid-img moved by the frame sampling; each metric net card vs CPU at one
     batch of the drivers' inputs, fp32, held to 2e-4 x max(1, max|CPU|),
     its ms per call, FLOPs from the layer shapes and share of the fp32
     peak; SSIM <= 1 on the card with TF32 allowed outside the metric. The
     files (about 1.6 GB, under chiprun_out/) are deleted at the end.
  Then the `kernels` JSON line (the six kernels of phases 3-13, kernel B's
  gated mode, K8 and K9, launches by path, and each kernel's `body`: the
  device functions that run it in bf16 and fp32; kernel B's entry also sums
  its 16-frame rows per video DDIM step, C's and D's their stage-3 rows per
  stage-3 step, K8's holds its video site), the card line, the result line.

Exits non-zero without a result when torch.cuda.is_available() is false or
the port's package is not beside this script.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

BF16_TOL = 5e-2  # magicdance_tpu/ops/kernel_gate.py:52
# bf16 is also held to a tenth of the plain output's RMS: with randn q/k/v
# the outputs are ~sqrt(e / S_kv) (0.02-0.1), so 5e-2 alone would pass a
# kernel whose error is the size of its output
BF16_REL_TOL = 0.1
FP32_TOL = 2e-4
GRAD_BF16_TOL = 1e-1  # magicdance_tpu/ops/kernel_gate.py:52 (gradients)
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
# exponentials per second: 16 MUFU ex2 results per SM per clock, 132 SMs at
# the 1980 MHz boost clock; the floor of attention at D = 40
PEAK_EXP = 132 * 16 * 1.98e9

KERNELS = {
    "self_attention": dict(
        source="magicdance_tpu_torch/ops/kernels/csrc/self_attention.cu",
        replaces="magicdance_tpu/ops/pallas/flash.py:286 (_attn_kernel_fused); "
                 "magicdance_tpu/ops/pallas/flash.py:76 (_attn_kernel); "
                 "magicdance_tpu/ops/pallas/flash_vjp.py:71 (_fwd_lse_kernel)",
        body="bf16: md::tc::attention_tc (tensor cores, mma.sync); fp32: md::attention_fwd (CUDA "
             "cores)",
        modes=("self_attention", "self_attention_lse")),
    "two_source_attention": dict(
        source="magicdance_tpu_torch/ops/kernels/csrc/two_source_attention.cu",
        replaces="magicdance_tpu/ops/pallas/flash.py:308 (_attn2_kernel_fused); "
                 "magicdance_tpu/ops/pallas/flash.py:97 (_attn2_kernel_nomask); "
                 "magicdance_tpu/ops/pallas/flash_vjp.py:89 (_fwd2_lse_kernel)",
        body="bf16: md::tc::attention_tc (tensor cores, mma.sync); fp32: md::attention_fwd (CUDA "
             "cores)",
        modes=("two_source_attention", "two_source_attention_lse")),
    "attention_dq": dict(
        source="magicdance_tpu_torch/ops/kernels/csrc/attention_dq.cu",
        replaces="magicdance_tpu/ops/pallas/flash_vjp.py:129 (_dq_kernel); "
                 "magicdance_tpu/ops/pallas/flash_vjp.py:153 (_dq2_kernel)",
        body="bf16: md::tc::attention_dq_tc (tensor cores, mma.sync); fp32: md::attention_dq (CUDA "
             "cores)",
        modes=("attention_dq", "attention_dq_two_source")),
    "attention_dkv": dict(
        source="magicdance_tpu_torch/ops/kernels/csrc/attention_dkv.cu",
        replaces="magicdance_tpu/ops/pallas/flash_vjp.py:202 (_dkv_kernel)",
        body="bf16: md::tc::attention_dkv_tc (tensor cores, mma.sync); fp32: md::attention_dkv "
             "(CUDA cores)",
        modes=("attention_dkv",)),
    "grouped_attention": dict(
        source="magicdance_tpu_torch/ops/kernels/csrc/grouped_attention.cu",
        replaces="magicdance_tpu/ops/pallas/flash.py:366 (_grouped_attn_kernel)",
        body="bf16: md::tc::grouped_tc (tensor cores, mma.sync, several (sequence, head) pairs a "
             "block); fp32: md::grouped::grouped_fwd (CUDA cores)",
        modes=("grouped",)),
    "grouped_attention_bwd": dict(
        source="magicdance_tpu_torch/ops/kernels/csrc/grouped_attention_bwd.cu",
        replaces="magicdance_tpu/ops/pallas/flash_vjp.py:230 (_grouped_bwd_kernel)",
        body="bf16: md::tc::grouped_bwd_tc (tensor cores, mma.sync, several (sequence, head) "
             "pairs a block, a row pass then a key pass); fp32: md::grouped::grouped_bwd (CUDA "
             "cores)",
        modes=("grouped_bwd",)),
    "two_source_attention_gated": dict(
        source="magicdance_tpu_torch/ops/kernels/csrc/two_source_attention.cu",
        replaces="magicdance_tpu/ops/pallas/flash.py:135 (_attn2_kernel)",
        body="bf16: md::tc::attention_tc GATED (tensor cores, mma.sync); fp32: md::attention_fwd "
             "(CUDA cores)",
        modes=("two_source_attention_gated",)),
    "groupnorm_silu": dict(
        source="magicdance_tpu_torch/ops/kernels/csrc/groupnorm_silu.cu",
        replaces="magicdance_tpu/ops/pallas/groupnorm.py:31 (_gn_silu_kernel)",
        body="md::gn::gn_stats (row chunks in clusters of 8, distributed shared memory) then "
             "md::gn::gn_apply (programmatic dependent launch), 16-byte pieces, both types",
        modes=("groupnorm_silu",)),
    "packed_attention": dict(
        source="magicdance_tpu_torch/ops/kernels/csrc/packed_attention.cu",
        replaces="scripts/bench_head_packing.py:97 (_packed_kernel)",
        body="bf16: md::tc::attention_tc PACKED (tensor cores, mma.sync); fp32: its own CUDA-core "
             "body",
        modes=("packed_attention",)),
}
TRAIN_MODES = ("self_attention_lse", "two_source_attention_lse", "attention_dq",
               "attention_dq_two_source", "attention_dkv")
SELF_PER_STEP = 36
TWO_SOURCE_PER_STEP = 15


def log(msg: str) -> None:
    print(msg, flush=True)


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


def exp_bound_ms(b, sq, h, kv) -> float:
    """Least time of the exponentials alone: one per logit, b x h x sq x
    the keys of every source, over PEAK_EXP."""
    return b * h * sq * sum(sk for _, sk in kv) / PEAK_EXP * 1e3


TC_MODES = {"0": " (kernel A)", "1": " (kernel B)", "2": " (kernel B gated)", "3": " (K9)"}


def _entry_chunks(log_text: str):
    """(mangled name, registers, spill bytes) of each entry function in a
    ptxas -v report."""
    for chunk in log_text.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", chunk)
        yield (chunk.split("'", 1)[0], int(regs.group(1)) if regs else -1,
               sum(int(w) for w in re.findall(r"(\d+) bytes spill", chunk)))


def tc_instantiations(log_text: str) -> list[tuple[str, int, int]]:
    """(kernel<template arguments> (its kernel), registers, spill bytes) of
    each tensor-core entry function in a ptxas -v report: attention_tc<KD,
    NO, MR, BN, mode> (mode: md::tc::Mode), attention_dq_tc (kernel C; the
    fifth argument is its number of sources), attention_dkv_tc (kernel D)
    and grouped_tc / grouped_bwd_tc<KD, NO, BN> (kernel G's bf16 forward
    and backward)."""
    out = []
    for name, regs, spill in _entry_chunks(log_text):
        m = re.match(r"_ZN2md2tc\d+(\w+?_tc)I((?:Li\d+E)+)E", name)
        if not m:
            continue
        args = re.findall(r"Li(\d+)E", m.group(2))
        which = {"attention_tc": TC_MODES.get(args[4], "") if len(args) == 5 else "",
                 "attention_dq_tc": f" (kernel C, {args[-1]} source(s))",
                 "attention_dkv_tc": " (kernel D)",
                 "grouped_tc": " (kernel G forward)",
                 "grouped_bwd_tc": " (kernel G backward)"}.get(m.group(1), "")
        names = (("KD", "NO", "BN") if m.group(1).startswith("grouped")
                 else ("KD", "NO", "MR", "BN"))
        params = ", ".join(f"{k}={v}" for k, v in zip(names, args))
        out.append((f"{m.group(1)}<{params}>{which}", regs, spill))
    return out


def gn_instantiations(log_text: str) -> list[tuple[str, int, int]]:
    """(gn_stats or gn_apply<type, VEC>, registers, spill bytes) of K8's
    entry functions (md::gn) in a ptxas -v report."""
    out = []
    for name, regs, spill in _entry_chunks(log_text):
        m = re.match(r"_ZN2md2gn\d+(gn_\w+?)I(f|13__nv_bfloat16)Li(\d+)E", name)
        if m:
            dtype = "fp32" if m.group(2) == "f" else "bf16"
            out.append((f"{m.group(1)}<{dtype}, VEC={m.group(3)}> (K8)", regs, spill))
    return out


# the CUDA-core bodies of kernels A/B (attention_fwd), C, D and G
# (grouped::grouped_fwd, grouped::grouped_bwd), by library
CUDA_CORE_BODIES = {"self_attention": "attention_fwd", "two_source_attention": "attention_fwd",
                    "attention_dq": "attention_dq", "attention_dkv": "attention_dkv",
                    "grouped_attention": "grouped::grouped_fwd",
                    "grouped_attention_bwd": "grouped::grouped_bwd"}
# G's backward at the full-width motion widths (D = 40, 80, 160; BN = 16):
# ptxas must report no spills there
G_BWD_FULL_WIDTH = ("grouped_bwd_tc<KD=3, NO=5, BN=16>", "grouped_bwd_tc<KD=5, NO=10, BN=16>",
                    "grouped_bwd_tc<KD=10, NO=20, BN=16>")


def cuda_core_instantiations(log_text: str, body: str) -> dict[str, int]:
    """Instantiations of one CUDA-core body (md::<body>, `::` for a nested
    namespace) in a ptxas -v report, by element type."""
    mangled = "".join(f"{len(part)}{part}" for part in body.split("::"))
    types = re.findall(rf"Compiling entry function '_ZN2md{mangled}I(f|13__nv_bfloat16)",
                       log_text)
    return {"fp32": types.count("f"), "bf16": types.count("13__nv_bfloat16")}


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
    from magicdance_tpu_torch.utils.timing import device_time_ms

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
            ms = device_time_ms(lambda: kern(*args))
            plain_ms = device_time_ms(lambda: plain(*args), min_total_s=0.1, max_iters=5)
            qh = q.transpose(1, 2)
            if name == "self_attention":
                kh, vh = k.transpose(1, 2), v.transpose(1, 2)
            else:
                kh = torch.cat([k, kb.expand(b, -1, -1, -1)], dim=1).transpose(1, 2)
                vh = torch.cat([v, vb.expand(b, -1, -1, -1)], dim=1).transpose(1, 2)
            lib_ms = device_time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
            bound, bound_by = attention_bound_ms(b, s, heads, d, kv)
            exp_ms = exp_bound_ms(b, s, heads, kv)
            rows.append(dict(kernel=name, B=b, S=s, D=d, H=heads, bank_batch=bb,
                             launches_per_step=per_step, kernel_ms=ms,
                             plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                             bound_by=bound_by, exp_bound_ms=exp_ms))
            log(f"      kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={lib_ms:.4f} bound_ms={bound:.4f} ({bound_by}) "
                f"exp_bound_ms={exp_ms:.4f}")
            del q, k, v, args
            torch.cuda.empty_cache()

    # two-source attention with a per-frame bank (bank batch B)
    for s, d in ((4096, 40), (1024, 80), (256, 160)):
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            q, k, v, kb, vb = (rnd(frames, s, heads, d, dtype=dtype) for _ in range(5))
            check("two_source_attention", K.two_source_attention(q, k, v, kb, vb),
                  K.two_source_attention_ref(q, k, v, kb, vb), tol,
                  f"{str(dtype)[6:]} B={frames} S={s} D={d} bank_batch={frames}")

    # the video serving path's bank reads: 16 frames and a batch-1 bank, 5
    # launches per video DDIM step at each site. The plain version runs two
    # frames at a time: one call at 16 x 4096 would hold tens of GiB of
    # logits, and under a batch-1 bank the frames are independent.
    vframes, chunk = 16, 2
    for s, d in ((4096, 40), (1024, 80), (256, 160)):
        q, k, v = (rnd(vframes, s, heads, d, dtype=torch.bfloat16) for _ in range(3))
        kb, vb = (rnd(1, s, heads, d, dtype=torch.bfloat16) for _ in range(2))
        args = (q, k, v, kb, vb)

        def plain_by_frames():
            return torch.cat([K.two_source_attention_ref(q[i:i + chunk], k[i:i + chunk],
                                                         v[i:i + chunk], kb, vb)
                              for i in range(0, vframes, chunk)])

        check("two_source_attention", K.two_source_attention(*args), plain_by_frames(),
              BF16_TOL, f"bfloat16 video B={vframes} S={s} D={d} bank_batch=1")
        ms = device_time_ms(lambda: K.two_source_attention(*args))
        plain_ms = device_time_ms(plain_by_frames, min_total_s=0.1, max_iters=3)
        qh = q.transpose(1, 2)
        kh = torch.cat([k, kb.expand(vframes, -1, -1, -1)], dim=1).transpose(1, 2)
        vh = torch.cat([v, vb.expand(vframes, -1, -1, -1)], dim=1).transpose(1, 2)
        lib_ms = device_time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
        kv = [(vframes, s), (1, s)]
        bound, bound_by = attention_bound_ms(vframes, s, heads, d, kv)
        exp_ms = exp_bound_ms(vframes, s, heads, kv)
        rows.append(dict(kernel="two_source_attention", path="video serving", B=vframes, S=s,
                         D=d, H=heads, bank_batch=1, launches_per_step=5, kernel_ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                         bound_by=bound_by, exp_bound_ms=exp_ms))
        log(f"      kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} (by {chunk} frames) "
            f"library_ms={lib_ms:.4f} bound_ms={bound:.4f} ({bound_by}) "
            f"exp_bound_ms={exp_ms:.4f} x5/video step")
        del q, k, v, kb, vb, args, kh, vh
        torch.cuda.empty_cache()

    # layouts and edges the main path does not show: a BSNH view of a
    # (B, H, S, D) tensor, a ragged length, a per-frame bank of another length
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
        tag = str(dtype)[6:]
        q, k, v = (rnd(2, heads, 1024, 80, dtype=dtype).transpose(1, 2) for _ in range(3))
        check("self_attention", K.self_attention(q, k, v),
              K.self_attention_ref(q, k, v), tol, f"{tag} BSNH-strided B=2 S=1024 D=80")
        if dtype == torch.bfloat16:  # flash.py::_attn_kernel's layout, off the main path
            ms = device_time_ms(lambda: K.self_attention(q, k, v))
            plain_ms = device_time_ms(lambda: K.self_attention_ref(q, k, v),
                                      min_total_s=0.1, max_iters=5)
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            lib_ms = device_time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
            bound, bound_by = attention_bound_ms(2, 1024, heads, 80, [(2, 1024)])
            rows.append(dict(kernel="self_attention", B=2, S=1024, D=80, H=heads,
                             bank_batch=None, layout="BSNH-strided", launches_per_step=0,
                             kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=bound, bound_by=bound_by,
                             exp_bound_ms=exp_bound_ms(2, 1024, heads, [(2, 1024)])))
            log(f"      BSNH-strided: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={lib_ms:.4f} bound_ms={bound:.4f} ({bound_by})")
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

    from magicdance_tpu_torch.config import SampleConfig
    from magicdance_tpu_torch.ops import kernels as K
    from magicdance_tpu_torch.pipeline import MagicPosePipeline

    cfg = narrow_model_config()
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
    expect = {**{mode: 0 for mode in K.LAUNCHES},
              "self_attention": SELF_PER_STEP * steps * requests,
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


def step_breakdown(pipe, frames: int, num_frames: int = 1):
    """Time of each piece of a request, on the main path's inputs: CLIP, VAE
    encode, the four passes of one DDIM step, VAE decode. `ms` is the CUDA
    event time of back-to-back calls (idle gaps left by a slow host
    included); `enqueue_ms` / `wall_ms` come from one call (host_enqueue_ms).
    `num_frames`: frames per clip of the motion modules (a video window)."""
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
            "cond_read": lambda: m.unet(x, t, ctx, bank=bank, pose_residuals=res,
                                        num_frames=num_frames),
            "uncond": lambda: m(x, t, ctx, uc=True, num_frames=num_frames),
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


# --------------------------------------------------------------------------
# phases 7-9: the training path
# --------------------------------------------------------------------------


def training_bound_ms(mode, b, sq, h, d, kv, itemsize=2) -> tuple[float, str]:
    """Least time of one training-kernel launch: the operations the kernel
    does (4, 6 or 8 x Sq x Skv x D per batch, head and source for the LSE
    forward, dQ and dK/dV) over the bf16 peak vs each input read and each
    output written once over the memory rate. kv: (batch, length) per K/V
    source (one source for dK/dV); lse/delta rows are fp32."""
    per = {"lse": 4.0, "dq": 6.0, "dkv": 8.0}[mode]
    flops = sum(per * b * h * sq * sk * d for _, sk in kv)
    rows_f32 = 4 * b * h * sq * (1 if mode == "lse" else 2)
    q_side = {"lse": 2, "dq": 3, "dkv": 2}[mode]   # q+o | q+dO+dQ | q+dO
    kv_side = 4 if mode == "dkv" else 2            # k+v (+dK+dV)
    nbytes = itemsize * h * d * (q_side * b * sq + sum(kv_side * bb * sk for bb, sk in kv))
    t_ops, t_mem = flops / PEAK_BF16_FLOPS * 1e3, (nbytes + rows_f32) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def training_sites(model_cfg, latent: int):
    """(network, S, D) of every self-attention site of the stage-2 step in
    traversal order: appearance UNet, pose ControlNet (encoder and middle),
    main UNet."""
    from magicdance_tpu_torch.models.controlnet import controlnet_unet_config
    from magicdance_tpu_torch.models.magicpose import appearance_unet_config

    def sites(net, ucfg, decoder=True):
        return [(net, s, d) for kind, s, d in unet_sites(ucfg, latent, decoder)
                if kind == "spatial"]

    return (sites("appearance", appearance_unet_config(model_cfg))
            + sites("controlnet", controlnet_unet_config(model_cfg.pose_control,
                                                         model_cfg.unet.in_channels),
                    decoder=False)
            + sites("main", model_cfg.unet))


def training_launch_plan(model_cfg, latent: int):
    """Launches of each training kernel mode in one stage-2 train step (main
    UNet frozen, remat on), by (mode, S, D), and the formula. A site reaches
    a kernel when S_q >= 256 (ops.attention). Every kernel site runs its
    forward twice (the step, then remat's recompute). The appearance UNet's
    last site feeds nothing the loss reads (its bank entry is taken before
    the attention), so autograd runs no backward there. In the frozen main
    UNet only the bank needs a gradient at the first site (its input is the
    noisy latent through frozen weights), so it launches dK/dV for the bank
    source alone; every later site's input depends on an earlier bank read,
    so it also launches dQ and the self source's dK/dV."""
    from collections import Counter

    sites = training_sites(model_cfg, latent)
    kern = [x for x in sites if x[1] >= 256 and x[2] <= 256]
    app = [x for x in kern if x[0] == "appearance"]
    cn = [x for x in kern if x[0] == "controlnet"]
    main = [x for x in kern if x[0] == "main"]
    first_main = [x for x in sites if x[0] == "main"][0]
    main_q = main[1:] if main and main[0] is first_main else main
    last_app = [x for x in sites if x[0] == "appearance"][-1]
    app_bwd = app[:-1] if app and app[-1] is last_app else app
    plan = Counter()
    for _, s, d in app + cn:
        plan["self_attention_lse", s, d] += 2
    for _, s, d in main:
        plan["two_source_attention_lse", s, d] += 2
        plan["attention_dkv", s, d] += 1  # bank source
    for _, s, d in app_bwd + cn:
        plan["attention_dq", s, d] += 1
        plan["attention_dkv", s, d] += 1
    for _, s, d in main_q:
        plan["attention_dq_two_source", s, d] += 1
        plan["attention_dkv", s, d] += 1  # self source
    totals = {m: sum(n for (mode, _, _), n in plan.items() if mode == m) for m in TRAIN_MODES}
    formula = {
        "self_attention_lse": f"2 x ({len(app)} appearance + {len(cn)} ControlNet "
                              f"self-attention sites) = {totals['self_attention_lse']}",
        "two_source_attention_lse": f"2 x {len(main)} bank-read sites = "
                                    f"{totals['two_source_attention_lse']}",
        "attention_dq": f"{len(app_bwd)} appearance (all but the last) + {len(cn)} "
                        f"ControlNet = {totals['attention_dq']}",
        "attention_dq_two_source": f"{len(main_q)} bank-read sites (all but the "
                                   f"main UNet's first) = "
                                   f"{totals['attention_dq_two_source']}",
        "attention_dkv": f"{len(app_bwd)} appearance + {len(cn)} ControlNet + "
                         f"{len(main_q)} main self sources + {len(main)} bank "
                         f"sources = {totals['attention_dkv']}",
    }
    return plan, totals, formula


def unet_sites(ucfg, latent: int, decoder: bool = True):
    """The attention sites of one UNet pass in traversal order: ("spatial",
    S, D) per transformer block's self-attention (its cross-attention over
    the context never reaches a kernel) and ("motion", h*w, C) per motion
    module."""
    from magicdance_tpu_torch.models.unet import decoder_plan, unet_plan

    units, _, ds_mid = unet_plan(ucfg)
    out = []

    def spatial(ds, ch):
        out.extend([("spatial", (latent // ds) ** 2, ch // ucfg.num_heads)]
                   * ucfg.transformer_depth)

    def motion(ds, ch):
        if ucfg.use_motion_modules:
            out.append(("motion", (latent // ds) ** 2, ch))

    for u in units:
        if u["kind"] == "res":
            if u["attn"]:
                spatial(u["ds"], u["ch"])
            motion(u["ds"], u["ch"])
    spatial(ds_mid, ucfg.model_channels * ucfg.channel_mult[-1])
    if decoder:
        for u in decoder_plan(ucfg):
            if u["attn"]:
                spatial(u["ds"], u["ch"])
            motion(u["ds"], u["ch"])
    return out


def _self_mode(s: int, d: int, batch: int):
    """The kernel a self-attention site without a gradient launches, or None
    (ops.attention's dispatch)."""
    from magicdance_tpu_torch.ops.attention import _grouped_site, _kernel_site

    if _grouped_site(s, s, d, batch):
        return "grouped"
    return "self_attention" if _kernel_site(s, s, d) else None


def _motion_launches(ucfg, hw: int, ch: int, clips: int, frames: int) -> int:
    """Grouped-kernel launches of one forward of one motion module: one per
    attention unit when the unit is a grouped site (clips*h*w sequences of
    `frames` rows), else none."""
    from magicdance_tpu_torch.ops.attention import _grouped_site

    n = ucfg.motion_layers * ucfg.motion_attn_blocks
    return n if _grouped_site(frames, frames, ch // ucfg.motion_num_heads, clips * hw) else 0


def _vae_launches(vae_cfg, latent: int, calls: int) -> dict:
    """Kernel A launches of `calls` VAE encodes or decodes: the one
    single-head mid attention over the latent grid."""
    from magicdance_tpu_torch.ops.attention import _kernel_site

    s, d = latent ** 2, vae_cfg.base_channels * vae_cfg.channel_mult[-1]
    return {"self_attention": calls} if _kernel_site(s, s, d) else {}


def serving_launch_plan(model_cfg, latent: int, batch: int, frames: int) -> dict:
    """Kernel launches of one DDIM step of the exact samplers (the image
    sampler with frames = 1, the overlap sampler with frames = the window):
    the appearance write pass on the batch-1 reference, the ControlNet, the
    main UNet's cond pass reading the bank and its uncond pass, each on
    `batch` frames (clips of `frames`)."""
    from magicdance_tpu_torch.config import SampleConfig

    return request_launch_plan(model_cfg, latent, batch, SampleConfig(steps=1),
                               frames=frames, video=frames > 1)


def pass_sites(ucfg, latent: int, decoder: bool = True, shallow_level=None,
               pool_mid: bool = True):
    """The sites of one UNet (or, decoder=False, ControlNet) pass in
    traversal order: ("gn", hw, C) per GroupNorm+SiLU (each ResBlock's two
    norms, the UNet's output norm), ("spatial", S, D, poolable) per
    transformer block's self-attention, ("motion", hw, C) per motion module.
    `shallow_level`: the DeepCache shallow pass over levels 0..shallow_level
    (models/unet.py). `pool_mid`: whether the middle block's self keys may
    be pooled (the UNet's may, the ControlNet's never, as in JAX)."""
    from magicdance_tpu_torch.models.unet import decoder_plan, unet_plan

    units, skip_ch, ds_mid = unet_plan(ucfg)
    out = []
    shallow = shallow_level is not None

    def hw(ds):
        return (latent // ds) ** 2

    def spatial(ds, ch, poolable=True):
        out.extend([("spatial", hw(ds), ch // ucfg.num_heads, poolable)]
                   * ucfg.transformer_depth)

    def res(ds, cin, cout):
        out.extend([("gn", hw(ds), cin), ("gn", hw(ds), cout)])

    ch = ucfg.model_channels
    for u in units:
        if shallow and (u["level"] > shallow_level
                        or (u["kind"] == "down" and u["level"] == shallow_level)):
            break
        if u["kind"] == "res":
            res(u["ds"], ch, u["ch"])
            ch = u["ch"]
            if u["attn"]:
                spatial(u["ds"], ch)
            if ucfg.use_motion_modules:
                out.append(("motion", hw(u["ds"]), ch))
    mid_ch = ucfg.model_channels * ucfg.channel_mult[-1]
    if not shallow:
        res(ds_mid, ch, mid_ch)
        spatial(ds_mid, mid_ch, pool_mid)
        res(ds_mid, mid_ch, mid_ch)
    if decoder:
        ch, skips = mid_ch, list(skip_ch)
        for u in decoder_plan(ucfg):
            skip = skips.pop()
            if not shallow or u["level"] <= shallow_level:
                res(u["ds"], ch + skip, u["ch"])
                if u["attn"]:
                    spatial(u["ds"], u["ch"])
                if ucfg.use_motion_modules:
                    out.append(("motion", hw(u["ds"]), u["ch"]))
            ch = u["ch"]
        out.append(("gn", hw(1), ucfg.model_channels))
    return out


def request_launch_plan(model_cfg, latent: int, batch: int, scfg, frames: int = 1,
                        fused_gn: bool = False, video: bool = False) -> dict:
    """Kernel launches of one request of the image sampler (frames = 1) or
    of the overlap sampler (frames = the window, batch = windows x window)
    under `scfg`, a reference and pose maps given, from the host masks the
    sampler itself runs (`sampling.ddim.TurboPlan`): per step the bank write
    pass (on bank-refresh steps), the ControlNet (when the residuals are not
    reused), the cond pass (full, or DeepCache-shallow on reuse steps) and
    the uncond pass (on refresh steps; full or shallow) -- or, with fused
    CFG on the image path, the ControlNet and one gated pass over 2B rows.
    A model without the appearance branch (DUAL_CONTROL) has no write pass
    and its cond pass reads no bank (plain self-attention); under
    DUAL_CONTROL (an image hint given) every ControlNet pass is two, the
    pose and the image ControlNet's.
    `video`: the overlap sampler (no fused CFG, a vanilla-SD uncond pass).
    Self keys are pooled at read/plain sites of at least self_kv_min_seq
    tokens (not in the write pass), bank entries at sites of at least
    bank_downsample_min_seq. `fused_gn`: MAGICDANCE_FUSED_GN=1 (every
    GN+SiLU with H*W >= 256 launches K8)."""
    from collections import Counter

    from magicdance_tpu_torch.models.controlnet import controlnet_unet_config
    from magicdance_tpu_torch.models.magicpose import appearance_unet_config
    from magicdance_tpu_torch.ops.attention import _kernel_site
    from magicdance_tpu_torch.ops.schedules import make_ddim_schedule, make_schedule
    from magicdance_tpu_torch.sampling.ddim import TurboPlan

    sched = make_schedule(model_cfg.diffusion)
    ddim = make_ddim_schedule(sched, scfg.steps, eta=scfg.eta)
    use_cfg = scfg.cfg_scale != 1.0
    fused = use_cfg and scfg.fused_cfg and not video
    has_app = model_cfg.has_appearance
    plan = TurboPlan(scfg, sched, ddim, use_cfg, has_app, True,
                     fused_cfg=scfg.fused_cfg and not video)
    pool = scfg.self_kv_downsample
    main = model_cfg.unet
    controls = [controlnet_unet_config(model_cfg.pose_control, main.in_channels)]
    if model_cfg.has_image_control:
        controls.append(controlnet_unet_config(model_cfg.image_control or model_cfg.pose_control,
                                               main.in_channels))
    app = appearance_unet_config(model_cfg)
    read = "read" if has_app else "self"

    def pooled(s, poolable, write=False):
        side = int(round(s ** 0.5))
        if (pool > 1 and poolable and not write and s >= scfg.self_kv_min_seq
                and side % pool == 0):
            return s // pool ** 2
        return s

    def bank_len(s):
        f, side = scfg.bank_downsample, int(round(s ** 0.5))
        if f > 1 and s >= scfg.bank_downsample_min_seq and side % f == 0:
            return s // f ** 2
        return s

    def run(c, ucfg, kind, b, shallow_level=None, decoder=True, pool_mid=True):
        """kind: "write", "self" (ControlNet, uncond), "read", "gated"."""
        for site in pass_sites(ucfg, latent, decoder, shallow_level, pool_mid):
            if site[0] == "gn":
                if fused_gn and site[1] >= 256:
                    c["groupnorm_silu"] += 1
            elif site[0] == "motion":
                c["grouped"] += _motion_launches(ucfg, site[1], site[2], b // frames, frames)
            else:
                _, s, d, poolable = site
                sk = pooled(s, poolable, write=kind == "write")
                if kind == "gated":
                    c["two_source_attention_gated" if _kernel_site(s, s + bank_len(s), d)
                      else None] += 1
                elif kind == "read":
                    c["two_source_attention" if _kernel_site(s, sk + bank_len(s), d)
                      else None] += 1
                elif sk != s:
                    c["self_attention" if _kernel_site(s, sk, d) else None] += 1
                else:
                    c[_self_mode(s, d, b)] += 1

    def run_controls(c):
        for cn in controls:
            run(c, cn, "self", batch, decoder=False, pool_mid=False)

    c = Counter()
    for i in range(ddim.num_steps):
        step = ddim.num_steps - 1 - i
        if has_app and plan.bank_refresh[step]:
            run(c, app, "write", 1)
        if fused:
            run_controls(c)
            run(c, main, "gated" if has_app else "self", 2 * batch)
            continue
        if not plan.pose_reuse or plan.pose_refresh[step]:
            run_controls(c)
        shallow = (plan.deep_level if plan.deepcache and not plan.deep_refresh[step]
                   else None)
        run(c, main, read, batch, shallow)
        if use_cfg and plan.refresh[step]:
            if scfg.control_mode == "balance" and not video:
                if not plan.pose_reuse:
                    run_controls(c)
                run(c, main, read, batch)
            else:
                ushallow = (plan.deep_level if plan.uncond_deepcache
                            and not plan.udeep_refresh[step] else None)
                run(c, main, "self", batch, ushallow)
    return {m: n for m, n in c.items() if m and n}


def stage3_launch_plan(cfg, image: int, clips: int) -> dict:
    """Kernel launches of one stage-3 train step (MOTION_ONLY) on `clips`
    clips of cfg.video_frames frames: the frozen VAE encodes (chunked) and
    the frozen appearance UNet and ControlNet launch the forward kernels
    without LSE; in the main UNet the first bank read depends on no trainable
    parameter (kernel B without LSE), every later one does (B with LSE twice
    under remat, dQ of two sources, dK/dV of the self source; the frozen bank
    needs none), and every motion-module attention runs the grouped forward
    twice under remat and its backward once."""
    from collections import Counter

    from magicdance_tpu_torch.models.controlnet import controlnet_unet_config
    from magicdance_tpu_torch.models.magicpose import appearance_unet_config
    from magicdance_tpu_torch.ops.attention import _kernel_site

    m = cfg.model
    frames, n = cfg.video_frames, clips * cfg.video_frames
    latent = image // 2 ** (len(m.vae.channel_mult) - 1)
    chunk = cfg.vae_encode_chunk

    def encodes(b):
        return b // chunk if chunk and b > chunk and b % chunk == 0 else 1

    c = Counter(_vae_launches(m.vae, latent, encodes(n) + encodes(clips)))
    for _, s, d in unet_sites(appearance_unet_config(m), latent):
        c[_self_mode(s, d, clips)] += 1
    cn = controlnet_unet_config(m.pose_control, m.unet.in_channels)
    for _, s, d in unet_sites(cn, latent, decoder=False):
        c[_self_mode(s, d, n)] += 1
    fwd = 2 if m.unet.remat else 1
    for kind, s, x in unet_sites(m.unet, latent):
        if kind == "motion":
            k = _motion_launches(m.unet, s, x, clips, frames)
            c["grouped"] += fwd * k
            c["grouped_bwd"] += k
        elif _kernel_site(s, 2 * s, x):
            c["two_source_attention"] += 1
    grad = len(stage3_grad_sites(m, latent))
    c["two_source_attention"] -= grad
    c["two_source_attention_lse"] += fwd * grad
    c["attention_dq_two_source"] += grad
    c["attention_dkv"] += grad
    return {k: v for k, v in c.items() if k and v}


def stage3_grad_sites(model_cfg, latent: int) -> list:
    """(S, D) of each main-UNet bank read of a stage-3 step that needs a
    gradient: every kernel site after the first motion module, whose input
    depends on a trainable parameter. Each runs B with the LSE, C with two
    sources (a batch-1 bank) and D on the self source."""
    from magicdance_tpu_torch.ops.attention import _kernel_site

    out, grad = [], False
    for kind, s, x in unet_sites(model_cfg.unet, latent):
        grad = grad or kind == "motion"
        if kind == "spatial" and grad and _kernel_site(s, 2 * s, x):
            out.append((s, x))
    return out


def check_training_kernels(plan, stage3, batch: int = 2, heads: int = 8, frames: int = 16):
    """Phase 7: the LSE forward and kernels C/D against their plain versions
    at every (S, D) of the training plan, self-attention and bank reads with
    bank batch `batch`, bf16 (timed) and fp32; plus a batch-1 bank, a ragged
    and a BSNH-strided case; then C (two sources, a batch-1 bank) and D (the
    self source) at every (S, D) of the stage-3 step, `stage3` {(S, D):
    launches per step}, on `frames` frames in bf16 (timed)."""
    import torch
    import torch.nn.functional as F

    from magicdance_tpu_torch.ops.kernels import flash_vjp as V
    from magicdance_tpu_torch.utils.timing import device_time_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    errs = {name: 0.0 for name in KERNELS}
    checked = {name: 0 for name in KERNELS}
    rows = []

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def check(name, got, want, label, grad):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rms = want.float().pow(2).mean().sqrt().item()
        if want.dtype == torch.bfloat16:
            tol = min(GRAD_BF16_TOL if grad else BF16_TOL, BF16_REL_TOL * rms)
        elif grad:
            tol = FP32_TOL * max(1.0, want.float().abs().max().item())
        else:
            tol = FP32_TOL
        if not (err <= tol and got.shape == want.shape and got.dtype == want.dtype):
            raise AssertionError(f"{name} {label}: max|kernel - plain| = {err:.3e} > "
                                 f"{tol:.3e} (plain rms {rms:.3e}), shapes "
                                 f"{tuple(got.shape)} {tuple(want.shape)}")
        errs[name] = max(errs[name], err)
        checked[name] += 1
        log(f"  ok  {name:22s} {label:52s} max_abs_err={err:.3e} rms={rms:.3e} "
            f"(tol {tol:.3e})")

    def run_case(q, k, v, dout, kb, vb, label, timed):
        two = kb is not None
        fwd, fwd_ref = ((V.two_source_attention_lse, V.two_source_attention_lse_ref) if two
                        else (V.self_attention_lse, V.self_attention_lse_ref))
        fargs = (q, k, v, kb, vb) if two else (q, k, v)
        fname = "two_source_attention" if two else "self_attention"
        got_o, got_lse = fwd(*fargs)
        out, lse = fwd_ref(*fargs)
        check(fname, got_o, out, f"{label} o", grad=False)
        check(fname, got_lse, lse, f"{label} lse", grad=False)
        delta = V.attention_delta(dout, out)
        dq_args = (q, k, v, dout, lse, delta, None, kb, vb)
        check("attention_dq", V.attention_dq(*dq_args), V.attention_dq_ref(*dq_args),
              f"{label} dQ", grad=True)
        for src, (kk, vv) in (("self", (k, v)),) + ((("bank", (kb, vb)),) if two else ()):
            dkv_args = (kk, vv, q, dout, lse, delta)
            for g_, w_, nm in zip(V.attention_dkv(*dkv_args), V.attention_dkv_ref(*dkv_args),
                                  ("dK", "dV")):
                check("attention_dkv", g_, w_, f"{label} {nm} ({src} source)", grad=True)
        if not timed:
            return
        b, sq, h, d = q.shape
        kv = [(b, k.shape[1])] + ([(kb.shape[0], kb.shape[1])] if two else [])
        kh = torch.cat([k, kb.expand(b, -1, -1, -1)], 1) if two else k
        vh = torch.cat([v, vb.expand(b, -1, -1, -1)], 1) if two else v
        qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_() for t in (q, kh, vh))
        lib_out = F.scaled_dot_product_attention(qs, ks, vs)
        g = dout.transpose(1, 2)
        lib = {
            "lse": device_time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs)),
            "dq": device_time_ms(lambda: torch.autograd.grad(lib_out, [qs], g, retain_graph=True)),
            "dkv": device_time_ms(lambda: torch.autograd.grad(lib_out, [ks, vs], g,
                                                              retain_graph=True)),
        }
        src_kv = (kb, vb) if two else (k, v)
        cases = {
            "lse": (lambda: fwd(*fargs), lambda: fwd_ref(*fargs), kv,
                    "two_source_attention_lse" if two else "self_attention_lse"),
            "dq": (lambda: V.attention_dq(*dq_args), lambda: V.attention_dq_ref(*dq_args), kv,
                   "attention_dq_two_source" if two else "attention_dq"),
            "dkv": (lambda: V.attention_dkv(*src_kv, q, dout, lse, delta),
                    lambda: V.attention_dkv_ref(*src_kv, q, dout, lse, delta),
                    [(src_kv[0].shape[0], src_kv[0].shape[1])], "attention_dkv"),
        }
        for kind, (kern, plain, kv_, mode) in cases.items():
            ms = device_time_ms(kern)
            plain_ms = device_time_ms(plain, min_total_s=0.1, max_iters=5)
            bound, bound_by = training_bound_ms(kind, b, sq, h, d, kv_)
            # dK/dV of a bank source at bank batch B has the self source's
            # shapes: the plan's dK/dV launches at (S, D) go to the self row
            per_step = 0 if (kind == "dkv" and two) else plan.get((mode, sq, d), 0)
            rows.append(dict(mode=mode, kind=kind, B=b, S=sq, D=d, H=h,
                             bank_batch=kb.shape[0] if two else None,
                             launches_per_step=per_step, kernel_ms=ms, plain_ms=plain_ms,
                             library_ms=lib[kind], bound_ms=bound, bound_by=bound_by,
                             exp_bound_ms=exp_bound_ms(b, sq, h, kv_)))
            log(f"      {mode:25s} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={lib[kind]:.4f} bound_ms={bound:.4f} ({bound_by}) "
                f"x{per_step}/step")
        del lib_out

    shapes = sorted({(s, d) for (_, s, d) in plan}, reverse=True)
    for s, d in shapes:
        for two in (False, True):
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v, dout = (rnd(batch, s, heads, d, dtype=dtype) for _ in range(4))
                kb = vb = None
                if two:
                    kb, vb = (rnd(batch, s, heads, d, dtype=dtype) for _ in range(2))
                label = (f"{str(dtype)[6:]} B={batch} S={s} D={d}"
                         + (f" bank_batch={batch}" if two else ""))
                run_case(q, k, v, dout, kb, vb, label, timed=dtype == torch.bfloat16)
                del q, k, v, dout, kb, vb
                torch.cuda.empty_cache()
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype)[6:]
        q, k, v, dout = (rnd(batch, 4096, heads, 40, dtype=dtype) for _ in range(4))
        kb, vb = (rnd(1, 4096, heads, 40, dtype=dtype) for _ in range(2))
        run_case(q, k, v, dout, kb, vb, f"{tag} B={batch} S=4096 D=40 bank_batch=1", False)
        q, k, v, dout = (rnd(3, 300, 4, 48, dtype=dtype) for _ in range(4))
        kb, vb = (rnd(3, 200, 4, 48, dtype=dtype) for _ in range(2))
        run_case(q, k, v, dout, kb, vb, f"{tag} ragged B=3 S=300 bank Sb=200 D=48", False)
        q, k, v, dout = (rnd(2, heads, 1024, 80, dtype=dtype).transpose(1, 2)
                         for _ in range(4))
        run_case(q, k, v, dout, None, None, f"{tag} BSNH-strided B=2 S=1024 D=80", False)
        del q, k, v, dout, kb, vb
        torch.cuda.empty_cache()

    # stage 3: a 16-frame clip reads one reference's bank. The plain versions
    # run two frames at a time (phase 3's video rows): dQ and the self
    # source's dK/dV of a frame depend on that frame (and the bank) alone.
    chunk = 2
    for (s, d), per_step in sorted(stage3.items(), reverse=True):
        q, k, v, dout = (rnd(frames, s, heads, d, dtype=torch.bfloat16) for _ in range(4))
        kb, vb = (rnd(1, s, heads, d, dtype=torch.bfloat16) for _ in range(2))

        def by_frames(fn, *ts):
            outs = [fn(*(t[i:i + chunk] for t in ts)) for i in range(0, frames, chunk)]
            return (tuple(torch.cat(o) for o in zip(*outs)) if isinstance(outs[0], tuple)
                    else torch.cat(outs))

        _, lse = V.two_source_attention_lse(q, k, v, kb, vb)
        out, lse_ref = by_frames(lambda q_, k_, v_: V.two_source_attention_lse_ref(
            q_, k_, v_, kb, vb), q, k, v)
        label = f"bfloat16 stage 3 B={frames} S={s} D={d} bank_batch=1"
        check("two_source_attention", lse, lse_ref, f"{label} lse", grad=False)
        delta = V.attention_delta(dout, out)
        del out, lse_ref

        def dq_kern():
            return V.attention_dq(q, k, v, dout, lse, delta, None, kb, vb)

        def dq_plain():
            return by_frames(lambda q_, k_, v_, do_, l_, d_: V.attention_dq_ref(
                q_, k_, v_, do_, l_, d_, None, kb, vb), q, k, v, dout, lse, delta)

        def dkv_kern():
            return V.attention_dkv(k, v, q, dout, lse, delta)

        def dkv_plain():
            return by_frames(V.attention_dkv_ref, k, v, q, dout, lse, delta)

        check("attention_dq", dq_kern(), dq_plain(), f"{label} dQ", grad=True)
        for g_, w_, nm in zip(dkv_kern(), dkv_plain(), ("dK", "dV")):
            check("attention_dkv", g_, w_, f"{label} {nm} (self source)", grad=True)
        kh = torch.cat([k, kb.expand(frames, -1, -1, -1)], 1)
        vh = torch.cat([v, vb.expand(frames, -1, -1, -1)], 1)
        qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_() for t in (q, kh, vh))
        lib_out = F.scaled_dot_product_attention(qs, ks, vs)
        g = dout.transpose(1, 2)
        for kind, mode, kern, plain, kv in (
                ("dq", "attention_dq_two_source", dq_kern, dq_plain, [(frames, s), (1, s)]),
                ("dkv", "attention_dkv", dkv_kern, dkv_plain, [(frames, s)])):
            ms = device_time_ms(kern)
            plain_ms = device_time_ms(plain, min_total_s=0.1, max_iters=3)
            lib = device_time_ms(lambda: torch.autograd.grad(
                lib_out, [qs] if kind == "dq" else [ks, vs], g, retain_graph=True))
            bound, bound_by = training_bound_ms(kind, frames, s, heads, d, kv)
            rows.append(dict(mode=mode, kind=kind, path="stage 3", B=frames, S=s, D=d, H=heads,
                             bank_batch=1 if kind == "dq" else None,
                             launches_per_step=per_step, kernel_ms=ms, plain_ms=plain_ms,
                             library_ms=lib, bound_ms=bound, bound_by=bound_by,
                             exp_bound_ms=exp_bound_ms(frames, s, heads, kv)))
            log(f"      {mode:25s} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} (by {chunk} "
                f"frames) library_ms={lib:.4f} bound_ms={bound:.4f} ({bound_by}) "
                f"x{per_step}/stage-3 step")
        del q, k, v, dout, kb, vb, lse, delta, kh, vh, qs, ks, vs, lib_out, g
        torch.cuda.empty_cache()
    return rows, errs, checked


def narrow_train_config():
    """Stage 2 at narrow width, 128x128 (S = 256 at the first level); two res
    blocks per level give the main UNet two kernel sites before its first
    downsample, the first of which needs no dQ."""
    from magicdance_tpu_torch import config as C

    narrow = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=2,
                  attention_resolutions=(1, 2), num_heads=2, context_dim=16)
    model = C.ModelConfig(unet=C.UNetConfig(**narrow), pose_control=C.ControlNetConfig(**narrow),
                          vae=C.VAEConfig(base_channels=32, channel_mult=(1, 1, 2, 2),
                                          num_res_blocks=1),
                          clip=C.CLIPTextConfig(hidden_size=16, num_layers=1, num_heads=2),
                          latent_size=16, dtype="float32")
    return C.TrainConfig(model=model, optim=C.OptimConfig(
        learning_rate=1e-4, warmup_steps=1, adam_eps=1e-4, frozen_dtype="float32"))


NARROW = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
              attention_resolutions=(1, 2), num_heads=2, context_dim=16)


def narrow_model_config():
    """A narrow image model at 128x128 (S = 256 at the first level, so the
    kernels run), fp32."""
    from magicdance_tpu_torch import config as C

    return C.ModelConfig(unet=C.UNetConfig(**NARROW), pose_control=C.ControlNetConfig(**NARROW),
                         vae=C.VAEConfig(base_channels=32, channel_mult=(1, 1, 2, 2),
                                         num_res_blocks=1),
                         clip=C.CLIPTextConfig(hidden_size=16, num_layers=1, num_heads=2),
                         latent_size=16, dtype="float32")


def narrow_dual_config():
    """The narrow image model on the DUAL_CONTROL variant (pose and image
    ControlNets, no appearance branch) at 128x128, fp32."""
    import dataclasses

    from magicdance_tpu_torch import config as C

    return dataclasses.replace(narrow_model_config(), variant=C.ModelVariant.DUAL_CONTROL)


def dual_model_config():
    """DUAL_CONTROL at full SD1.5 width (the image ControlNet has the pose
    ControlNet's architecture)."""
    from magicdance_tpu_torch import config as C

    return C.ModelConfig(variant=C.ModelVariant.DUAL_CONTROL)


def narrow_temporal_config():
    """The narrow model with motion modules (2 heads of 16 and 32 channels)
    at 128x128: the first level's 256 positions take kernels A and B, and
    windows of 4 frames make its motion attention a grouped site."""
    import dataclasses

    from magicdance_tpu_torch import config as C

    return dataclasses.replace(
        narrow_model_config(), variant=C.ModelVariant.APPEARANCE_POSE_TEMPORAL,
        unet=C.UNetConfig(**NARROW, use_motion_modules=True, motion_num_heads=2))


def narrow_stage3_config(frames: int = 4):
    """Stage 3 (MOTION_ONLY) on the narrow temporal model, clips of 4."""
    from magicdance_tpu_torch import config as C

    return C.TrainConfig(model=narrow_temporal_config(), freeze=C.FreezeRegime.MOTION_ONLY,
                         video_frames=frames, optim=C.OptimConfig(
                             learning_rate=1e-4, warmup_steps=1, adam_eps=1e-4,
                             frozen_dtype="float32"))


def small_training_check():
    """Phase 8: one narrow stage-2 step at 128x128, card vs CPU (fp32)."""
    import torch

    from magicdance_tpu_torch.ops import kernels as K
    from magicdance_tpu_torch.train.trainer import Trainer

    cfg = narrow_train_config()
    cpu = Trainer(cfg, device="cpu")
    cpu.init_random(seed=3, scale=0.1)
    gpu = Trainer(cfg, device="cuda")
    for name in ("model", "vae", "clip"):
        getattr(gpu, name).load_state_dict(getattr(cpu, name).state_dict())
    g = torch.Generator().manual_seed(8)
    batch = {"image": torch.rand(2, 128, 128, 3, generator=g) * 2 - 1,
             "reference": torch.rand(2, 128, 128, 3, generator=g) * 2 - 1,
             "pose": torch.rand(2, 128, 128, 3, generator=g),
             "input_ids": torch.zeros(2, 77, dtype=torch.long)}
    draws = [cpu.draw(batch) for _ in range(2)]
    loss_c, _, grads_c = cpu.loss_and_grads(batch, draws[0])
    K.reset_launches()
    loss_g, _, grads_g = gpu.loss_and_grads(gpu.to_device(batch), draws[0])
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    _, totals, _ = training_launch_plan(cfg.model, 16)
    # the narrow VAE's single 64-wide mid-attention head at S = 256 runs
    # kernel A without gradients, once per encode (image and reference)
    expect = {**{m: 0 for m in K.LAUNCHES}, **totals, "self_attention": 2}
    if launches != expect:
        raise AssertionError(f"narrow train step launches {launches}, plan {expect}")
    loss_err = abs(float(loss_g) - float(loss_c))
    gmax = max(t.abs().max().item() for t in grads_c.values())
    gerr = max((grads_g[k].cpu() - grads_c[k]).abs().max().item() for k in grads_c)
    # fp32 on both sides, TF32 off: summation order differs (cuDNN and the
    # kernels vs the CPU), ~1e-6 relative through these depths
    if not (loss_err <= 1e-5 * max(1.0, abs(float(loss_c))) and gerr <= 1e-4 * gmax):
        raise AssertionError(f"card vs CPU train step: loss err {loss_err:.3e}, max grad "
                             f"err {gerr:.3e} (max |grad| {gmax:.3e})")
    before = {k: p.detach().clone() for k, p in cpu.train_params.items()}
    for d in draws:
        cpu.train_step(batch, d)
        gpu.train_step(batch, d)
    lr = cfg.optim.learning_rate
    perr = max((gpu.train_params[k].detach().cpu() - p.detach()).abs().max().item()
               for k, p in cpu.train_params.items())
    moved = max((p.detach() - before[k]).abs().max().item()
                for k, p in cpu.train_params.items())
    # Adam normalizes each element; adam_eps 1e-4 bounds how far the fp32
    # noise of a near-zero gradient can move it
    if not (perr <= 0.1 * lr and moved > 0.5 * lr):
        raise AssertionError(f"card vs CPU params after 2 steps: max err {perr:.3e} "
                             f"(tol {0.1 * lr:.1e}), moved {moved:.3e}")
    log(f"  ok  narrow stage-2 step at 128x128, card (kernels) vs CPU (plain), fp32: "
        f"loss {float(loss_c):.6f} err {loss_err:.3e}; max grad err {gerr:.3e} "
        f"(max |grad| {gmax:.3e}); params after 2 steps max err {perr:.3e}, moved "
        f"{moved:.3e}; launches {launches}")
    return dict(loss_err=loss_err, grad_err=gerr, grad_max=gmax, param_err=perr,
                launches=launches)


def full_width_training(steps: int = 4, batch: int = 2):
    """Phase 9: the stage-2 trainer at full SD1.5 width, 512x512."""
    import dataclasses

    import torch

    from magicdance_tpu_torch import config as C
    from magicdance_tpu_torch.data.tokenizer import empty_prompt_ids
    from magicdance_tpu_torch.ops import kernels as K
    from magicdance_tpu_torch.train.trainer import Trainer

    cfg = C.stage2_pose_control()
    cfg = dataclasses.replace(cfg, batch_size_per_device=batch,
                              optim=dataclasses.replace(cfg.optim, warmup_steps=1))
    plan, totals, formula = training_launch_plan(cfg.model, cfg.image_size // 8)
    t0 = time.perf_counter()
    tr = Trainer(cfg, device="cuda")
    tr.init_random(seed=0)
    torch.cuda.synchronize()
    n_train = sum(p.numel() for p in tr.train_params.values())
    n_all = sum(p.numel() for m in (tr.model, tr.vae, tr.clip) for p in m.parameters())
    log(f"  trainer built, {n_all / 1e9:.3f} B parameters ({n_train / 1e9:.3f} B trainable, "
        f"fp32; frozen in {cfg.optim.frozen_dtype}), seeded random weights, "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.from_numpy(empty_prompt_ids(batch, cfg.model.clip.max_length)).cuda()

    def make_batch():
        return {"image": torch.rand(batch, 512, 512, 3, generator=gen, device="cuda") * 2 - 1,
                "reference": torch.rand(batch, 512, 512, 3, generator=gen, device="cuda") * 2 - 1,
                "pose": torch.rand(batch, 512, 512, 3, generator=gen, device="cuda"),
                "input_ids": ids}

    batches = [make_batch() for _ in range(steps + 1)]
    frozen = {k: p.detach().clone() for m in (tr.model, tr.vae, tr.clip)
              for k, p in m.named_parameters(prefix=type(m).__name__)
              if not p.requires_grad}
    train_before = {k: p.detach().clone() for k, p in tr.train_params.items()}
    torch.cuda.reset_peak_memory_stats()
    secs, losses, per_step = [], [], []
    K.reset_launches()
    for b in batches[:steps]:
        before = dict(K.LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = tr.train_step(b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(float(metrics["loss"]))
        per_step.append({m: K.LAUNCHES[m] - before[m] for m in K.LAUNCHES})
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    expect = {**{m: 0 for m in K.LAUNCHES}, **totals}
    for i, got in enumerate(per_step):
        if got != expect:
            raise AssertionError(f"step {i + 1}: launches {got}, plan {expect}")
    if not all(torch.isfinite(torch.tensor(losses))):
        raise AssertionError(f"non-finite losses {losses}")
    for m in (tr.model, tr.vae, tr.clip):
        for k, p in m.named_parameters(prefix=type(m).__name__):
            if not p.requires_grad and not torch.equal(p.detach(), frozen[k]):
                raise AssertionError(f"frozen parameter {k} changed")
    moved = sum(int(not torch.equal(p.detach(), train_before[k]))
                for k, p in tr.train_params.items())
    if moved == 0:
        raise AssertionError("no trainable parameter moved")
    del frozen, train_before
    steady = sum(secs[1:]) / max(1, len(secs) - 1)
    log(f"  {steps} steps of B = {batch} at 512x512: losses {[round(x, 5) for x in losses]}, "
        f"seconds per step {[round(x, 3) for x in secs]} (first {secs[0]:.3f}, steady "
        f"{steady:.3f}), {batch / steady:.3f} images/s, peak memory "
        f"{peak / 2**30:.2f} GiB; {moved}/{len(tr.train_params)} trainable tensors moved, "
        f"frozen weights bit-identical")
    for m in TRAIN_MODES:
        log(f"  launches per step {m} = {formula[m]} (every step: {per_step[0][m]})")
    breakdown = training_breakdown(tr, batches[steps])
    return dict(seconds_per_step=secs, losses=losses, images_per_s=batch / steady,
                peak_bytes=peak, launches=launches, launches_per_step=per_step[0],
                formula=formula, plan={f"{m} S={s} D={d}": n for (m, s, d), n in plan.items()},
                breakdown_ms=breakdown)


def training_breakdown(tr, batch):
    """One more step in pieces: encode (VAE + CLIP), forward (the loss),
    backward, optimizer. Per piece: CUDA-event device time, and the host's
    enqueue time beside its wall time."""
    import torch

    draws = tr.draw(batch)
    state = {}

    def encode():
        state["lat"] = tr.encode(batch, draws)

    def forward():
        state["loss"] = tr.loss_from_latents(*state["lat"], batch, draws)[0]

    def backward():
        state["loss"].backward()

    def optimizer():
        tr.apply_update(tr.grads())

    out = {}
    for name, fn in (("encode", encode), ("forward", forward), ("backward", backward),
                     ("optimizer", optimizer)):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        t1 = time.perf_counter()
        end.record()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out[name] = dict(device_ms=start.elapsed_time(end), enqueue_ms=(t1 - t0) * 1e3,
                         wall_ms=(t2 - t0) * 1e3)
    log("  one step in pieces (device / host enqueue / wall ms): " + ", ".join(
        f"{k}={v['device_ms']:.1f}/{v['enqueue_ms']:.1f}/{v['wall_ms']:.1f}"
        for k, v in out.items()))
    return out


# --------------------------------------------------------------------------
# phases 10-13: the video path (motion modules, grouped kernel G)
# --------------------------------------------------------------------------


def temporal_model_config():
    """SD1.5 width with AnimateDiff motion modules: the stage-3 model."""
    from magicdance_tpu_torch.config import stage3_motion

    return stage3_motion().model


def grouped_shapes(frames: int = 16, latent: int = 64):
    """(sequences, S, H, D, launches per DDIM step, launches per training
    step) of every motion-module attention shape of one `frames`-frame
    window at 512x512: (h*w, S = frames) sequences, forward per DDIM step
    (cond + uncond) and per stage-3 step (forward + remat recompute)."""
    from collections import Counter

    ucfg = temporal_model_config().unet
    per = Counter()
    for kind, hw, ch in unet_sites(ucfg, latent):
        if kind == "motion":
            per[hw, ch] += ucfg.motion_layers * ucfg.motion_attn_blocks
    heads = ucfg.motion_num_heads
    return [(hw, frames, heads, ch // heads, 2 * n, n) for (hw, ch), n in
            sorted(per.items(), reverse=True)]


def grouped_bound_ms(kind: str, n: int, s: int, c: int, itemsize: int = 2):
    """Least time of one grouped launch over n sequences of s rows and c =
    H*D channels: bytes (q, k, v in and o out; backward q, k, v, dO in and
    dq, dk, dv out) over the memory rate vs the products the kernel does (2,
    forward, and 5, backward, S x S x D products of 2 operations per
    multiply-add, per sequence and head) over the bf16 peak."""
    rows = n * s
    tensors, products = (4, 2) if kind == "fwd" else (7, 5)
    nbytes = itemsize * tensors * rows * c
    flops = 2.0 * products * rows * s * c
    t_ops, t_mem = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def check_grouped_kernels():
    """Phase 10: kernel G forward and backward against their plain versions
    at every full-width motion shape (bf16, timed), one shape in fp32, one
    frame per clip (S = 1) and a two-window batch. Gates as phases 3 and 7."""
    import torch
    import torch.nn.functional as F

    from magicdance_tpu_torch.ops.kernels import grouped as G
    from magicdance_tpu_torch.utils.timing import device_time_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(777)
    errs = {"grouped_attention": 0.0, "grouped_attention_bwd": 0.0}
    checked = dict.fromkeys(errs, 0)
    rows = []

    def check(name, got, want, label, grad):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rms = want.float().pow(2).mean().sqrt().item()
        if want.dtype == torch.bfloat16:
            tol = min(GRAD_BF16_TOL if grad else BF16_TOL, BF16_REL_TOL * rms)
        else:
            tol = FP32_TOL * (max(1.0, want.float().abs().max().item()) if grad else 1.0)
        if not (err <= tol and got.shape == want.shape and got.dtype == want.dtype):
            raise AssertionError(f"{name} {label}: max|kernel - plain| = {err:.3e} > "
                                 f"{tol:.3e} (plain rms {rms:.3e})")
        errs[name] = max(errs[name], err)
        checked[name] += 1
        log(f"  ok  {name:22s} {label:44s} max_abs_err={err:.3e} rms={rms:.3e} "
            f"(tol {tol:.3e})")

    cases = [(n, s, h, d, ps, pt, torch.bfloat16, True) for n, s, h, d, ps, pt in grouped_shapes()]
    n0, s0, h0, d0 = cases[0][:4]
    cases += [(n0, s0, h0, d0, 0, 0, torch.float32, False),
              (2 * n0, 1, h0, d0, 0, 0, torch.bfloat16, False),   # S = 1
              (2 * n0, 1, h0, d0, 0, 0, torch.float32, False),
              (2 * n0, s0, h0, d0, 0, 0, torch.bfloat16, False)]  # two windows
    for n, s, h, d, per_step, per_train, dtype, timed in cases:
        q, k, v, g = (torch.randn(n, s, h * d, generator=gen, device=dev).to(dtype)
                      for _ in range(4))
        label = f"{str(dtype)[6:]} ({n}x{s}, {h * d}) D={d}"
        check("grouped_attention", G.grouped_attention(q, k, v, None, h),
              G.grouped_attention_ref(q, k, v, None, h), f"{label} o", grad=False)
        got = G.grouped_attention_bwd(q, k, v, g, None, h)
        want = G.grouped_attention_bwd_ref(q, k, v, g, None, h)
        for a, b, nm in zip(got, want, ("dq", "dk", "dv")):
            check("grouped_attention_bwd", a, b, f"{label} {nm}", grad=True)
        if (n, s, h, d, dtype) == (n0, s0, h0, d0, torch.bfloat16) and timed:
            again = G.grouped_attention_bwd(q, k, v, g, None, h)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"grouped_attention_bwd {label}: two runs differ")
            log(f"  ok  grouped_attention_bwd  {label}: two runs, the same bits")
        if not timed:
            continue
        qs, ks, vs = (t.view(n, s, h, d).transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qs, ks, vs)
        gs = g.view(n, s, h, d).transpose(1, 2)
        times = {
            "fwd": (device_time_ms(lambda: G.grouped_attention(q, k, v, None, h)),
                    device_time_ms(lambda: G.grouped_attention_ref(q, k, v, None, h),
                                   min_total_s=0.1, max_iters=5),
                    device_time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs)),
                    per_step, "grouped"),
            "bwd": (device_time_ms(lambda: G.grouped_attention_bwd(q, k, v, g, None, h)),
                    device_time_ms(lambda: G.grouped_attention_bwd_ref(q, k, v, g, None, h),
                                   min_total_s=0.1, max_iters=5),
                    device_time_ms(lambda: torch.autograd.grad(lib_out, [qs, ks, vs], gs,
                                                               retain_graph=True)),
                    per_train, "grouped_bwd"),
        }
        for kind, (ms, plain_ms, lib_ms, launches, mode) in times.items():
            bound, bound_by = grouped_bound_ms(kind, n, s, h * d)
            rows.append(dict(mode=mode, sequences=n, S=s, H=h, D=d, C=h * d,
                             launches_per_step=launches, kernel_ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bound, bound_by=bound_by))
            log(f"      {mode:12s} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={lib_ms:.4f} bound_ms={bound:.4f} ({bound_by}) x{launches}/"
                f"{'DDIM step' if kind == 'fwd' else 'training step'}")
        del lib_out, qs, ks, vs, gs
        torch.cuda.empty_cache()
    return rows, errs, checked


def small_video_check():
    """Phase 11a: narrow temporal model at 128x128, F = 10 frames in windows
    of 4, stride 3, 3 DDIM steps with CFG 7: the card (kernels A, B, G) vs
    the CPU (plain versions), fp32, the same weights, x_T and offsets."""
    import torch

    from magicdance_tpu_torch.config import SampleConfig
    from magicdance_tpu_torch.ops import kernels as K
    from magicdance_tpu_torch.pipeline import MagicPosePipeline

    cfg = narrow_temporal_config()
    g = torch.Generator().manual_seed(11)
    pose = torch.rand(10, 128, 128, 3, generator=g)
    ref = torch.rand(1, 128, 128, 3, generator=g) * 2 - 1
    x_T = torch.randn(10, 16, 16, 4, generator=g)
    scfg = SampleConfig(steps=3, window=4, stride=3)
    offsets = [3, 7, 0]
    cpu = MagicPosePipeline(cfg, device="cpu")
    cpu.init_params(seed=5, scale=0.1)
    gpu = MagicPosePipeline(cfg, device="cuda")
    for name in ("model", "vae", "clip"):
        getattr(gpu, name).load_state_dict(getattr(cpu, name).state_dict())
    kw = dict(decode=False, video=True, x_T=x_T, window_offsets=offsets)
    want = cpu.sample_frames(pose, ref, scfg, **kw)
    K.reset_launches()
    got = gpu.sample_frames(pose, ref, scfg, **kw).cpu()
    launches = {m: n for m, n in K.LAUNCHES.items() if n}
    plan = serving_launch_plan(cfg, 16, 16, 4)
    expect = {m: n * scfg.steps for m, n in plan.items()}
    for m, n in _vae_launches(cfg.vae, 16, 1).items():  # the reference's encode
        expect[m] = expect.get(m, 0) + n
    if launches != expect:
        raise AssertionError(f"narrow video launches {launches}, plan {expect}")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    tol = 1e-4 * max(1.0, scale)  # fp32, CFG 7 over 3 steps (as phase 4)
    if not (err <= tol and torch.isfinite(got).all()):
        raise AssertionError(f"narrow video card vs CPU: max abs err {err:.3e} > {tol:.3e}")
    log(f"  ok  narrow 128x128 video F=10 W=4 stride 3, 3 steps CFG 7, card (kernels) vs "
        f"CPU (plain): max_abs_err={err:.3e} (tol {tol:.1e}, |out|max={scale:.3f}), "
        f"launches {launches}")
    return dict(err=err, scale=scale, launches=launches)


def small_stage3_check():
    """Phase 11b: one narrow stage-3 step (one clip of 4 frames at 128x128),
    card vs CPU, fp32, with the same weights, batch and draws."""
    import torch

    from magicdance_tpu_torch.ops import kernels as K
    from magicdance_tpu_torch.train.trainer import Trainer

    cfg = narrow_stage3_config()
    cpu = Trainer(cfg, device="cpu")
    cpu.init_random(seed=4, scale=0.1)
    gpu = Trainer(cfg, device="cuda")
    for name in ("model", "vae", "clip"):
        getattr(gpu, name).load_state_dict(getattr(cpu, name).state_dict())
    g = torch.Generator().manual_seed(9)
    batch = {"image": torch.rand(4, 128, 128, 3, generator=g) * 2 - 1,
             "reference": torch.rand(1, 128, 128, 3, generator=g) * 2 - 1,
             "pose": torch.rand(4, 128, 128, 3, generator=g),
             "input_ids": torch.zeros(4, 77, dtype=torch.long)}
    draws = cpu.draw(batch)
    loss_c, _, grads_c = cpu.loss_and_grads(batch, draws)
    K.reset_launches()
    loss_g, _, grads_g = gpu.loss_and_grads(gpu.to_device(batch), draws)
    torch.cuda.synchronize()
    launches = {m: n for m, n in K.LAUNCHES.items() if n}
    plan = stage3_launch_plan(cfg, 128, 1)
    if launches != plan:
        raise AssertionError(f"narrow stage-3 step launches {launches}, plan {plan}")
    loss_err = abs(float(loss_g) - float(loss_c))
    gmax = max(t.abs().max().item() for t in grads_c.values())
    gerr = max((grads_g[k].cpu() - grads_c[k]).abs().max().item() for k in grads_c)
    if not (loss_err <= 1e-5 * max(1.0, abs(float(loss_c))) and gerr <= 1e-4 * gmax):
        raise AssertionError(f"card vs CPU stage-3 step: loss err {loss_err:.3e}, max grad "
                             f"err {gerr:.3e} (max |grad| {gmax:.3e})")
    log(f"  ok  narrow stage-3 step (1 clip x 4 frames, 128x128), card vs CPU, fp32: loss "
        f"{float(loss_c):.6f} err {loss_err:.3e}; max grad err {gerr:.3e} (max |grad| "
        f"{gmax:.3e}), {len(grads_c)} motion tensors; launches {launches}")
    return dict(loss_err=loss_err, grad_err=gerr, grad_max=gmax, launches=launches)


def video_main_path(requests: int, frames: int, steps: int):
    """Phase 12: full-width video requests, `frames` pose maps at 512x512
    in one window of 16 frames, default SampleConfig (DDIM-50, CFG 7)."""
    import torch

    from magicdance_tpu_torch.config import SampleConfig
    from magicdance_tpu_torch.ops import kernels as K
    from magicdance_tpu_torch.pipeline import MagicPosePipeline

    cfg = temporal_model_config()
    t0 = time.perf_counter()
    pipe = MagicPosePipeline(cfg, device="cuda")
    pipe.init_params(seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (pipe.model, pipe.vae, pipe.clip) for p in m.parameters())
    n_motion = sum(p.numel() for k, p in pipe.model.named_parameters() if "motion" in k)
    log(f"  temporal pipeline built, {n_params / 1e9:.3f} B parameters ({n_motion / 1e9:.3f} B "
        f"in 20 motion modules), seeded random weights, {time.perf_counter() - t0:.1f} s")
    scfg = SampleConfig(steps=steps)
    window = min(scfg.window, frames)
    plan = serving_launch_plan(cfg, 64, frames, window)
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = [(torch.rand(frames, 512, 512, 3, generator=gen, device="cuda"),
               torch.rand(1, 512, 512, 3, generator=gen, device="cuda") * 2 - 1)
              for _ in range(requests)]
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    secs = []
    for pose, ref in inputs:
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pipe.sample_frames(pose, ref, scfg, video=True, generator=gen)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        if tuple(out.shape) != (frames, 512, 512, 3) or not torch.isfinite(out).all():
            raise AssertionError(f"bad video output {tuple(out.shape)}, finite="
                                 f"{bool(torch.isfinite(out).all())}")
    launches = dict(K.LAUNCHES)
    expect = {**{m: 0 for m in K.LAUNCHES}, **{m: n * steps * requests for m, n in plan.items()}}
    if launches != expect:
        raise AssertionError(f"video kernel launches {launches}, expected {expect} "
                             f"({plan} per DDIM step)")
    peak = torch.cuda.max_memory_allocated()
    log(f"  {requests} video requests x {frames} frames (window {window}, stride "
        f"{scfg.stride}), DDIM-{steps}, CFG {scfg.cfg_scale}: seconds per request "
        f"{[round(s, 3) for s in secs]}, frames/s {[round(frames / s, 4) for s in secs]}, "
        f"peak memory {peak / 2**30:.2f} GiB")
    log(f"  launches {launches} = {plan} per DDIM step")
    return pipe, dict(seconds_per_request=secs, frames=frames, steps=steps, window=window,
                      frames_per_s=[frames / s for s in secs], peak_bytes=peak,
                      launches=launches, plan_per_step=plan)


def stage3_trainer():
    """The stage-3 trainer of phase 13 and its batch maker: the
    `stage3_motion()` preset (one clip of 16 frames at 512x512, remat on),
    weights from seed 0, batches drawn from a generator seeded 2. Returns
    (cfg, trainer, make_batch). A one-off timing of the step's pieces calls
    it with `training_breakdown`, so the set-up exists once."""
    import dataclasses

    import torch

    from magicdance_tpu_torch import config as C
    from magicdance_tpu_torch.data.tokenizer import empty_prompt_ids
    from magicdance_tpu_torch.train.trainer import Trainer

    cfg = C.stage3_motion()
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, warmup_steps=1))
    tr = Trainer(cfg, device="cuda")
    tr.init_random(seed=0)
    gen = torch.Generator(device="cuda").manual_seed(2)
    clips = cfg.batch_size_per_device
    n = clips * cfg.video_frames
    ids = torch.from_numpy(empty_prompt_ids(n, cfg.model.clip.max_length)).cuda()

    def make_batch():
        return {"image": torch.rand(n, 512, 512, 3, generator=gen, device="cuda") * 2 - 1,
                "reference": torch.rand(clips, 512, 512, 3, generator=gen, device="cuda") * 2 - 1,
                "pose": torch.rand(n, 512, 512, 3, generator=gen, device="cuda"),
                "input_ids": ids}

    return cfg, tr, make_batch


def full_width_stage3(steps: int = 3):
    """Phase 13: the stage-3 trainer at full SD1.5 width: one clip of 16
    frames at 512x512 per step, remat on, bf16 denoiser, frozen weights in
    bf16, only the 20 motion modules train."""
    import torch

    from magicdance_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    cfg, tr, make_batch = stage3_trainer()
    frames, clips = cfg.video_frames, cfg.batch_size_per_device
    n = clips * frames
    plan = stage3_launch_plan(cfg, cfg.image_size, clips)
    torch.cuda.synchronize()
    n_train = sum(p.numel() for p in tr.train_params.values())
    n_all = sum(p.numel() for m in (tr.model, tr.vae, tr.clip) for p in m.parameters())
    log(f"  stage-3 trainer built, {n_all / 1e9:.3f} B parameters ({n_train / 1e9:.3f} B "
        f"trainable motion-module parameters, fp32; frozen in {cfg.optim.frozen_dtype}), "
        f"{time.perf_counter() - t0:.1f} s")

    batches = [make_batch() for _ in range(steps + 1)]
    frozen = {k: p.detach().clone() for m in (tr.model, tr.vae, tr.clip)
              for k, p in m.named_parameters(prefix=type(m).__name__) if not p.requires_grad}
    train_before = {k: p.detach().clone() for k, p in tr.train_params.items()}
    torch.cuda.reset_peak_memory_stats()
    secs, losses, per_step = [], [], []
    K.reset_launches()
    for b in batches[:steps]:
        before = dict(K.LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = tr.train_step(b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(float(metrics["loss"]))
        per_step.append({m: K.LAUNCHES[m] - before[m] for m in K.LAUNCHES})
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    expect = {**{m: 0 for m in K.LAUNCHES}, **plan}
    for i, got in enumerate(per_step):
        if got != expect:
            raise AssertionError(f"stage-3 step {i + 1}: launches {got}, plan {expect}")
    if not all(torch.isfinite(torch.tensor(losses))):
        raise AssertionError(f"non-finite stage-3 losses {losses}")
    for m in (tr.model, tr.vae, tr.clip):
        for k, p in m.named_parameters(prefix=type(m).__name__):
            if not p.requires_grad and not torch.equal(p.detach(), frozen[k]):
                raise AssertionError(f"frozen parameter {k} changed")
    moved = sum(int(not torch.equal(p.detach(), train_before[k]))
                for k, p in tr.train_params.items())
    if moved == 0:
        raise AssertionError("no motion-module parameter moved")
    del frozen, train_before
    steady = sum(secs[1:]) / max(1, len(secs) - 1)
    log(f"  {steps} stage-3 steps of {clips} clip x {frames} frames at 512x512: losses "
        f"{[round(x, 5) for x in losses]}, seconds per step {[round(x, 3) for x in secs]} "
        f"(first {secs[0]:.3f}, steady {steady:.3f}), {clips / steady:.4f} clips/s "
        f"({n / steady:.3f} frames/s), peak memory {peak / 2**30:.2f} GiB; {moved}/"
        f"{len(tr.train_params)} motion tensors moved, frozen weights bit-identical")
    log(f"  launches per step {per_step[0]} = plan {plan}")
    breakdown = training_breakdown(tr, batches[steps])
    return dict(seconds_per_step=secs, losses=losses, clips_per_s=clips / steady,
                peak_bytes=peak, launches=launches,
                launches_per_step={m: k for m, k in per_step[0].items() if k},
                trainable_params=n_train, breakdown_ms=breakdown)


# --------------------------------------------------------------------------
# phases 14-17: fused CFG, the turbo levers, the fused GroupNorm+SiLU
# --------------------------------------------------------------------------

# bench.py's stacks (bench.py:229-231 `turbo`, :254-259 `turbo_max`)
TURBO = dict(deepcache_every=3, pose_every=3, uncond_every=2, cfg_interval=(0.15, 0.85),
             bank_every=3, bank_downsample=2, self_kv_downsample=2)
TURBO_MAX = dict(deepcache_every=5, pose_every=5, uncond_every=4, cfg_interval=(0.15, 0.85),
                 bank_every=8, bank_downsample=4, bank_downsample_min_seq=4096,
                 self_kv_downsample=4, self_kv_min_seq=4096, reuse_exact_first=2,
                 reuse_exact_last=2)
# the narrow models' 256-token first level stands for the 4096-token sites
NARROW_POOL = dict(bank_downsample_min_seq=256, self_kv_min_seq=256)


def check(errs, checked, name, got, want, tol, label):
    """Hold `got` to `want`: fp32 max-abs <= tol, bf16 also <= a tenth of
    the plain output's RMS (phase 3's gates)."""
    import torch

    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    rms = want.float().pow(2).mean().sqrt().item()
    if got.dtype == torch.bfloat16:
        tol = min(tol, BF16_REL_TOL * rms)
    if not (err <= tol and got.shape == want.shape and got.dtype == want.dtype):
        raise AssertionError(f"{name} {label}: max|kernel - plain| = {err:.3e} > {tol:.3e} "
                             f"(plain rms {rms:.3e})")
    errs[name] = max(errs.get(name, 0.0), err)
    checked[name] = checked.get(name, 0) + 1
    log(f"  ok  {name:26s} {label:52s} max_abs_err={err:.3e} rms={rms:.3e} (tol {tol:.3e})")


def gated_bound_ms(b, sq, h, d, sk, sb, gates, itemsize=2) -> tuple[float, str]:
    """Least time of one gated kernel-B launch on these gates: every row
    reads its self keys, only rows with a nonzero gate the bank (a row gated
    by 0 is plain self-attention); a batch-1 bank is read once."""
    open_rows = sum(1 for g in gates if g != 0)
    flops = 4.0 * h * sq * d * (b * sk + open_rows * sb)
    nbytes = itemsize * h * d * (2 * b * sq + 2 * b * sk + (2 * sb if open_rows else 0))
    t_ops, t_mem = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def check_fused_cfg_and_pooled_kernels(frames: int, fused_plan: dict, heads: int = 8):
    """Phase 14a: kernel B's gated mode at every fused-CFG shape (2F rows,
    cond gates 1 and uncond gates 0, a batch-1 bank; plus gates with a 0.5),
    and kernels A and B at the pooled self-key lengths of the turbo stacks
    (S_k = S / 4 and S / 16 at the S = 4096 sites, the bank pooled alike),
    bf16 (timed) and fp32. `fused_plan`: {(S, D): gated launches per DDIM
    step}."""
    import torch
    import torch.nn.functional as F

    from magicdance_tpu_torch.ops import kernels as K
    from magicdance_tpu_torch.utils.timing import device_time_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4242)
    errs, checked, rows = {}, {}, []

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    b = 2 * frames
    cases = [(s, d, tuple([1.0] * frames + [0.0] * frames)) for s, d in
             ((4096, 40), (1024, 80), (256, 160))]
    cases.append((1024, 80, tuple([0.5] * frames + [0.0] * frames)))
    for s, d, gates in cases:
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            q, k, v = (rnd(b, s, heads, d, dtype=dtype) for _ in range(3))
            kb, vb = (rnd(1, s, heads, d, dtype=dtype) for _ in range(2))
            mask = torch.tensor(gates, device=dev)
            args = (q, k, v, kb, vb)
            label = f"{str(dtype)[6:]} B={b} S={s} D={d} bank_batch=1 gates={gates}"
            check(errs, checked, "two_source_attention_gated",
                  K.two_source_attention(*args, bank_mask=mask),
                  K.two_source_attention_ref(*args, bank_mask=mask), tol, label)
            if dtype != torch.bfloat16 or 0.5 in gates:
                continue
            ms = device_time_ms(lambda: K.two_source_attention(*args, bank_mask=mask))
            plain_ms = device_time_ms(lambda: K.two_source_attention_ref(*args, bank_mask=mask),
                                      min_total_s=0.1, max_iters=5)
            qh = q.transpose(1, 2)
            kh = torch.cat([k, kb.expand(b, -1, -1, -1)], 1).transpose(1, 2)
            vh = torch.cat([v, vb.expand(b, -1, -1, -1)], 1).transpose(1, 2)
            # the library call: SDPA over the concatenated keys, the bank
            # hidden from the gate-0 rows by a boolean mask
            allowed = torch.ones(b, 1, 1, 2 * s, dtype=torch.bool, device=dev)
            allowed[mask == 0, :, :, s:] = False
            lib_ms = device_time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                                           attn_mask=allowed))
            bound, by = gated_bound_ms(b, s, heads, d, s, s, gates)
            # exponentials: every row's self logits, the bank's only where the gate is open
            exp_ms = (exp_bound_ms(b, s, heads, [(b, s)])
                      + exp_bound_ms(sum(1 for g in gates if g != 0), s, heads, [(1, s)]))
            rows.append(dict(kernel="two_source_attention_gated", B=b, S=s, D=d, H=heads,
                             gates=list(gates), launches_per_step=fused_plan.get((s, d), 0),
                             kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=bound, bound_by=by, exp_bound_ms=exp_ms))
            log(f"      kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                f"bound_ms={bound:.4f} ({by}) exp_bound_ms={exp_ms:.4f} "
                f"x{fused_plan.get((s, d), 0)}/step")
            del q, k, v, kb, vb, args, kh, vh
            torch.cuda.empty_cache()

    # pooled self keys (self_kv_downsample 2 and 4) at the S = 4096 sites:
    # kernel A in the uncond pass and the ControlNet, kernel B in the cond
    # pass with the bank pooled by the same factor
    for p in (2, 4):
        sk = 4096 // p ** 2
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            q = rnd(frames, 4096, heads, 40, dtype=dtype)
            k, v = (rnd(frames, sk, heads, 40, dtype=dtype) for _ in range(2))
            kb, vb = (rnd(1, sk, heads, 40, dtype=dtype) for _ in range(2))
            tag = f"{str(dtype)[6:]} B={frames} S=4096 S_k={sk} D=40"
            check(errs, checked, "self_attention", K.self_attention(q, k, v),
                  K.self_attention_ref(q, k, v), tol, f"{tag} (pooled {p}x{p})")
            check(errs, checked, "two_source_attention", K.two_source_attention(q, k, v, kb, vb),
                  K.two_source_attention_ref(q, k, v, kb, vb), tol,
                  f"{tag} bank S_b={sk} (pooled {p}x{p})")
            if dtype != torch.bfloat16:
                continue
            qh = q.transpose(1, 2)
            for name, kern, plain, kv, kk, vv in (
                    ("self_attention", lambda: K.self_attention(q, k, v),
                     lambda: K.self_attention_ref(q, k, v), [(frames, sk)], k, v),
                    ("two_source_attention", lambda: K.two_source_attention(q, k, v, kb, vb),
                     lambda: K.two_source_attention_ref(q, k, v, kb, vb),
                     [(frames, sk), (1, sk)], torch.cat([k, kb.expand(frames, -1, -1, -1)], 1),
                     torch.cat([v, vb.expand(frames, -1, -1, -1)], 1))):
                ms = device_time_ms(kern)
                plain_ms = device_time_ms(plain, min_total_s=0.1, max_iters=5)
                kh, vh = kk.transpose(1, 2), vv.transpose(1, 2)
                lib_ms = device_time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
                bound, by = attention_bound_ms(frames, 4096, heads, 40, kv)
                exp_ms = exp_bound_ms(frames, 4096, heads, kv)
                rows.append(dict(kernel=name, B=frames, S=4096, S_k=sk, D=40, H=heads,
                                 pooled=p, launches_per_step=0, kernel_ms=ms, plain_ms=plain_ms,
                                 library_ms=lib_ms, bound_ms=bound, bound_by=by,
                                 exp_bound_ms=exp_ms))
                log(f"      {name} pooled {p}x{p}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                    f"library_ms={lib_ms:.4f} bound_ms={bound:.4f} ({by}) "
                    f"exp_bound_ms={exp_ms:.4f}")
            del q, k, v, kb, vb
            torch.cuda.empty_cache()
    return rows, errs, checked


def groupnorm_sites(pipe, frames: int) -> list:
    """Every (B, HW, C, groups, eps) at which the appearance UNet (B = 1),
    the ControlNet and the main UNet (B = frames) call GroupNorm+SiLU with
    HW >= 256 at 512x512, read from the model itself: forward hooks on its
    GroupNorm32(act=True) modules over one call of each pass."""
    import torch

    from magicdance_tpu_torch.models.layers import GroupNorm32

    seen = {}

    def hook(mod, inputs, _out):
        b, c, hh, ww = inputs[0].shape
        if hh * ww >= 256:
            key = (b, hh * ww, c, mod.norm.num_groups, mod.norm.eps)
            seen[key] = seen.get(key, 0) + 1

    m = pipe.model
    handles = [mod.register_forward_hook(hook) for mod in m.modules()
               if isinstance(mod, GroupNorm32) and mod.act]
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(frames, 64, 64, 4, generator=gen, device="cuda")
    t = torch.full((frames,), 501, dtype=torch.int64, device="cuda")
    hint = torch.rand(frames, 512, 512, 3, generator=gen, device="cuda")
    try:
        with torch.inference_mode():
            ctx = pipe.encode_empty(1).expand(frames, -1, -1)
            bank = m.compute_bank(x[:1], t[:1], ctx[:1])
            res = m.compute_control_residuals(x, hint, t, ctx)
            m.unet(x, t, ctx, bank=bank, pose_residuals=res)
    finally:
        for h in handles:
            h.remove()
    return sorted(seen.items(), key=lambda kv: (-kv[0][1], kv[0][2], kv[0][0]))


# the first level of the 16-frame video request under MAGICDANCE_FUSED_GN=1:
# K8's largest input (B, HW, C, groups, eps), timed beside the image sites
GN_VIDEO_SITE = (16, 4096, 320, 32, 1e-5)


def check_groupnorm_kernel(sites, per_step: dict):
    """Phase 14b: K8 against its plain version at every GN+SiLU site of the
    model and at GN_VIDEO_SITE (bf16, timed, and fp32), each run twice on
    the same input and required to give the same bits (no atomics, no
    order that depends on scheduling). Bound: one read and one write of x
    over the memory rate vs ~10 operations per element. Library:
    F.group_norm then F.silu (two calls; no single PyTorch call computes
    it). `per_step`: {(B, HW, C): launches per DDIM step under
    MAGICDANCE_FUSED_GN=1}; the video site's rows carry 0 and path "video"."""
    import torch
    import torch.nn.functional as F

    from magicdance_tpu_torch.ops.kernels import groupnorm as GN
    from magicdance_tpu_torch.utils.timing import device_time_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(99)
    errs, checked, rows = {}, {}, []
    for (b, hw, c, groups, eps), n_calls in list(sites) + [(GN_VIDEO_SITE, 0)]:
        w = torch.randn(c, generator=gen, device=dev) * 0.2 + 1
        bias = torch.randn(c, generator=gen, device=dev) * 0.2
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            x = torch.randn(b, hw, c, generator=gen, device=dev).to(dtype)
            label = f"{str(dtype)[6:]} B={b} HW={hw} C={c} groups={groups} eps={eps:g}"
            got = GN.groupnorm_silu(x, w, bias, groups, eps)
            check(errs, checked, "groupnorm_silu", got,
                  GN.groupnorm_silu_ref(x, w, bias, groups, eps), tol, label)
            again = GN.groupnorm_silu(x, w, bias, groups, eps)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"groupnorm_silu {label}: two runs on the same input "
                                     f"differ (max {(got.float() - again.float()).abs().max()})")
            if dtype != torch.bfloat16:
                continue
            side = int(round(hw ** 0.5))
            xn = x.view(b, side, side, c).permute(0, 3, 1, 2)  # NCHW, channels_last
            wb, bb = w.to(dtype), bias.to(dtype)
            ms = device_time_ms(lambda: GN.groupnorm_silu(x, w, bias, groups, eps))
            plain_ms = device_time_ms(lambda: GN.groupnorm_silu_ref(x, w, bias, groups, eps),
                                      min_total_s=0.1, max_iters=10)
            lib_ms = device_time_ms(lambda: F.silu(F.group_norm(xn, groups, wb, bb, eps)))
            n = b * hw * c
            t_mem = 2 * n * x.element_size() / PEAK_BYTES * 1e3
            t_ops = 10.0 * n / PEAK_BF16_FLOPS * 1e3
            bound, by = (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")
            launches = per_step.get((b, hw, c), 0) if n_calls else 0
            rows.append(dict(kernel="groupnorm_silu", B=b, HW=hw, C=c, groups=groups, eps=eps,
                             sites_per_pass=n_calls, launches_per_step=launches, kernel_ms=ms,
                             plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by,
                             **({} if n_calls else {"path": "video"})))
            log(f"      kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                f"bound_ms={bound:.4f} ({by}) x{launches}/step")
    return rows, errs, checked


def gn_plan_by_shape(model_cfg, latent: int, frames: int) -> dict:
    """K8 launches per DDIM step of the exact recipe under
    MAGICDANCE_FUSED_GN=1, by (B, HW, C): write pass (B = 1), ControlNet,
    cond and uncond passes (B = frames)."""
    from collections import Counter

    from magicdance_tpu_torch.models.controlnet import controlnet_unet_config
    from magicdance_tpu_torch.models.magicpose import appearance_unet_config

    c = Counter()
    cn = controlnet_unet_config(model_cfg.pose_control, model_cfg.unet.in_channels)
    for ucfg, b, decoder, passes in ((appearance_unet_config(model_cfg), 1, True, 1),
                                     (cn, frames, False, 1), (model_cfg.unet, frames, True, 2)):
        for site in pass_sites(ucfg, latent, decoder):
            if site[0] == "gn" and site[1] >= 256:
                c[b, site[1], site[2]] += passes
    return dict(c)


def small_turbo_checks():
    """Phase 15: narrow models at 128x128, the card (kernels) against the CPU
    (plain versions), fp32, the same weights and x_T: one fused-CFG sample,
    the `turbo` and `turbo_max` stacks (pooling thresholds at the narrow
    model's 256-token first level), the `turbo` stack through the overlap
    sampler on the temporal model (F = 10, windows of 4, stride 3), and an
    exact sample with MAGICDANCE_FUSED_GN=1. Each card run is held to its
    launch plan (request_launch_plan, plus the reference's VAE encode)."""
    import torch

    from magicdance_tpu_torch.config import SampleConfig
    from magicdance_tpu_torch.ops import kernels as K
    from magicdance_tpu_torch.pipeline import MagicPosePipeline

    out = {}
    pipes = {}
    for video in (False, True):
        cfg = narrow_temporal_config() if video else narrow_model_config()
        cpu = MagicPosePipeline(cfg, device="cpu")
        cpu.init_params(seed=12 + video, scale=0.1)
        gpu = MagicPosePipeline(cfg, device="cuda")
        for name in ("model", "vae", "clip"):
            getattr(gpu, name).load_state_dict(getattr(cpu, name).state_dict())
        pipes[video] = (cfg, cpu, gpu)
    cases = {"fused_cfg": (False, dict(steps=4, fused_cfg=True), False),
             "turbo": (False, dict(steps=4, **TURBO, **NARROW_POOL), False),
             "turbo_max": (False, dict(TURBO_MAX, steps=6, **NARROW_POOL), False),
             "video_turbo": (True, dict(steps=4, window=4, stride=3, **TURBO, **NARROW_POOL),
                             False),
             "fused_gn": (False, dict(steps=3), True)}
    for name, (video, kw, fused_gn) in cases.items():
        cfg, cpu, gpu = pipes[video]
        frames = 10 if video else 2
        g = torch.Generator().manual_seed(21)
        pose = torch.rand(frames, 128, 128, 3, generator=g)
        ref = torch.rand(1, 128, 128, 3, generator=g) * 2 - 1
        x_T = torch.randn(frames, 16, 16, 4, generator=g)
        scfg = SampleConfig(**kw)
        sk = dict(decode=False, x_T=x_T, video=video)
        if video:
            sk["window_offsets"] = [3, 7, 0, 5]
        want = cpu.sample_frames(pose, ref, scfg, **sk)
        saved = os.environ.get("MAGICDANCE_FUSED_GN")
        if fused_gn:
            os.environ["MAGICDANCE_FUSED_GN"] = "1"
        try:
            K.reset_launches()
            got = gpu.sample_frames(pose, ref, scfg, **sk).cpu()
            launches = {m: n for m, n in K.LAUNCHES.items() if n}
        finally:
            if saved is None:
                os.environ.pop("MAGICDANCE_FUSED_GN", None)
            else:
                os.environ["MAGICDANCE_FUSED_GN"] = saved
        expect = request_launch_plan(cfg, 16, 16 if video else frames, scfg,
                                     frames=4 if video else 1, fused_gn=fused_gn, video=video)
        for m, n in _vae_launches(cfg.vae, 16, 1).items():  # the reference's encode
            expect[m] = expect.get(m, 0) + n
        if launches != expect:
            raise AssertionError(f"narrow {name} launches {launches}, plan {expect}")
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        tol = 1e-4 * max(1.0, scale)  # fp32, CFG 7 over a few steps (as phase 4)
        if not (err <= tol and torch.isfinite(got).all()):
            raise AssertionError(f"narrow {name} card vs CPU: max abs err {err:.3e} > {tol:.3e}")
        log(f"  ok  narrow 128x128 {name} ({', '.join(f'{k}={v}' for k, v in kw.items())}), "
            f"card vs CPU: max_abs_err={err:.3e} (tol {tol:.1e}, |out|max={scale:.3f}), "
            f"launches {launches}")
        out[name] = dict(err=err, scale=scale, launches=launches)
    return out


def serve_requests(pipe, scfg, requests: int, frames: int, plan: dict, label: str,
                   video: bool = False, fused_gn: bool = False, image_hints: bool = False):
    """`requests` full-width requests of `frames` pose maps at 512x512 under
    `scfg` (with as many image hints for the DUAL_CONTROL variant when
    `image_hints`), each held to `plan` (launches per request); seconds per
    request, frames/s and peak memory."""
    import torch

    from magicdance_tpu_torch.ops import kernels as K

    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = [(torch.rand(frames, 512, 512, 3, generator=gen, device="cuda"),
               torch.rand(1, 512, 512, 3, generator=gen, device="cuda") * 2 - 1,
               torch.rand(frames, 512, 512, 3, generator=gen, device="cuda") if image_hints
               else None)
              for _ in range(requests)]
    saved = os.environ.get("MAGICDANCE_FUSED_GN")
    if fused_gn:
        os.environ["MAGICDANCE_FUSED_GN"] = "1"
    torch.cuda.reset_peak_memory_stats()
    secs, per_request = [], []
    try:
        for pose, ref, img in inputs:
            K.reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = pipe.sample_frames(pose, ref, scfg, generator=gen, video=video,
                                     image_hints=img)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            per_request.append({m: n for m, n in K.LAUNCHES.items() if n})
            if tuple(out.shape) != (frames, 512, 512, 3) or not torch.isfinite(out).all():
                raise AssertionError(f"{label}: bad output {tuple(out.shape)}, finite="
                                     f"{bool(torch.isfinite(out).all())}")
    finally:
        if saved is None:
            os.environ.pop("MAGICDANCE_FUSED_GN", None)
        else:
            os.environ["MAGICDANCE_FUSED_GN"] = saved
    for i, got in enumerate(per_request):
        if got != plan:
            raise AssertionError(f"{label} request {i + 1}: launches {got}, plan {plan}")
    peak = torch.cuda.max_memory_allocated()
    log(f"  {label}: {requests} requests x {frames} frames, DDIM-{scfg.steps}: seconds per "
        f"request {[round(s, 3) for s in secs]}, frames/s {[round(frames / s, 4) for s in secs]}, "
        f"peak memory {peak / 2**30:.2f} GiB; launches per request {plan}")
    return dict(seconds_per_request=secs, frames=frames, steps=scfg.steps,
                frames_per_s=[frames / s for s in secs], peak_bytes=peak,
                launches_per_request=plan, launches={m: n * requests for m, n in plan.items()})


# --------------------------------------------------------------------------
# phase 2b: the kernel gate
# --------------------------------------------------------------------------


def kernel_gate():
    """`ops.kernel_gate.run_gate` on the card (every case printed); its wall
    time and the launches it made (comparisons with a reference: they count
    on no path)."""
    from magicdance_tpu_torch.ops import kernels as K
    from magicdance_tpu_torch.ops.kernel_gate import GATE_CASES, run_gate

    K.reset_launches()
    t0 = time.perf_counter()
    status = run_gate(device="cuda", verbose=True)
    secs = time.perf_counter() - t0
    launches = {m: n for m, n in K.LAUNCHES.items() if n}
    missing = {"self_attention", "self_attention_lse", "two_source_attention",
               "two_source_attention_lse", "two_source_attention_gated", "attention_dq",
               "attention_dq_two_source", "attention_dkv", "grouped", "grouped_bwd",
               "groupnorm_silu"} - set(launches)
    if status != "ok" or missing:
        raise AssertionError(f"kernel gate: {status}; kernels it did not reach: {missing}")
    log(f"  kernel gate {status}: {len(GATE_CASES)} cases in {secs:.1f} s (wall, the first "
        f"calls included); launches {launches}")
    return dict(status=status, seconds=secs, cases=len(GATE_CASES), launches=launches)


# --------------------------------------------------------------------------
# phases 19-21: DUAL_CONTROL serving, the PLMS and DPM-Solver++ samplers,
# a profile of one DDIM step
# --------------------------------------------------------------------------


def small_dual_check():
    """A narrow DUAL_CONTROL model at 128x128 (pose and image hints, 4 steps
    of CFG 7), card (kernels) vs CPU (plain versions), fp32, held to its
    launch plan."""
    import torch

    from magicdance_tpu_torch.config import SampleConfig
    from magicdance_tpu_torch.ops import kernels as K
    from magicdance_tpu_torch.pipeline import MagicPosePipeline

    cfg = narrow_dual_config()
    g = torch.Generator().manual_seed(9)
    pose, img = torch.rand(2, 128, 128, 3, generator=g), torch.rand(2, 128, 128, 3, generator=g)
    x_T = torch.randn(2, 16, 16, 4, generator=g)
    scfg = SampleConfig(steps=4)
    cpu = MagicPosePipeline(cfg, device="cpu")
    cpu.init_params(seed=4, scale=0.1)
    gpu = MagicPosePipeline(cfg, device="cuda")
    for name in ("model", "vae", "clip"):
        getattr(gpu, name).load_state_dict(getattr(cpu, name).state_dict())
    want = cpu.sample_frames(pose, None, scfg, x_T=x_T, image_hints=img)
    K.reset_launches()
    got = gpu.sample_frames(pose, None, scfg, x_T=x_T, image_hints=img).cpu()
    launches = {m: n for m, n in K.LAUNCHES.items() if n}
    plan = {m: n * scfg.steps for m, n in serving_launch_plan(cfg, 16, 2, 1).items()}
    for m, n in _vae_launches(cfg.vae, 16, 1).items():  # the decode's mid attention
        plan[m] = plan.get(m, 0) + n
    if launches != plan:
        raise AssertionError(f"narrow DUAL_CONTROL launches {launches}, plan {plan}")
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    tol = 1e-4 * max(1.0, scale)  # small_reference_check's bound
    if not (err <= tol and torch.isfinite(got).all()):
        raise AssertionError(f"DUAL_CONTROL card vs CPU: max abs err {err:.3e} > {tol:.3e}")
    log(f"  ok  narrow DUAL_CONTROL 128x128 4-step CFG-7 sample, card vs CPU: "
        f"max_abs_err={err:.3e} (tol {tol:.1e}), launches {launches} (plan)")
    return dict(max_abs_err=err, tol=tol, launches=launches)


SAMPLERS = ("plms", "dpmpp_2m", "dpmpp_3m_sde")


def sampler_requests(pipe, frames: int, steps: int):
    """One request of `frames` pose maps at 512x512 through each of the PLMS,
    DPM-Solver++ 2M and 3M (SDE, sde_eta = 1) samplers, `steps` steps, CFG 7,
    as a user composes them: CLIP and VAE encode from the pipeline, the
    sampler, the pipeline's decode. Each request is held to finite
    (F, 512, 512, 3) images, two model calls and one bank write per step,
    and the exact DDIM step's launch plan per step; seconds per request."""
    import torch

    from magicdance_tpu_torch.config import SampleConfig
    from magicdance_tpu_torch.ops import kernels as K
    from magicdance_tpu_torch.ops.schedules import make_ddim_schedule
    from magicdance_tpu_torch.sampling.dpm import dpmpp_2m_sample, dpmpp_3m_sample
    from magicdance_tpu_torch.sampling.plms import plms_sample

    scfg = SampleConfig(steps=steps)
    latent = 64
    plan = dict(request_launch_plan(pipe.cfg, latent, frames, scfg))
    # the VAE's mid attention (one encode, the decode's chunks of 8): a
    # kernel site only at narrow widths (D = 512 at SD1.5 width)
    for m, n in _vae_launches(pipe.cfg.vae, latent, 1 + -(-frames // 8)).items():
        plan[m] = plan.get(m, 0) + n
    gen = torch.Generator(device="cuda").manual_seed(11)
    calls = {"model": 0, "bank": 0}
    hooks = [pipe.model.register_forward_hook(lambda *a: calls.__setitem__("model",
                                                                           calls["model"] + 1)),
             pipe.model.appearance_unet.register_forward_hook(
                 lambda *a: calls.__setitem__("bank", calls["bank"] + 1))]
    out = {}
    torch.cuda.reset_peak_memory_stats()
    try:
        for name in SAMPLERS:
            pose = torch.rand(frames, 512, 512, 3, generator=gen, device="cuda")
            ref = torch.rand(1, 512, 512, 3, generator=gen, device="cuda") * 2 - 1
            x_T = torch.randn(1, 64, 64, 4, generator=gen,
                              device="cuda").expand(frames, -1, -1, -1).contiguous()
            calls.update(model=0, bank=0)
            K.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ctx, ref_lat = pipe.encode_empty(1), pipe.encode_reference(ref)
            kw = dict(reference_latent=ref_lat, pose_hint=pose)
            if name == "plms":
                lat = plms_sample(pipe.model, pipe.sched, make_ddim_schedule(pipe.sched, steps),
                                  scfg, x_T, ctx, ctx, **kw)
            elif name == "dpmpp_2m":
                lat = dpmpp_2m_sample(pipe.model, pipe.sched, steps, scfg, x_T, ctx, ctx, **kw)
            else:
                lat = dpmpp_3m_sample(pipe.model, pipe.sched, steps, scfg, x_T, ctx, ctx,
                                      sde_eta=1.0, generator=gen, **kw)
            img = pipe.decode_latents(lat)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = {m: n for m, n in K.LAUNCHES.items() if n}
            if tuple(img.shape) != (frames, 512, 512, 3) or not torch.isfinite(img).all():
                raise AssertionError(f"{name}: bad output {tuple(img.shape)}, finite="
                                     f"{bool(torch.isfinite(img).all())}")
            if calls != {"model": 2 * steps, "bank": steps} or launches != plan:
                raise AssertionError(f"{name}: model calls {calls}, launches {launches}; "
                                     f"expected {2 * steps} model calls, {steps} bank writes, "
                                     f"launches {plan}")
            out[name] = dict(seconds_per_request=secs, frames=frames, steps=steps,
                             frames_per_s=frames / secs, launches=launches,
                             model_calls=dict(calls))
            log(f"  {name}: 1 request x {frames} frames, {steps} steps, CFG {scfg.cfg_scale}: "
                f"{secs:.3f} s per request ({frames / secs:.4f} frames/s); per step "
                f"{calls['model'] // steps} model calls + {calls['bank'] // steps} bank write, "
                f"launches {({m: n // steps for m, n in launches.items()})} (plan)")
    finally:
        for h in hooks:
            h.remove()
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak memory over the three requests {peak / 2**30:.2f} GiB")
    return dict(out, peak_bytes=peak)


def profile_ddim_step(pipe, frames: int, out_dir: str):
    """One exact image DDIM step (bank write, ControlNet, cond pass reading
    the bank, uncond pass, update) at full width under
    `utils.profiling.trace`, after one warm-up step; the Chrome trace goes to
    `out_dir`. Returns the ten device operations with the most total time
    (kernels and copies, from the profiler's CUDA activity) with their
    counts, and the device time they and all operations sum to."""
    import torch

    from magicdance_tpu_torch.config import SampleConfig
    from magicdance_tpu_torch.ops.schedules import make_ddim_schedule
    from magicdance_tpu_torch.sampling.ddim import ddim_sample
    from magicdance_tpu_torch.utils.profiling import annotate, device_busy_ms, top_ops, trace

    gen = torch.Generator(device="cuda").manual_seed(13)
    pose = torch.rand(frames, 512, 512, 3, generator=gen, device="cuda")
    ref = torch.rand(1, 512, 512, 3, generator=gen, device="cuda") * 2 - 1
    x_T = torch.randn(frames, 64, 64, 4, generator=gen, device="cuda")
    ctx, ref_lat = pipe.encode_empty(1), pipe.encode_reference(ref)
    scfg = SampleConfig(steps=1)
    ddim = make_ddim_schedule(pipe.sched, 1)

    def step():
        return ddim_sample(pipe.model, pipe.sched, ddim, scfg, x_T, ctx, ctx,
                           reference_latent=ref_lat, pose_hint=pose)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with trace(out_dir, name="ddim_step") as prof:
        with annotate("ddim_step"):
            step()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    top = top_ops(prof, n=10)
    every = top_ops(prof, n=10**6)
    total = sum(r["total_ms"] for r in every)
    busy, span = device_busy_ms(prof)
    if not top:
        raise AssertionError("the profiler recorded no device activity")
    path = os.path.join(out_dir, "ddim_step.json")
    log(f"  one DDIM step (F = {frames}) profiled: {wall:.1f} ms wall with the profiler on; "
        f"{len(every)} device operation names, {sum(r['count'] for r in every)} launches, "
        f"{total:.3f} ms of device time, busy {busy:.3f} of a {span:.3f} ms span (idle "
        f"{1 - busy / span:.1%}); trace {os.path.relpath(path, ROOT)} "
        f"({os.path.getsize(path) / 2**20:.1f} MiB)")
    for i, r in enumerate(top, 1):
        log(f"  {i:2d}. {r['total_ms']:8.3f} ms  x{r['count']:<4d} {r['name'][:120]}")
    return dict(wall_ms=wall, device_total_ms=total, busy_ms=busy, span_ms=span, top=top,
                trace=os.path.relpath(path, ROOT))


# --------------------------------------------------------------------------
# phase 22: a reference checkpoint through the sampling CLI
# --------------------------------------------------------------------------


def cli_plan(cfg, scfg, frames: int, video: bool = False) -> dict:
    """Kernel launches of one `cli.sample.generate` request: the sampler's
    (`request_launch_plan`) plus the VAE's mid attention in one encode and
    the decode's chunks of 8 (a kernel site only at narrow widths)."""
    plan = dict(request_launch_plan(cfg, 64, frames, scfg, frames=frames if video else 1,
                                    video=video))
    for m, n in _vae_launches(cfg.vae, 64, 1 + -(-frames // 8)).items():
        plan[m] = plan.get(m, 0) + n
    return {m: n for m, n in plan.items() if n}


def cli_request(args, pipe, ref, poses, label: str, card: str):
    """`cli.sample.generate` on numpy inputs, held to `cli_plan` and to
    uint8 frames of the right shape from finite, non-constant images."""
    import warnings

    import numpy as np
    import torch

    from magicdance_tpu_torch.cli import sample as S
    from magicdance_tpu_torch.ops import kernels as K

    plan = cli_plan(pipe.cfg, S.sample_config(args), len(poses), video=args.video)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        # from_model_range warns on non-finite pixels: fail on them instead
        warnings.simplefilter("error", RuntimeWarning)
        frames = S.generate(args, pipe, ref, poses)
    secs = time.perf_counter() - t0
    launches = {m: n for m, n in K.LAUNCHES.items() if n}
    peak = torch.cuda.max_memory_allocated()
    want = (len(poses), args.size, args.size, 3)
    if frames.dtype != np.uint8 or frames.shape != want or frames.std() == 0:
        raise AssertionError(f"{label}: frames {frames.dtype} {frames.shape} (want uint8 "
                             f"{want}), std {frames.std():.3f}")
    if launches != plan:
        raise AssertionError(f"{label}: launches {launches}, plan {plan}")
    log(f"  {label}: 1 request x {len(poses)} frames, DDIM-{args.steps}, CFG {args.cfg}: "
        f"{secs:.3f} s ({len(poses) / secs:.4f} frames/s), peak memory {peak / 2**30:.2f} GiB "
        f"[{card}]; uint8 {frames.shape}; launches {launches} = plan")
    return dict(seconds=secs, frames=len(poses), steps=args.steps, peak_bytes=peak,
                launches=launches, plan=plan)


def sample_cli_checkpoint(card: str, frames: int = 2, steps: int = 50, video_frames: int = 16,
                          video_steps: int = 10):
    """Phase 22: a seeded reference-layout `model_state` file for
    `ModelConfig()` (the current layout: `model.diffusion_model.*`,
    `appearance_control_model.*`, `pose_control_model.*`,
    `first_stage_model.*`, `cond_stage_model.transformer.*`), one draw per
    key of `convert.torch_convert.reference_key_map` at its reference shape,
    saved as fp16; `cli.sample` with `--checkpoint` that file: every loaded
    parameter bit-equal to its drawn tensor cast to the parameter's dtype,
    one request through `generate` (F = `frames`, DDIM-`steps`, CFG 7) held to
    its launch plan; then `--video` without a checkpoint (16 frames, one
    window, DDIM-`video_steps`). The file is deleted at the end."""
    import numpy as np
    import torch

    from magicdance_tpu_torch.cli import sample as S
    from magicdance_tpu_torch.config import ModelConfig
    from magicdance_tpu_torch.convert import torch_convert as TC
    from magicdance_tpu_torch.data.transforms import to_hint_range, to_model_range

    t_phase = time.perf_counter()
    cfg = ModelConfig()
    pairs = TC.reference_key_map(cfg)
    shapes = TC.reference_shapes(cfg, pairs)
    gen = torch.Generator(device="cuda").manual_seed(22)
    drawn = {ref: (torch.randn(shape, generator=gen, device="cuda") * 0.02).half()
             for ref, shape in shapes.items()}
    n_params = sum(t.numel() for t in drawn.values())
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "phase22_model_state.th")
    rs = np.random.RandomState(22)
    ref = to_model_range(rs.randint(0, 256, (512, 512, 3)).astype(np.uint8))[None]
    poses = to_hint_range(rs.randint(0, 256, (frames, 512, 512, 3)).astype(np.uint8))
    out = {}
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.save({k: v.cpu() for k, v in drawn.items()}, path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        states = TC.convert_magicpose_state(TC.load_torch_state(path), cfg)
        convert_s = time.perf_counter() - t0
        del states
        args = S.build_argparser().parse_args(
            ["--checkpoint", path, "--reference", "(arrays)", "--pose_dir", "(arrays)",
             "--output", out_dir, "--steps", str(steps), "--cfg", "7", "--seed", "22"])
        t0 = time.perf_counter()
        pipe = S.build_pipeline(args)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        log(f"  {len(pairs)} reference keys, {n_params / 1e9:.3f} B parameters drawn on the "
            f"card (fp16); saved {size} bytes in {save_s:.2f} s; load + convert alone "
            f"{convert_s:.2f} s; cli.sample.build_pipeline (construct, load, convert, strict "
            f"load onto the card) {build_s:.2f} s [{card}]")
        params = {f"{name}.{k}": t for name in ("model", "vae", "clip")
                  for k, t in getattr(pipe, name).state_dict().items()}
        if len(params) != len(pairs):
            raise AssertionError(f"{len(params)} parameters, {len(pairs)} reference keys")
        bad = [port for ref_key, port in pairs
               if not torch.equal(params[port], drawn[ref_key].to(params[port].dtype))]
        dtypes = sorted({str(t.dtype) for t in params.values()})
        if bad:
            raise AssertionError(f"{len(bad)} loaded parameters differ from the drawn "
                                 f"tensors, e.g. {bad[:5]}")
        log(f"  every one of the {len(pairs)} parameters equals its drawn tensor cast to "
            f"the parameter's dtype ({dtypes}), bit for bit on the card")
        del drawn
        out["image"] = cli_request(args, pipe, ref, poses, "cli.sample --checkpoint", card)
        out.update(keys=len(pairs), parameters=n_params, file_bytes=size, save_s=save_s,
                   load_convert_s=convert_s, build_pipeline_s=build_s)
    finally:
        if os.path.exists(path):
            os.remove(path)
    del pipe
    torch.cuda.empty_cache()

    vargs = S.build_argparser().parse_args(
        ["--video", "--reference", "(arrays)", "--pose_dir", "(arrays)", "--output", out_dir,
         "--steps", str(video_steps), "--seed", "22"])
    t0 = time.perf_counter()
    vpipe = S.build_pipeline(vargs)
    torch.cuda.synchronize()
    log(f"  cli.sample --video: temporal pipeline with seeded random weights in "
        f"{time.perf_counter() - t0:.2f} s")
    vposes = to_hint_range(rs.randint(0, 256, (video_frames, 512, 512, 3)).astype(np.uint8))
    out["video"] = cli_request(vargs, vpipe, ref, vposes, "cli.sample --video", card)
    del vpipe
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 22 in {out['phase_s']:.1f} s [{card}]")
    return out


# --------------------------------------------------------------------------
# phase 23: OpenPose on the card
# --------------------------------------------------------------------------


class _KeyEcho(dict):
    """Every key maps to itself: an OpenPose converter run on it returns
    {port key: reference key}, the key table of its checkpoint."""

    def __getitem__(self, key):
        return key


def openpose_nets(seed: int = 23):
    """The body, hand and face nets on the CPU from seeded state dicts in the
    `body_pose_model.pth` / `hand_pose_model.pth` / `facenet.pth` key layouts
    (He-scaled weights, N(0, 0.1^2) biases), through the port's converters."""
    import torch

    from magicdance_tpu_torch.models import openpose as O

    gen = torch.Generator().manual_seed(seed)
    nets = {}
    for name, make, convert in (("body", O.BodyPoseNet, O.convert_body_pose),
                                ("hand", O.HandPoseNet, O.convert_hand_pose),
                                ("face", O.FacePoseNet, O.convert_face_pose)):
        net = make()
        shapes = {k: v.shape for k, v in net.state_dict().items()}
        sd = {}
        for port, ref in sorted(convert(_KeyEcho()).items()):
            shape = shapes[port]
            scale = (2.0 / shape[1:].numel()) ** 0.5 if port.endswith(".weight") else 0.1
            sd[ref] = torch.randn(shape, generator=gen) * scale
        net.load_state_dict(convert(sd), strict=True)
        nets[name] = net.eval()
    return nets


def openpose_on_card(card: str):
    """Phase 23: the OpenPose nets on the card against the same nets on the
    CPU (fp32, TF32 off) at the detector's inputs -- the body net on a
    512x512 frame resized to BOXSIZE = 368 and padded to stride 8, the hand
    and face nets on a ROI resized to 368 -- held to 2e-4 x max(1,
    max|CPU|); the milliseconds of each net on the card; with cv2 present,
    the whole `OpenposeDetector` on one seeded 512x512 frame on both devices:
    equal keypoint counts, and its milliseconds per frame."""
    import copy
    import importlib.util

    import numpy as np
    import torch

    from magicdance_tpu_torch.data.openpose_detect import BOXSIZE, STRIDE
    from magicdance_tpu_torch.utils.timing import device_time_ms

    t_phase = time.perf_counter()
    cpu_nets = openpose_nets()
    gpu_nets = {k: copy.deepcopy(v).to("cuda") for k, v in cpu_nets.items()}
    side = BOXSIZE + (-BOXSIZE) % STRIDE
    gen = torch.Generator().manual_seed(230)
    out = {}
    for name in ("body", "hand", "face"):
        x = torch.rand(1, 3, side, side, generator=gen) - 0.5
        with torch.inference_mode():
            want = cpu_nets[name](x)
            got = gpu_nets[name](x.cuda())
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        err = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
        scale = max(float(w.abs().max()) for w in want)
        tol = 2e-4 * max(1.0, scale)
        xg = x.cuda()
        with torch.inference_mode():
            ms = device_time_ms(lambda: gpu_nets[name](xg), min_total_s=0.2, max_iters=20)
        shapes = [tuple(g.shape) for g in got]
        log(f"  {name} net at (1, 3, {side}, {side}): outputs {shapes}, card vs CPU max abs "
            f"diff {err:.3e} (tol {tol:.3e}, max|CPU| {scale:.3f}); {ms:.3f} ms a call on "
            f"the card [{card}]")
        if not err <= tol:
            raise AssertionError(f"{name} net: card vs CPU {err:.3e} > {tol:.3e}")
        out[name] = dict(max_abs_err=err, tol=tol, max_abs_cpu=scale, ms=ms, input=[1, 3, side,
                                                                                  side])
    if importlib.util.find_spec("cv2") is None:
        log("  cv2 is not installed here: the detector's host part (resize, peaks, PAF "
            "grouping) is not run; the nets ran alone")
    else:
        from magicdance_tpu_torch.data.openpose_detect import OpenposeDetector
        from magicdance_tpu_torch.data.pose import keypoint_quality

        frame = np.random.RandomState(23).randint(0, 256, (512, 512, 3)).astype(np.uint8)
        results = {}
        for dev, nets in (("cpu", cpu_nets), ("cuda", gpu_nets)):
            det = OpenposeDetector(device=dev)
            det.nets.update(nets)
            res = det(frame)
            if dev == "cuda":  # the first call warmed it up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                det(frame)
                torch.cuda.synchronize()
                out["detector_ms_per_frame"] = (time.perf_counter() - t0) * 1e3
            results[dev] = dict(
                people=len(res.body), body_keypoints=keypoint_quality(res),
                hands=0 if res.hands is None else len(res.hands),
                hand_keypoints=0 if res.hands is None else int((res.hands[..., 0] >= 0).sum()),
                faces=0 if res.faces is None else len(res.faces),
                face_keypoints=0 if res.faces is None else int((res.faces[..., 0] >= 0).sum()))
        if results["cpu"] != results["cuda"]:
            raise AssertionError(f"detector keypoint counts differ: {results}")
        out["detector_counts"] = results["cuda"]
        log(f"  OpenposeDetector (body, hands, faces) on a seeded 512x512 frame: keypoint "
            f"counts {results['cuda']} on the card and the CPU alike; "
            f"{out['detector_ms_per_frame']:.1f} ms per frame on the card (host clock, "
            f"cv2 and the PAF grouping included) [{card}]")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 23 in {out['phase_s']:.1f} s [{card}]")
    return out


# --------------------------------------------------------------------------
# phase 24: evaluation on the card (cli.eval, the metric drivers and nets)
# --------------------------------------------------------------------------

PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 (CUDA cores, no tensor cores)
EVAL_TYPES = ["l1", "mae", "ssim", "psnr", "lpips", "fid", "fid-img", "is", "fvd", "fid-vid"]
# the torchvision VGG16 conv indices of LPIPS's 13 convs, and the lpips
# package's slice holding each
_LPIPS_TV = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
_LPIPS_SLICE = [1, 1, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5]
CLIP_L14 = dict(hidden_size=1024, num_layers=24, num_heads=16, patch_size=14,
                projection_dim=768, image_size=224)


def _metric_ref_keys(net: str, key: str, shape: tuple) -> list:
    """(reference key, how it is drawn, shape) behind one port parameter of
    a metric net: lpips (`lpips.LPIPS(net='vgg')`), inception (torchvision
    `inception_v3`, its BN folded into the conv at load, so one port weight
    stands for a conv and a BN and the port's bias for none), i3d
    (`i3d_pretrained_400.pt`), r3d (`resnet-50-kinetics.pth`), clip (HF
    `CLIPModel` vision keys)."""
    prefix, _, leaf = key.rpartition(".")
    kind = "he" if len(shape) >= 2 else {"weight": "scale", "running_var": "var"}.get(leaf, "small")
    if net == "lpips":
        if key.startswith("vgg.conv_"):
            ci = int(prefix.split("_")[1])
            return [(f"net.slice{_LPIPS_SLICE[ci]}.{_LPIPS_TV[ci]}.{leaf}", kind, shape)]
        return [(f"lin{prefix.split('_')[1]}.model.1.weight", "lin", shape)]
    if net == "inception":
        if prefix == "fc":
            return [(key, kind, shape)]
        if leaf == "bias":
            return []
        c = (shape[0],)
        return [(f"{prefix}.conv.weight", "he", shape), (f"{prefix}.bn.weight", "scale", c),
                (f"{prefix}.bn.bias", "small", c), (f"{prefix}.bn.running_mean", "small", c),
                (f"{prefix}.bn.running_var", "var", c)]
    if net == "i3d":
        return [(key.replace(".conv.", ".conv3d."), kind, shape)]
    if net == "r3d":
        ref = re.sub(r"^layer(\d)_(\d+)\.", r"layer\1.\2.", key)
        ref = ref.replace("downsample_conv.", "downsample.0.").replace("downsample_bn.",
                                                                        "downsample.1.")
        return [(f"module.{ref}", kind, shape)]
    p = "vision_model"
    if key == "class_embedding":
        return [(f"{p}.embeddings.class_embedding", "small", shape)]
    if key == "position_embedding":
        return [(f"{p}.embeddings.position_embedding.weight", "small", shape)]
    if key == "patch_embedding.weight":
        return [(f"{p}.embeddings.patch_embedding.weight", "he", shape)]
    if key == "visual_projection.weight":
        return [(key, "he", shape)]
    if prefix == "pre_layernorm":
        return [(f"{p}.pre_layrnorm.{leaf}", kind, shape)]
    if prefix == "post_layernorm":
        return [(f"{p}.post_layernorm.{leaf}", kind, shape)]
    i, rest = re.match(r"layer_(\d+)\.(.*)", key).groups()
    rest = re.sub(r"^fc([12])\.", r"mlp.fc\1.", rest)
    return [(f"{p}.encoder.layers.{i}.{rest}", kind, shape)]


def metric_nets():
    """Constructors of the port's metric nets at full width, by the name
    phase 24 gives their reference-layout files."""
    from magicdance_tpu_torch.metrics.clip_score import CLIPVisionEncoder
    from magicdance_tpu_torch.metrics.i3d import I3D
    from magicdance_tpu_torch.metrics.inception import InceptionV3
    from magicdance_tpu_torch.metrics.lpips import LPIPS
    from magicdance_tpu_torch.metrics.resnet3d import ResNet3D

    return {"lpips": LPIPS, "inception": InceptionV3, "i3d": I3D, "r3d": ResNet3D,
            "clip": lambda: CLIPVisionEncoder(**CLIP_L14)}


def metric_reference_states(seed: int = 24, device: str = "cuda") -> dict:
    """Seeded full-width state dicts in the reference layouts (fp32 CPU
    tensors): the LPIPS VGG16, torchvision InceptionV3, I3D at width 1.0,
    3D-ResNet50 and CLIP ViT-L/14 at 224^2. Conv and linear weights He-scaled
    (N(0, 2 / fan_in)), so the features differ from image to image; norm
    scales 1 + N(0, 0.1^2), BN variances U(0.5, 1.5), biases, means and
    embeddings N(0, 0.1^2); LPIPS's lin weights |He|. Drawn on `device`."""
    import math

    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    states = {}
    for net, make in metric_nets().items():
        with torch.device("meta"):
            shapes = {k: tuple(v.shape) for k, v in make().state_dict().items()}
        sd = {}
        for key, shape in shapes.items():
            for ref, kind, ref_shape in _metric_ref_keys(net, key, shape):
                if kind == "var":
                    x = torch.rand(ref_shape, generator=gen, device=device) + 0.5
                else:
                    x = torch.randn(ref_shape, generator=gen, device=device)
                if kind in ("he", "lin"):
                    x = x * (2.0 / math.prod(ref_shape[1:])) ** 0.5
                    x = x.abs() if kind == "lin" else x
                elif kind == "scale":
                    x = 1 + 0.1 * x
                elif kind == "small":
                    x = 0.1 * x
                sd[ref] = x.cpu()
        states[net] = sd
    return states


def write_eval_tree(root: str, videos: int = 2, frames: int = 8, size: int = 512,
                    seed: int = 24) -> None:
    """A seeded TikTok-layout tree: `videos` videos, each a reference (frame
    0) and `frames` targets, with their pose maps, uint8 noise at size^2."""
    import numpy as np
    from PIL import Image

    rs = np.random.RandomState(seed)
    for split in ("disco_test_set", "pose_map_disco_test_set"):
        for v in range(videos):
            d = os.path.join(root, split, f"vid{v}")
            os.makedirs(d)
            for i in range(frames + 1):
                Image.fromarray(rs.randint(0, 256, (size, size, 3)).astype(np.uint8)).save(
                    os.path.join(d, f"{i:04d}.png"))


def count_flops(net, *inputs, attention: float = 0.0) -> float:
    """Floating-point operations of one call, from the layer shapes: 2 per
    multiply-add of every Conv2d/Conv3d/Linear (via forward hooks on one
    call), plus `attention` (the attention products, which are no module)."""
    import math

    import torch
    from torch import nn

    total = [attention]

    def hook(m, _inp, out):
        if isinstance(m, (nn.Conv2d, nn.Conv3d)):
            total[0] += 2.0 * out.numel() * (m.in_channels // m.groups) * math.prod(m.kernel_size)
        else:
            total[0] += 2.0 * out.numel() * m.in_features

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear))]
    try:
        with torch.inference_mode():
            net(*inputs)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def metric_nets_on_card(card: str, states: dict, frames: dict) -> dict:
    """Phase 24c: each metric net from its reference-layout state dict
    through the port's converter, on the CPU and on the card, at one batch
    of the drivers' inputs (2 images, or 1 clip), fp32 with TF32 off: card
    within 2e-4 x max(1, max|CPU|); the card's ms per call, the FLOPs of the
    call from the layer shapes and their share of the fp32 peak; SSIM on
    near-constant frames <= 1 on the card."""
    import copy

    import numpy as np
    import torch

    from magicdance_tpu_torch.device import full_fp32
    from magicdance_tpu_torch.metrics import clip_score, core, i3d, inception, lpips, resnet3d
    from magicdance_tpu_torch.metrics.center import luma_uint8
    from magicdance_tpu_torch.utils.timing import device_time_ms

    converts = {"lpips": lpips.convert_lpips_torch_state,
                "inception": inception.convert_inception_torchvision,
                "i3d": i3d.convert_i3d, "r3d": resnet3d.convert_resnet3d,
                "clip": clip_score.convert_clip_vision}
    gen, gt = frames["gen"], frames["gt"]
    rs = np.random.RandomState(240)
    clip_in = np.stack([clip_score.preprocess_clip_image(x) for x in gen[:2]])
    npos = (CLIP_L14["image_size"] // CLIP_L14["patch_size"]) ** 2 + 1
    inputs = {
        "lpips": (gen[:2] / 127.5 - 1.0, gt[:2] / 127.5 - 1.0),  # (2, 512, 512, 3) pairs
        "inception": (rs.rand(2, 299, 299, 3) * 2 - 1,),
        "i3d": (frames["i3d"][None] / 127.5 - 1.0,),  # one video, 10 frames at 224^2
        "r3d": (frames["r3d"][None] - np.asarray(resnet3d.KINETICS_PIXEL_MEAN),),  # 16 at 112^2
        "clip": (clip_in,),
    }
    attention = {"clip": 4.0 * 2 * npos * npos * CLIP_L14["hidden_size"]
                 * CLIP_L14["num_layers"]}
    out = {}
    for name, make in metric_nets().items():
        cpu_net = make()
        cpu_net.load_state_dict(converts[name](states[name]), strict=True)
        cpu_net.eval().requires_grad_(False)
        gpu_net = copy.deepcopy(cpu_net).to("cuda")
        x_cpu = tuple(torch.as_tensor(np.asarray(a, np.float32)) for a in inputs[name])
        x_card = tuple(a.cuda() for a in x_cpu)
        with torch.inference_mode(), full_fp32():
            # InceptionV3 returns (pool, logits): both are compared
            want = torch.cat([w.reshape(-1) for w in _as_tuple(cpu_net(*x_cpu))])
            got = torch.cat([g.reshape(-1) for g in _as_tuple(gpu_net(*x_card))])
            err = float((got.cpu() - want).abs().max())
            scale = float(want.abs().max())
            tol = 2e-4 * max(1.0, scale)
            ms = device_time_ms(lambda: gpu_net(*x_card), min_total_s=0.2, max_iters=20)
            flops = count_flops(gpu_net, *x_card, attention=attention.get(name, 0.0))
        share = flops / (ms * 1e-3) / PEAK_FP32_FLOPS
        shapes = [list(a.shape) for a in x_cpu]
        log(f"  {name} at {shapes}: card vs CPU max abs diff {err:.3e} (tol {tol:.3e}, "
            f"max|CPU| {scale:.3f}); {ms:.3f} ms a call on the card, {flops / 1e9:.1f} GFLOP, "
            f"{share:.1%} of the 67 TFLOP/s fp32 peak [{card}]")
        if not err <= tol:
            raise AssertionError(f"{name}: card vs CPU {err:.3e} > {tol:.3e}")
        out[name] = dict(input=shapes, max_abs_err=err, tol=tol, max_abs_cpu=scale, ms=ms,
                         gflop=flops / 1e9, share_of_fp32_peak=share)
        del cpu_net, gpu_net
        torch.cuda.empty_cache()

    # SSIM with TF32 allowed process-wide (PyTorch's default for cuDNN):
    # the metric must turn it off for its window sums by itself
    near = (0.5 + rs.rand(1, 64, 64, 1) * 0.02).astype(np.float32)
    structured = rs.rand(1, 64, 64, 1).astype(np.float32)
    luma = luma_uint8(gen[:2])[..., None].astype(np.float32) / 255.0
    luma_gt = luma_uint8(gt[:2])[..., None].astype(np.float32) / 255.0
    values = {}
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        for label, a, b in (("near-constant vs structured", near, structured),
                            ("generated vs ground-truth luma", luma, luma_gt)):
            on_card = float(core.ssim(torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()))
            on_cpu = float(core.ssim(torch.from_numpy(a), torch.from_numpy(b)))
            values[label] = dict(card=on_card, cpu=on_cpu)
            if not (-1.0 <= on_card <= 1.0 and abs(on_card - on_cpu) <= 1e-5):
                raise AssertionError(f"SSIM {label}: card {on_card}, CPU {on_cpu}")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    log(f"  SSIM on the card with TF32 allowed outside the metric: within [-1, 1] and 1e-5 "
        f"of the CPU: {values}")
    out["ssim_checks"] = values
    return out


def eval_on_card(card: str, videos: int = 2, frames: int = 8, steps: int = 50):
    """Phase 24: (a) `cli.eval.main` on a seeded TikTok-layout tree
    (`videos` videos, each a reference and `frames` targets at 512x512) at
    full `ModelConfig()` width with random weights, DDIM-`steps`, CFG 7,
    `--batch frames`: one request of F = `frames` per video, the launches
    held to the request plan, seconds per request and frames/s; (b)
    `get_all_eval_scores` on the written tree with every type through
    seeded full-width reference-layout files (LPIPS VGG16, torchvision
    InceptionV3, I3D, 3D-ResNet50), FID-Img with 2 frames a video beside
    it, and the CLIP ViT-L/14 image similarity; (c) `metric_nets_on_card`.
    The files and the tree are deleted at the end."""
    import shutil
    import warnings

    import numpy as np
    import torch
    from PIL import Image

    from magicdance_tpu_torch.cli import eval as E
    from magicdance_tpu_torch.cli import sample as S
    from magicdance_tpu_torch.config import ModelConfig
    from magicdance_tpu_torch.metrics.center import get_all_eval_scores
    from magicdance_tpu_torch.metrics.clip_score import CLIPScorer
    from magicdance_tpu_torch.ops import kernels as K

    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "chiprun_out", "phase24")
    shutil.rmtree(work, ignore_errors=True)
    data, out_root = os.path.join(work, "tiktok"), os.path.join(work, "eval_out")
    out = {}
    try:
        write_eval_tree(data, videos=videos, frames=frames)
        argv = ["--data", data, "--output", out_root, "--steps", str(steps), "--cfg", "7",
                "--size", "512", "--batch", str(frames), "--seed", "24"]
        args = E.build_argparser().parse_args(argv)
        plan = {m: n * videos for m, n in cli_plan(ModelConfig(), S.sample_config(args),
                                                    frames).items()}
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            # from_model_range warns on non-finite pixels: fail on them instead
            warnings.simplefilter("error", RuntimeWarning)
            records = E.main(argv)
        main_s = time.perf_counter() - t0
        launches = {m: n for m, n in K.LAUNCHES.items() if n}
        if launches != plan:
            raise AssertionError(f"cli.eval: launches {launches}, plan {plan}")
        if [r["frames"] for r in records] != [frames] * videos:
            raise AssertionError(f"cli.eval records {records}")
        for v in range(videos):
            for sub in ("gen_images", "gt_images", "pose_maps"):
                names = sorted(os.listdir(os.path.join(out_root, f"vid{v}", sub)))
                if names != [f"{i:04d}.png" for i in range(1, frames + 1)]:
                    raise AssertionError(f"vid{v}/{sub}: {names}")
            img = np.asarray(Image.open(os.path.join(out_root, f"vid{v}", "gen_images",
                                                     "0001.png")))
            if img.shape != (512, 512, 3) or img.std() == 0:
                raise AssertionError(f"vid{v}: generated frame {img.shape}, std {img.std()}")
        secs = [r["seconds"] for r in records]
        out["generation"] = dict(seconds_per_request=secs, frames=frames, steps=steps,
                                 frames_per_s=[frames / s for s in secs], main_s=main_s,
                                 peak_bytes=torch.cuda.max_memory_allocated(),
                                 launches=launches, plan=plan)
        log(f"  cli.eval: {videos} videos x 1 request of F = {frames} at 512x512, DDIM-{steps}, "
            f"CFG 7: {[round(s, 3) for s in secs]} s per request "
            f"({[round(frames / s, 4) for s in secs]} frames/s), main() {main_s:.2f} s "
            f"(pipeline build, dataset, PNG writes included), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]; launches "
            f"{launches} = plan")
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        states = metric_reference_states()
        files = {}
        for name, sd in states.items():
            files[name] = os.path.join(work, f"{name}.pth")
            torch.save({"state_dict": sd} if name == "r3d" else sd, files[name])
        log(f"  reference-layout files: "
            f"{ {k: sum(t.numel() for t in v.values()) for k, v in states.items()} } parameters "
            f"drawn and saved in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        scores = get_all_eval_scores(
            out_root, EVAL_TYPES, lpips_weights=files["lpips"],
            inception_weights=files["inception"], i3d_weights=files["i3d"],
            resnet3d_weights=files["r3d"], device="cuda")
        scores_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sampled = get_all_eval_scores(out_root, ["fid-img"], inception_weights=files["inception"],
                                      sample_frames=2, device="cuda")["fid-img"]
        sampled_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        clip = CLIPScorer(files["clip"], device="cuda")
        sims = [clip.image_similarity(os.path.join(out_root, f"vid{v}", "gen_images"),
                                      os.path.join(out_root, f"vid{v}", "gt_images"))
                for v in range(videos)]
        clip_s = time.perf_counter() - t0
        del clip
        want_keys = {"l1", "mae", "ssim", "psnr", "lpips", "fid", "fid-img", "is_mean", "is_std",
                     "fvd", "fid-vid", "num_images"}
        bad = [k for k, v in scores.items() if not np.isfinite(v)]
        if set(scores) != want_keys or bad or scores["num_images"] != videos * frames:
            raise AssertionError(f"scores {scores}")
        if not (0.0 <= scores["ssim"] <= 1.0 and scores["fid"] > 0 and scores["fvd"] > 0
                and scores["fid-vid"] > 0 and scores["fid-img"] == scores["fid"]
                and abs(sampled - scores["fid-img"]) > 1e-3
                and all(-1.0 <= x <= 1.0 for x in sims)):
            raise AssertionError(f"scores {scores}, fid-img at 2 frames {sampled}, clip {sims}")
        out["scores"] = dict(values=scores, fid_img_2_frames=sampled, clip_similarity=sims,
                             seconds=scores_s, fid_img_2_frames_s=sampled_s, clip_s=clip_s)
        log(f"  get_all_eval_scores(every type) on the {videos * frames} frames: {scores} in "
            f"{scores_s:.1f} s; fid-img with 2 frames a video {sampled:.4f} "
            f"({sampled_s:.1f} s; fid-img = fid with all frames); CLIP ViT-L/14 image "
            f"similarity per video {sims} ({clip_s:.1f} s) [{card}]")

        gen = np.stack([np.asarray(Image.open(os.path.join(out_root, "vid0", "gen_images", n)))
                        for n in sorted(os.listdir(os.path.join(out_root, "vid0", "gen_images")))])
        gt = np.stack([np.asarray(Image.open(os.path.join(out_root, "vid0", "gt_images", n)))
                       for n in sorted(os.listdir(os.path.join(out_root, "vid0", "gt_images")))])

        def video(size, length):  # the drivers' resize and last-frame tail padding
            fr = [np.asarray(Image.fromarray(f).resize((size, size), Image.BILINEAR)) for f in gen]
            return np.stack(fr + [fr[-1]] * (length - len(fr))).astype(np.float32)

        out["nets"] = metric_nets_on_card(card, states, dict(
            gen=gen.astype(np.float32), gt=gt.astype(np.float32), i3d=video(224, 10),
            r3d=video(112, 16)))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 24 in {out['phase_s']:.1f} s [{card}]")
    return out


# --------------------------------------------------------------------------
# phase 18: the head-packing probe and kernel K9
# --------------------------------------------------------------------------


def packed_bound_ms(bg, sq, s, g, gd, itemsize=2) -> tuple[float, str]:
    """Least time of one K9 launch: QK^T and PV over the whole G*D width
    (the zeros of block-diagonal K/V included: the function contracts
    them), 4 x Sq x G*S x G*D operations per BG row over the bf16 peak, vs
    qp, kbd and vbd read once and o written once over the memory rate."""
    flops = 4.0 * bg * sq * g * s * gd
    nbytes = itemsize * bg * gd * (2 * sq + 2 * g * s)
    t_ops, t_mem = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def check_packed_kernel():
    """Phase 18a: K9 against its plain version at the probe's shape (K/V
    packed block-diagonally from random heads, as the probe packs them) and
    at a small ragged shape (random kbd/vbd, S = 300, Sq = 200), bf16 and
    fp32; kernel A against its plain version on the same unpacked q, k, v
    (BSNH, the shape P3 gives it); the probe's shape timed in bf16 against its bound, the plain
    version and the library call (SDPA on the unpacked per-head tensors,
    which computes the same result for block-diagonal K/V; a yardstick
    only)."""
    import torch
    import torch.nn.functional as F

    from magicdance_tpu_torch.ops import kernels as K
    from magicdance_tpu_torch.ops.kernels import packed as P
    from magicdance_tpu_torch.scripts.bench_head_packing import P3_SHAPE
    from magicdance_tpu_torch.utils.timing import device_time_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5678)
    errs, checked, rows = {}, {}, []

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    b, h, s, d, g = (P3_SHAPE[key] for key in ("B", "H", "S", "D", "G"))
    bg, gd = b * h // g, g * d
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
        q, k, v = (rnd(b, s, h, d, dtype=dtype) for _ in range(3))
        qp, kbd, vbd = P.pack_heads(q, g), P.blockdiag(k, g), P.blockdiag(v, g)
        label = f"{str(dtype)[6:]} BG={bg} S={s} G={g} D={d} block-diagonal"
        check(errs, checked, "packed_attention", P.packed_attention(qp, kbd, vbd, g),
              P.packed_attention_ref(qp, kbd, vbd, g), tol, label)
        if dtype == torch.bfloat16:
            ms = device_time_ms(lambda: P.packed_attention(qp, kbd, vbd, g))
            plain_ms = device_time_ms(lambda: P.packed_attention_ref(qp, kbd, vbd, g),
                                      min_total_s=0.1, max_iters=3)
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            lib_ms = device_time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
            bound, bound_by = packed_bound_ms(bg, s, s, g, gd)
            rows.append(dict(kernel="packed_attention", BG=bg, Sq=s, S=s, G=g, D=d,
                             launches_per_step=1, kernel_ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bound, bound_by=bound_by,
                             exp_bound_ms=exp_bound_ms(bg, s, g, [(bg, s)])))
            log(f"      kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                f"bound_ms={bound:.4f} ({bound_by}) exp_bound_ms={rows[-1]['exp_bound_ms']:.4f}")
        # P3's other side: kernel A per head on the same q, k, v (the plain
        # version over 8 batch rows at a time, to bound its fp32 logits)
        want = torch.cat([K.self_attention_ref(q[i:i + 8], k[i:i + 8], v[i:i + 8])
                          for i in range(0, b, 8)])
        check(errs, checked, "self_attention", K.self_attention(q, k, v), want, tol,
              f"{str(dtype)[6:]} BSNH B={b} S={s} H={h} D={d} (P3's per-head side)")
        del q, k, v, qp, kbd, vbd, want
        torch.cuda.empty_cache()
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
        qp = rnd(3, 200, gd, dtype=dtype)
        kbd, vbd = (rnd(3, g * 300, gd, dtype=dtype) for _ in range(2))
        check(errs, checked, "packed_attention", P.packed_attention(qp, kbd, vbd, g),
              P.packed_attention_ref(qp, kbd, vbd, g), tol,
              f"{str(dtype)[6:]} ragged BG=3 Sq=200 S=300 G={g} D={d} random K/V")
    return rows, errs, checked


def head_packing_probe():
    """Phase 18b: the probe as a user runs it (P1-P4), with every launch
    count at 0 just before it; P3's two outputs must agree within the bf16
    gate. Returns (numbers, launches)."""
    import torch

    from magicdance_tpu_torch.ops import kernels as K
    from magicdance_tpu_torch.scripts import bench_head_packing as probe

    K.reset_launches()
    result = probe.run_all(torch.device("cuda"), lambda m: log(f"  {m}"))
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    p3 = result["P3"]
    tol = min(BF16_TOL, BF16_REL_TOL * p3["rms"])
    if not p3["max_abs_err"] <= tol:
        raise AssertionError(f"P3: K9 and kernel A differ by {p3['max_abs_err']:.3e} > "
                             f"{tol:.3e}")
    for mode in ("packed_attention", "self_attention"):
        if launches[mode] < 1:
            raise AssertionError(f"the probe launched no {mode} kernel: {launches}")
    log(f"  launches in the probe's run: "
        f"{ {k: v for k, v in launches.items() if v} }")
    return result, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--report", default=None,
                    help="also write every measurement as JSON to this path")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from magicdance_tpu_torch.config import SampleConfig
        from magicdance_tpu_torch.ops.kernels import build
        from magicdance_tpu_torch.utils.timing import card_line
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
        for inst, nreg, spill in tc_instantiations(text) + gn_instantiations(text):
            log(f"    {inst}: {nreg} registers, {spill} spill bytes")
        body = CUDA_CORE_BODIES.get(name)
        if body is None:
            continue
        core = cuda_core_instantiations(text, body)
        log(f"    CUDA-core body ({body}): {core['fp32']} fp32, {core['bf16']} bf16 "
            "instantiations")
        # bf16 kernels A, B, C, D and G run only on the tensor cores
        if core["bf16"] or not tc_instantiations(text):
            raise AssertionError(f"{name}: {core['bf16']} bf16 instantiations of the "
                                 f"CUDA-core body, {len(tc_instantiations(text))} "
                                 "tensor-core instantiations")
        if name == "grouped_attention_bwd":
            spilled = {inst.rsplit(" (", 1)[0]: spill for inst, _, spill in tc_instantiations(text)}
            bad = {k: spilled.get(k) for k in G_BWD_FULL_WIDTH if spilled.get(k) != 0}
            if bad:
                raise AssertionError(f"{name}: spill bytes at the full-width widths {bad}")

    log("== phase 2b: kernel gate (ops/kernel_gate.py::run_gate, production cases)")
    gate = kernel_gate()

    log("== phase 3: kernels vs plain versions")
    rows, errs, ratios, checked = check_kernels(frames)

    log("== phase 4: small-input reference")
    small_reference_check()

    steps = SampleConfig().steps
    log(f"== phase 5: main path (full SD1.5 width, 512x512, DDIM-{steps})")
    pipe, e2e = main_path(requests, frames, steps)

    log("== phase 6: where one request's time goes (time per piece)")
    e2e["breakdown_ms"] = step_breakdown(pipe, frames)
    del pipe
    torch.cuda.empty_cache()

    from collections import Counter

    from magicdance_tpu_torch.config import stage2_pose_control, stage3_motion

    train_cfg = stage2_pose_control()
    plan, _, _ = training_launch_plan(train_cfg.model, train_cfg.image_size // 8)
    s3_cfg = stage3_motion()
    s3_sites = Counter(stage3_grad_sites(s3_cfg.model, s3_cfg.image_size // 8))
    log("== phase 7: training kernels vs plain versions (full-width stage-2 shapes, B = 2; "
        "C and D at the stage-3 shapes, 16 frames)")
    train_rows, train_errs, train_checked = check_training_kernels(
        plan, s3_sites, batch=frames, frames=s3_cfg.video_frames)

    log("== phase 8: small-input training reference")
    small_train = small_training_check()

    log("== phase 9: training path (full SD1.5 width, stage 2, B = 2, 512x512)")
    train = full_width_training(steps=4, batch=frames)
    torch.cuda.empty_cache()

    log("== phase 10: grouped (temporal) kernel G vs plain versions (full-width motion shapes)")
    grouped_rows, grouped_errs, grouped_checked = check_grouped_kernels()

    log("== phase 11: small-input video references (narrow temporal model, card vs CPU)")
    small_video = small_video_check()
    small_stage3 = small_stage3_check()

    log(f"== phase 12: video path (full SD1.5 width + motion modules, 16 frames at 512x512, "
        f"DDIM-{steps})")
    vpipe, video = video_main_path(requests, 16, steps)
    log("== phase 12b: where one video request's time goes (time per piece, 16 frames)")
    video["breakdown_ms"] = step_breakdown(vpipe, 16, num_frames=16)
    del vpipe
    torch.cuda.empty_cache()

    log("== phase 13: stage-3 training path (full SD1.5 width, one 16-frame clip, 512x512)")
    stage3 = full_width_stage3(steps=3)
    torch.cuda.empty_cache()

    from magicdance_tpu_torch.config import ModelConfig
    from magicdance_tpu_torch.pipeline import MagicPosePipeline

    model_cfg = ModelConfig()
    fused_plan = {}
    for site in pass_sites(model_cfg.unet, 64):
        if site[0] == "spatial" and site[1] >= 256:
            fused_plan[site[1], site[2]] = fused_plan.get((site[1], site[2]), 0) + 1
    log("== phase 14: kernel B gated (fused CFG) and pooled key lengths; K8 (fused "
        "GroupNorm+SiLU) at every site of the model")
    fused_rows, fused_errs, fused_checked = check_fused_cfg_and_pooled_kernels(frames, fused_plan)
    pipe = MagicPosePipeline(model_cfg, device="cuda")
    pipe.init_params(seed=0)
    gn_sites = groupnorm_sites(pipe, frames)
    gn_per_step = gn_plan_by_shape(model_cfg, 64, frames)
    if {key[:3] for key, _ in gn_sites} != set(gn_per_step):
        raise AssertionError(f"GN+SiLU sites of the model {[k for k, _ in gn_sites]} differ "
                             f"from the launch plan's {sorted(gn_per_step)}")
    gn_rows, gn_errs, gn_checked = check_groupnorm_kernel(gn_sites, gn_per_step)

    log("== phase 15: small-input references of fused CFG, the turbo stacks and the fused "
        "GroupNorm (narrow models, card vs CPU)")
    small_turbo = small_turbo_checks()

    log(f"== phase 16: fused CFG, turbo, turbo_max and fused GroupNorm requests (full SD1.5 "
        f"width, {requests} x {frames} frames at 512x512), in turns with the exact recipe")
    served = {}
    for label, scfg, fused_gn in (
            ("exact", SampleConfig(steps=steps), False),
            ("fused_cfg", SampleConfig(steps=steps, fused_cfg=True), False),
            ("fused_gn", SampleConfig(steps=steps), True),
            ("turbo", SampleConfig(steps=steps, **TURBO), False),
            ("turbo_max", SampleConfig(steps=20, **TURBO_MAX), False),
            ("exact_again", SampleConfig(steps=steps), False)):
        plan = request_launch_plan(model_cfg, 64, frames, scfg, fused_gn=fused_gn)
        served[label] = serve_requests(pipe, scfg, requests, frames, plan, label,
                                       fused_gn=fused_gn)
    log(f"  beside phase 5's exact requests (same process): seconds per request "
        f"{[round(x, 3) for x in e2e['seconds_per_request']]}, peak memory "
        f"{e2e['peak_bytes'] / 2**30:.2f} GiB")
    del pipe
    torch.cuda.empty_cache()

    log(f"== phase 17: video turbo (full SD1.5 width + motion modules, 16 frames at 512x512, "
        f"DDIM-{steps}, bench.py's turbo stack)")
    vpipe = MagicPosePipeline(temporal_model_config(), device="cuda")
    vpipe.init_params(seed=0)
    vscfg = SampleConfig(steps=steps, **TURBO)
    vplan = request_launch_plan(temporal_model_config(), 64, 16, vscfg, frames=16, video=True)
    video_turbo = serve_requests(vpipe, vscfg, requests, 16, vplan, "video turbo", video=True)
    log(f"  beside phase 12's exact video requests (same process): seconds per request "
        f"{[round(x, 3) for x in video['seconds_per_request']]}, peak memory "
        f"{video['peak_bytes'] / 2**30:.2f} GiB")
    del vpipe
    torch.cuda.empty_cache()

    log("== phase 18: kernel K9 (head-packed attention) vs plain versions, then the "
        "head-packing probe (P1-P4)")
    packed_rows, packed_errs, packed_checked = check_packed_kernel()
    probe, probe_launches = head_packing_probe()
    torch.cuda.empty_cache()

    log(f"== phase 19: DUAL_CONTROL image serving (pose and image ControlNets, full SD1.5 "
        f"width, {requests} x {frames} frames at 512x512, DDIM-{steps}), exact then turbo")
    small_dual = small_dual_check()
    dual_cfg = dual_model_config()
    dpipe = MagicPosePipeline(dual_cfg, device="cuda")
    dpipe.init_params(seed=0)
    dual = {}
    for label, scfg in (("exact", SampleConfig(steps=steps)),
                        ("turbo", SampleConfig(steps=steps, **TURBO))):
        dplan = request_launch_plan(dual_cfg, 64, frames, scfg)
        log(f"  {label}: launch plan per DDIM step "
            f"{ {m: n / steps for m, n in dplan.items()} }")
        dual[label] = serve_requests(dpipe, scfg, requests, frames, dplan,
                                     f"DUAL_CONTROL {label}", image_hints=True)
    del dpipe
    torch.cuda.empty_cache()

    sampler_steps = 25
    log(f"== phase 20: PLMS, DPM-Solver++ 2M and 3M (SDE, sde_eta=1) (full SD1.5 width, 1 "
        f"request x {frames} frames at 512x512 each, {sampler_steps} steps, CFG 7)")
    spipe = MagicPosePipeline(model_cfg, device="cuda")
    spipe.init_params(seed=0)
    samplers = sampler_requests(spipe, frames, sampler_steps)

    log("== phase 21: profile of one exact image DDIM step (utils/profiling.trace, "
        "torch.profiler)")
    profile = profile_ddim_step(spipe, frames, os.path.join(ROOT, "chiprun_out", "profile"))
    del spipe
    torch.cuda.empty_cache()

    log(f"== phase 22: a reference checkpoint through the sampling CLI (full SD1.5 width, "
        f"fp16 reference-layout file, 1 request x {frames} frames at 512x512, DDIM-{steps}; "
        f"then --video, 16 frames, DDIM-10)")
    cli = sample_cli_checkpoint(card, frames=frames, steps=steps)

    log("== phase 23: OpenPose on the card (body, hand and face nets, card vs CPU in fp32; "
        "the detector end to end)")
    openpose = openpose_on_card(card)

    log(f"== phase 24: evaluation on the card (cli.eval at full SD1.5 width, 2 videos x 1 "
        f"request of F = 8 at 512x512, DDIM-{steps}; every metric type through "
        f"get_all_eval_scores and the CLIP similarity; the metric nets card vs CPU in fp32)")
    evaluation = eval_on_card(card, steps=steps)

    def per_step(rows_, key):
        return sum(r[key] * r["launches_per_step"] for r in rows_)

    def bound_by(rows_):
        by = {}
        for r in rows_:
            by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + r["bound_ms"] * r["launches_per_step"]
        return max(by, key=by.get)

    paths = {"image serving (2 requests x 50 DDIM steps)": e2e["launches"],
             "image training (stage 2, 4 steps)": train["launches"],
             "video serving (2 requests x 50 DDIM steps)": video["launches"],
             "video training (stage 3, 3 steps)": stage3["launches"],
             **{f"image serving, {label} (2 requests x {r['steps']} DDIM steps)": r["launches"]
                for label, r in served.items()},
             "video serving, turbo (2 requests x 50 DDIM steps)": video_turbo["launches"],
             "head-packing probe (P1-P4)": probe_launches,
             **{f"DUAL_CONTROL image serving, {label} (2 requests x 50 DDIM steps)": r["launches"]
                for label, r in dual.items()},
             **{f"image serving, {name} (1 request x {sampler_steps} steps)":
                samplers[name]["launches"] for name in SAMPLERS},
             f"sampling CLI --checkpoint (1 request x {steps} DDIM steps)":
                cli["image"]["launches"],
             "sampling CLI --video (1 request x 10 DDIM steps)": cli["video"]["launches"],
             f"eval CLI (2 requests x 8 frames x {steps} DDIM steps)":
                evaluation["generation"]["launches"]}
    kernels = []
    for name, meta in KERNELS.items():
        by_path = {p: sum(launches.get(m, 0) for m in meta["modes"])
                   for p, launches in paths.items()}
        if name in ("two_source_attention_gated", "groupnorm_silu"):
            main_rows = [r for r in (fused_rows if name.startswith("two") else gn_rows)
                         if r["kernel"] == name]
            err = (fused_errs if name.startswith("two") else gn_errs)[name]
            n_checked = (fused_checked if name.startswith("two") else gn_checked)[name]
            kernels.append(dict(
                name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
                body=meta["body"],
                launches=sum(by_path.values()), launches_by_path=by_path, max_abs_err=err,
                ms=per_step(main_rows, "kernel_ms"), plain_ms=per_step(main_rows, "plain_ms"),
                bound_ms=per_step(main_rows, "bound_ms"), bound_by=bound_by(main_rows),
                library_ms=per_step(main_rows, "library_ms"),
                per="one DDIM step of the image serving path with "
                    + ("fused_cfg=True" if name.startswith("two") else "MAGICDANCE_FUSED_GN=1")
                    + " (sum over its launches)",
                check=f"{n_checked} comparisons within tolerance"))
            video_gn = [r for r in main_rows if r.get("path") == "video"]
            if video_gn:
                r = video_gn[0]
                kernels[-1]["video_site"] = dict(
                    shape=[r["B"], r["HW"], r["C"]], ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                    library_ms=r["library_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    per="one launch at the 16-frame video request's first level")
            continue
        if name == "packed_attention":
            kernels.append(dict(
                name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
                body=meta["body"], launches=sum(by_path.values()), launches_by_path=by_path,
                max_abs_err=packed_errs[name], ms=per_step(packed_rows, "kernel_ms"),
                plain_ms=per_step(packed_rows, "plain_ms"),
                bound_ms=per_step(packed_rows, "bound_ms"), bound_by=bound_by(packed_rows),
                library_ms=per_step(packed_rows, "library_ms"),
                per="one launch at the probe's shape (BG 64, S 4096, G 3, D 40, bf16)",
                check=f"{packed_checked[name]} comparisons within tolerance",
                probe_P3=probe["P3"]))
            continue
        if name.startswith("grouped"):
            main_rows = [r for r in grouped_rows if r["mode"] in meta["modes"]]
            serving, training = (main_rows, []) if name == "grouped_attention" else ([], main_rows)
            video_rows = stage3_rows = []
            err, n_checked = grouped_errs[name], grouped_checked[name]
        else:
            serving = [r for r in rows if r["kernel"] == name and "path" not in r]
            video_rows = [r for r in rows if r["kernel"] == name and "path" in r]
            training = [r for r in train_rows if r["mode"] in meta["modes"] and "path" not in r]
            stage3_rows = [r for r in train_rows if r["mode"] in meta["modes"] and "path" in r]
            main_rows = serving if serving else training
            err = max(errs.get(name, 0.0), train_errs[name], fused_errs.get(name, 0.0),
                      packed_errs.get(name, 0.0))
            n_checked = (checked.get(name, 0) + train_checked[name]
                         + fused_checked.get(name, 0) + packed_checked.get(name, 0))
        entry = dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            body=meta["body"],
            launches=sum(by_path.values()), launches_by_path=by_path, max_abs_err=err,
            ms=per_step(main_rows, "kernel_ms"), plain_ms=per_step(main_rows, "plain_ms"),
            bound_ms=per_step(main_rows, "bound_ms"), bound_by=bound_by(main_rows),
            library_ms=per_step(main_rows, "library_ms"),
            per=("one DDIM step of the " + ("video" if name.startswith("grouped") else "image")
                 + " serving path (sum over its launches)" if serving
                 else "one " + ("stage-3" if name.startswith("grouped") else "stage-2")
                 + " training step (sum over its launches)"),
            check=f"{n_checked} comparisons within tolerance")
        if name in ratios:
            entry["max_err_over_rms"] = ratios[name]
        if all("exp_bound_ms" in r for r in main_rows):
            entry["exp_bound_ms"] = per_step(main_rows, "exp_bound_ms")
        if video_rows:
            entry["video_step"] = dict(
                ms=per_step(video_rows, "kernel_ms"), plain_ms=per_step(video_rows, "plain_ms"),
                bound_ms=per_step(video_rows, "bound_ms"),
                exp_bound_ms=per_step(video_rows, "exp_bound_ms"),
                library_ms=per_step(video_rows, "library_ms"), bound_by=bound_by(video_rows),
                per="one DDIM step of the video serving path (16 frames), the bank reads' "
                    "launches")
        if stage3_rows:
            entry["stage3_step"] = dict(
                ms=per_step(stage3_rows, "kernel_ms"), plain_ms=per_step(stage3_rows, "plain_ms"),
                bound_ms=per_step(stage3_rows, "bound_ms"),
                exp_bound_ms=per_step(stage3_rows, "exp_bound_ms"),
                library_ms=per_step(stage3_rows, "library_ms"), bound_by=bound_by(stage3_rows),
                per="one stage-3 training step (a 16-frame clip, a batch-1 bank; sum over its "
                    "launches)")
        if serving and training:
            entry["training_step"] = dict(
                ms=per_step(training, "kernel_ms"), plain_ms=per_step(training, "plain_ms"),
                bound_ms=per_step(training, "bound_ms"),
                library_ms=per_step(training, "library_ms"), bound_by=bound_by(training),
                per="one training step, the LSE forward's launches")
        kernels.append(entry)
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(dict(card=card, shapes=rows, main_path=e2e, training_shapes=train_rows,
                           small_training=small_train, training=train,
                           grouped_shapes=grouped_rows, small_video=small_video,
                           small_stage3=small_stage3, video=video, stage3=stage3,
                           fused_and_pooled_shapes=fused_rows, groupnorm_shapes=gn_rows,
                           small_turbo=small_turbo, served=served, video_turbo=video_turbo,
                           packed_shapes=packed_rows, head_packing_probe=probe,
                           kernel_gate=gate, small_dual=small_dual, dual_control=dual,
                           samplers=samplers, profile=profile, sample_cli=cli,
                           openpose=openpose, evaluation=evaluation, kernels=kernels), f,
                      indent=1)
    log(f"== all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
