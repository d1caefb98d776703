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
     mma.sync body of kernels A, B, B gated above D = 192 and K9 above G*D
     = 128: `md::tc::attention_tc`; of C: `attention_dq_tc`; of D:
     `attention_dkv_tc`; of G's forward: `grouped_tc`; of G's backward:
     `grouped_bwd_tc`), of K8's two kernels (`md::gn::gn_stats`, `gn_apply`)
     and the CUDA-core instantiations by type (none in bf16 for A, B, C, D
     and G, forward and backward); G's backward must not spill at the
     full-width motion widths (D = 40, 80, 160 at BN = 16). The Hopper
     bodies (`md::wg::attention_wgmma<KS, MODE>`: bf16 A (SELF) and B
     (TWO_SOURCE, GATED) up to D = 192, K9 (PACKED) up to G*D = 128;
     `attention_dq_wgmma<KS, MODE>`: C with one (SELF) or two (TWO_SOURCE)
     sources up to D = 192; `attention_dkv_wgmma<KS>`: D up to D = 160) must
     be compiled at every KS and mode, must not spill, ptxas must not drop
     their setmaxnreg split, and `cuobjdump -sass` of libself_attention,
     libtwo_source_attention, libpacked_attention, libattention_dq and
     libattention_dkv must show wgmma (HGMMA) and TMA loads (UTMALDG); C's
     and D's libraries, and their Hopper body's source, no atomic.
  2b. the kernel gate (`ops/kernel_gate.py::run_gate`, before any timed
     phase): every case of the JAX gate and the main path's shapes at H = 8
     (D = 40, 80, 160, batch-1 banks, the gated read, G at (4096, 16, 40)),
     forward and gradients, and K8 at (2, 4096, 320), through the port's
     dispatch against fp32 reference math; each check's deviation, the
     gate's wall time and its launches (every kernel must be reached).
  3. hold each kernel against its plain PyTorch version at every shape the
     main path gives it (kernels A and B run the Hopper body in bf16, which
     `attention_body` must pick at each of these shapes, and their
     CUDA-core body in fp32; in bf16 also attention_tc named explicitly,
     held and timed on the same inputs, and the host time per wrapper call
     of both bodies) (bf16: max-abs <= min(5e-2, 0.1 x the
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
     bf16 C and D run on each body that takes the width (the Hopper body,
     `attention_bwd_wgmma.cuh`, C up to D = 192 and D up to 160; the mma.sync
     body, `attention_bwd_mma.cuh`), each held by the gradient rule, and on
     their default body twice, which must give the same bits. Times kernel
     (the body `attention_body` picks, both bodies beside it), plain
     version, library call (the backward of F.scaled_dot_product_attention
     through torch.autograd.grad, K/V concatenated for two sources; a
     yardstick only) and the bound, with the operations each kernel does: 4,
     6 and 8 x Sq x Skv x D per (batch, head, source) for the forward, dQ
     and dK/dV.
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
     two-source + 80 grouped + 2 x 250 K8 launches per DDIM step
     (`serving_launch_plan`);
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
     GroupNorm with a SiLU or identity epilogue: a statistics kernel over
     row chunks in clusters of 8, then the apply kernel) at every (B, HW >=
     64, C, epilogue) where the appearance UNet, the ControlNet and the
     main UNet call it, read from the model by forward hooks, and at the
     16-frame video request's first level (16, 4096, 320); each K8 case runs
     twice and must give the same bits; bf16 (a bf16 affine) timed against
     the bound, the plain version and the library call (SDPA over the
     concatenated keys with a boolean mask hiding the bank from gate-0 rows;
     F.group_norm, then F.silu where the site has it).
  15. narrow models at 128x128, card vs CPU in fp32, each held to its launch
     plan: a fused-CFG sample, bench.py's `turbo` and `turbo_max` stacks, the
     `turbo` stack through the overlap sampler (temporal model), and an exact
     sample with MAGICDANCE_FUSED_GN=0 (the plain GroupNorm).
  16. full SD1.5 width, 2 requests x F = 2 at 512x512 each, in turns: the
     exact recipe, fused_cfg=True (DDIM-50), MAGICDANCE_FUSED_GN=0 (DDIM-50),
     the `turbo` stack (DDIM-50), `turbo_max` (DDIM-20), the exact recipe
     again; every request held to its launch plan (`request_launch_plan`,
     from the sampler's own host masks); seconds per request, frames/s and
     peak memory, beside phase 5's exact requests.
  17. the temporal model at full width, 2 requests x 16 frames at 512x512,
     one window, DDIM-50, under the `turbo` stack, held to its launch plan,
     beside phase 12's exact video requests.
  18. the head-packing probe and kernel K9: K9 against its plain version at
     the probe's shape (BG 64, S 4096, G 3, D 40, block-diagonal K/V from
     random heads) and a small ragged shape (random K/V), bf16 and fp32; at
     G = 1, D = 40 (BG 192, S 4096) and at G*D = 8 and 256, bf16, each on
     the body `packed.packed_body` routes it to (the Hopper body up to G*D =
     128, attention_tc above); timed in bf16 at the probe's shape against
     its bound, the earlier body (attention_tc) on the same inputs, the
     plain version and two library calls (SDPA on the unpacked per-head
     tensors, a third of K9's operations; SDPA at equal work, q repeated
     over the G segments), and at G = 1 beside kernel A on the same heads;
     kernel A against its plain version on the probe's unpacked tensors
     (BSNH 32, 4096, 6, 40, bf16 and fp32), the shape P3 gives it; then the
     probe itself (`magicdance_tpu_torch.scripts.bench_head_packing`,
     P1-P4) as the slice's path, with the counts at 0 before it: P3 runs K9
     at G = 3 and at G = 1 and kernel A at (32, 4096, 6, 40) BSNH, and both
     K9 outputs must agree with A's.
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
  25. distribution (torch.distributed; cuDNN deterministic for the phase).
     25a, one rank over NCCL through `parallel.multihost.initialize_distributed`
     at full SD1.5 width: three stage-2 steps (phase 9's preset, weights and
     batches at B = 2, adam_eps 1e-4) of the data-parallel ZeRO-1 trainer
     against the plain trainer (no group): losses and grad norms within 1e-3
     relative, parameters within 2% of the learning rate, every step held to
     phase 9's launch plan; one frame-parallel image request (F = 2,
     DDIM-50, CFG 7) and one window-parallel video request (16 frames in
     windows of 8, stride 4: four windows; DDIM-10) through
     `sample_frames(mesh=)` against the same requests unsharded, equal bit
     for bit or within the bf16 rule (the phase prints which), each held to
     its launch plan. 25b, two ranks sharing the card over gloo (this script
     again, `--p25-rank`; NCCL takes no two ranks on one device; every
     collective on a CUDA tensor staged through host memory): the image
     request at one frame a rank and the video request at two windows a
     rank against 25a's within the bf16 rule, both ranks with the same
     result; two stage-2 steps at B = 1 a rank against 25a's first two
     steps at B = 2 with the same draws (loss and grad norm 1e-3 relative,
     parameters 2% of the learning rate); seconds per step and per request,
     optimizer-state bytes and peak memory per rank. A failed rendezvous, a
     rank's non-zero exit or a mismatch fails the phase; the groups are
     destroyed and the files under chiprun_out/phase25 deleted at the end.
  26. the training leftovers (cuDNN deterministic for the phase), full SD1.5
     width, phase 9's stage-2 preset at B = 2 (phase 25's config), seeded
     weights. 26a: three steps with the
     frozen weights in int8 (`models/quant.py`) against a bf16-frozen trainer
     holding the dequantized values (the small frozen leaves given bf16
     values in both): losses, grad norms and parameters bit for bit or
     within phase 25's rules (the phase prints which), both held to phase
     9's launch plan; frozen-storage bytes, peak memory and s/step of both.
     26b: the same start, three steps under attention_impl="flash" held to
     `flash_launch_plan` (JAX's dispatch under the override: every denoiser
     site through the BSNH kernels) with their loss and grad-norm gaps to the
     bf16 ("auto") run within P26_LOSS_GAP / P26_GRAD_GAP; a control, two
     "flash" steps with a wrong cross-attention dQ, which must land beyond
     them; one step under "xla" with no attention-kernel launch, within the
     same bounds; two stage-3 steps under "auto" (phase 13's plan), then the
     same two from the same state under "flash" (the temporal sites through
     A/C/D, no grouped kernel; held to its plan), within the same bounds;
     every site of both "flash" plans that phases 3 and 7 did not hold (A or
     B without the LSE where the plan launches them, else the LSE forward, C
     and D; cross-attention over 77 keys, the S = 64 sites, the temporal
     sites, B = 1 and 16) against its plain versions, bf16 timed with the
     SDPA library time and the bound (A, B, C and D on each body that takes
     the width, the one `attention_body` picks marked; C and D held on each
     and twice with the same bits, as in phase 7), and fp32. 26c: `cli.train` at full width, frozen int8, no checkpoint
     (the Flax-style init: every zero-init kernel exactly zero at step 0),
     on a seeded tree of 512x512 JPEG frames and PNG pose maps under
     chiprun_out/phase26 (deleted at the end) decoded by the native loader
     (`data/native.py`), with the sample grid; the loader's images/s native
     vs PIL and its crops against `rrc_params`'; a failed native build while
     g++ and the jpeg/png headers are present fails the phase. 26d: narrow
     fp32 card vs CPU: a stage-2 step in int8, under "flash", under "xla"
     (2e-4), each held to its launch plan, and a request with dropout 0.1
     (phase 4's check), equal to dropout 0 on the card.
  27. magicpose-sdxl (port_bench/configs/magicpose-sdxl.json), the shapes of
     the `sdxl-pose.serve-f4` cell: kernels A and B at its 64-wide heads
     (SDXL_SHAPES: 4096 queries, 10 heads and 1024 queries, 20 heads; the
     write pass at B = 1, the ControlNet and uncond passes at B = 4, the
     cond pass over a batch-1 bank) held and timed as in phase 3, bf16 and
     fp32; then the model at its published widths, seeded random weights,
     one request of 4 pose maps at 1024x1024, DDIM-1, CFG 7, its launches
     counted from 0 and held to `serving_launch_plan` (174 A, 70 B, 318 K8)
     and its denoisers' GroupNorm calls to `gn_plan_by_shape`; K8 at each of
     those sites (128x128 grids included) held and timed as in phase 14b.
  Each phase's wall time is logged at its end and listed after the last.
  Then the `kernels` JSON line (the six kernels of phases 3-13, kernel B's
  gated mode, K8 and K9, launches by path, and each kernel's `body`: the
  device functions that run it in bf16 and fp32; kernel B's entry also sums
  its 16-frame rows per video DDIM step, C's and D's their stage-3 rows per
  stage-3 step, K8's holds its video site; A, B, C and D also list the
  shapes the "flash" override adds, `flash_shapes`), the card line, the
  result line.

Exits non-zero without a result when torch.cuda.is_available() is false or
the port's package is not beside this script.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
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
        body="bf16, D <= 192 where it is the faster body (every main-path shape; "
             "attention.py::attention_body): md::wg::attention_wgmma SELF (wgmma, TMA, mbarrier "
             "ring, warp specialised); other bf16 (D > 192, D <= 48 under 512 keys, 48 < D <= "
             "80 at 64 rows or fewer, rows TMA cannot read): md::tc::attention_tc (mma.sync); "
             "fp32: md::attention_fwd (CUDA cores)",
        modes=("self_attention", "self_attention_lse")),
    "two_source_attention": dict(
        source="magicdance_tpu_torch/ops/kernels/csrc/two_source_attention.cu",
        replaces="magicdance_tpu/ops/pallas/flash.py:308 (_attn2_kernel_fused); "
                 "magicdance_tpu/ops/pallas/flash.py:97 (_attn2_kernel_nomask); "
                 "magicdance_tpu/ops/pallas/flash_vjp.py:89 (_fwd2_lse_kernel)",
        body="bf16, D <= 192 where it is the faster body (every main-path shape; "
             "attention.py::attention_body): md::wg::attention_wgmma TWO_SOURCE (wgmma, TMA, "
             "mbarrier ring, warp specialised); other bf16 (D > 192, D <= 48 under 512 keys, "
             "rows TMA cannot read): md::tc::attention_tc (mma.sync); fp32: md::attention_fwd "
             "(CUDA cores)",
        modes=("two_source_attention", "two_source_attention_lse")),
    "attention_dq": dict(
        source="magicdance_tpu_torch/ops/kernels/csrc/attention_dq.cu",
        replaces="magicdance_tpu/ops/pallas/flash_vjp.py:129 (_dq_kernel); "
                 "magicdance_tpu/ops/pallas/flash_vjp.py:153 (_dq2_kernel)",
        body="bf16, D <= 192 where it is the faster body (every main-path shape; "
             "attention.py::attention_body): md::wg::attention_dq_wgmma SELF / TWO_SOURCE "
             "(attention_bwd_wgmma.cuh: wgmma, TMA, mbarrier ring, warp specialised); other bf16 "
             "(D > 192, D <= 48 over 128 keys or fewer, 48 < D <= 80 over 64 or fewer, rows TMA "
             "cannot read): md::tc::attention_dq_tc (mma.sync); fp32: md::attention_dq (CUDA "
             "cores)",
        modes=("attention_dq", "attention_dq_two_source")),
    "attention_dkv": dict(
        source="magicdance_tpu_torch/ops/kernels/csrc/attention_dkv.cu",
        replaces="magicdance_tpu/ops/pallas/flash_vjp.py:202 (_dkv_kernel)",
        body="bf16, D <= 160 where it is the faster body (every main-path shape; "
             "attention.py::attention_body): md::wg::attention_dkv_wgmma (attention_bwd_wgmma.cuh: "
             "wgmma, TMA, mbarrier ring, warp specialised; the query walk split over blocks with "
             "fp32 partials summed in order by md::wg::dkv_reduce where the grid would leave SMs "
             "idle, flash_vjp.dkv_split); other bf16 (D > 160, under 256 query rows walked a "
             "block, lse rows TMA cannot read): md::tc::attention_dkv_tc (mma.sync); fp32: "
             "md::attention_dkv (CUDA cores)",
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
        body="bf16, D <= 192 where it is the faster body (every main-path shape; "
             "attention.py::attention_body): md::wg::attention_wgmma GATED (wgmma, TMA, mbarrier "
             "ring, warp specialised); other bf16 (D > 192, D <= 48 under 512 keys, rows TMA "
             "cannot read): md::tc::attention_tc GATED (mma.sync); fp32: md::attention_fwd (CUDA "
             "cores)",
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
        body="bf16, G*D <= 128: md::wg::attention_wgmma PACKED (wgmma, TMA, mbarrier ring, "
             "warp specialised; the body of bf16 A and B); bf16, G*D > 128: md::tc::attention_tc "
             "PACKED (mma.sync); fp32: its own CUDA-core body",
        modes=("packed_attention",)),
}
TRAIN_MODES = ("self_attention_lse", "two_source_attention_lse", "attention_dq",
               "attention_dq_two_source", "attention_dkv")
SELF_PER_STEP = 36
TWO_SOURCE_PER_STEP = 15
# K8 per image DDIM step at 512x512: all 210 GroupNorm32 calls (H*W >= 64:
# 155 with SiLU, 55 transformer norms), two launches each
K8_PER_STEP = 2 * 210


def log(msg: str) -> None:
    print(msg, flush=True)


# (phase, seconds) of each phase ended so far, and the current one's start
PHASE_S: list = []
_phase_open: list = []


def phase(header: str) -> None:
    """Log a phase's header ("== phase N: ..."), ending the phase before it
    (its wall time goes to PHASE_S and the log)."""
    end_phase()
    _phase_open.append((header.split(":")[0].lstrip("= "), time.perf_counter()))
    log(header)


def end_phase() -> None:
    if _phase_open:
        name, t0 = _phase_open.pop()
        PHASE_S.append((name, round(time.perf_counter() - t0, 1)))
        log(f"  ({name}: {PHASE_S[-1][1]} s)")


def bf16_bodies(d: int, kernel: str = "attention") -> list:
    """The bf16 bodies that can run `kernel` (as `attention_body` names it)
    at head width d."""
    import torch

    from magicdance_tpu_torch.ops.kernels.attention import check_body

    out = []
    for body in ("wgmma", "mma_sync"):
        try:
            check_body(body, torch.bfloat16, d, kernel=kernel)
            out.append(body)
        except ValueError:
            pass
    return out


def body_times(call, d: int, rows: int, keys: tuple, kernel: str = "attention") -> tuple:
    """bf16 kernel A, B, C or D (`kernel` as `attention_body` names it;
    `call(body=...)`) on each body that can take width d: the body
    `attention_body` picks for (D, S_q or the query rows D's blocks walk,
    key counts) and {body: device ms}."""
    import torch

    from magicdance_tpu_torch.ops.kernels.attention import attention_body
    from magicdance_tpu_torch.utils.timing import device_time_ms

    chosen = attention_body(torch.bfloat16, d, rows=rows, keys=keys, kernel=kernel)
    return chosen, {b: device_time_ms(lambda b=b: call(body=b)) for b in bf16_bodies(d, kernel)}


def bodies_text(bodies: dict, mma_sync_ms=None) -> str:
    """"(body) wgmma_ms=.. mma_sync_ms=.. " of a row's body times, for the log."""
    if not bodies:
        return f"mma_sync_ms={mma_sync_ms:.4f} " if mma_sync_ms is not None else ""
    fmt = lambda x: "n/a" if x is None else f"{x:.4f}"  # noqa: E731
    return (f"({bodies['body']}) wgmma_ms={fmt(bodies.get('wgmma_ms'))} "
            f"mma_sync_ms={fmt(bodies.get('mma_sync_ms', mma_sync_ms))} ")


def hold_bwd_bodies(check, name: str, call, want, label: str, d: int, kernel: str) -> None:
    """bf16 kernel C (`kernel` "dq": `call(body=...)` -> dQ) or D ("dkv": ->
    (dK, dV)) on each body that can take width d, against the plain
    `want` by `check(name, got, want, label, grad=True)`; then the default
    body twice, which must give the same bits (neither kernel uses
    atomics)."""
    import torch

    names = ("dQ",) if kernel == "dq" else ("dK", "dV")
    want = (want,) if kernel == "dq" else want
    for body in bf16_bodies(d, kernel):
        got = call(body=body)
        for g_, w_, nm in zip((got,) if kernel == "dq" else got, want, names):
            check(name, g_, w_, f"{label} {nm} {body}", grad=True)
    first, again = call(), call()
    first, again = ((first,), (again,)) if kernel == "dq" else (first, again)
    if not all(torch.equal(x, y) for x, y in zip(first, again)):
        raise AssertionError(f"{name} {label}: two launches on the same inputs differ")
    log(f"  ok  {name:22s} {label}: two launches, the same bits")


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


WG_MODES = {"0": "SELF", "1": "TWO_SOURCE", "2": "GATED", "3": "PACKED"}
# the Hopper bodies' instantiations each library must hold: (KS, mode) for
# KS = 1 .. 12 (D <= 192) in A, B and C, 1 .. 8 (G*D <= 128) in K9, 1 .. 10
# (D <= 160) in D ("DKV": D's kernel has no mode)
HOPPER_EXPECTED = {
    "self_attention": {(ks, "SELF") for ks in range(1, 13)},
    "two_source_attention": {(ks, m) for ks in range(1, 13) for m in ("TWO_SOURCE", "GATED")},
    "packed_attention": {(ks, "PACKED") for ks in range(1, 9)},
    "attention_dq": {(ks, m) for ks in range(1, 13) for m in ("SELF", "TWO_SOURCE")},
    "attention_dkv": {(ks, "DKV") for ks in range(1, 11)},
}
# libraries whose Hopper body must hold no atomic (C and D: deterministic)
NO_ATOMICS = ("attention_dq", "attention_dkv")
ATOMIC_OPS = ("ATOM", "ATOMG", "ATOMS", "RED")


def wgmma_instantiations(log_text: str) -> list[tuple[str, int, str, int, int]]:
    """(kernel, KS, mode, registers at launch, spill bytes) of each entry
    function of md::wg's Hopper bodies in a ptxas -v report:
    attention_wgmma<KS, MODE> (A, B, K9), attention_dq_wgmma<KS, MODE> (C)
    and attention_dkv_wgmma<KS> (D, mode "DKV"); KS: k16 steps of the D
    contraction; MODE: md::tc::Mode."""
    out = []
    for name, regs, spill in _entry_chunks(log_text):
        m = re.match(r"_ZN2md2wg\d+(attention_(?:dq_|dkv_)?wgmma)ILi(\d+)E(?:Li(\d+)E)?", name)
        if m:
            mode = WG_MODES.get(m.group(3), m.group(3)) if m.group(3) is not None else "DKV"
            out.append((m.group(1), int(m.group(2)), mode, regs, spill))
    return out


def sass_opcodes(lib_path, opcodes=("HGMMA", "UTMALDG")) -> dict:
    """How many instructions of each SASS opcode `cuobjdump -sass` finds in
    a built library."""
    import shutil
    import subprocess

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in opcodes}


def bwd_source_atomics() -> list:
    """Atomic operations in the code (comments left out) of the backward
    kernels' Hopper body, csrc/attention_bwd_wgmma.cuh."""
    path = os.path.join(ROOT, "magicdance_tpu_torch", "ops", "kernels", "csrc",
                        "attention_bwd_wgmma.cuh")
    with open(path) as f:
        code = re.sub(r"//[^\n]*", "", f.read())
    return re.findall(r"\batomic\w*|\batom\.\w+|\bred\.\w+", code)


def hopper_opcodes(name: str) -> tuple:
    """The SASS opcodes phase 2 counts in a Hopper body's library."""
    return ("HGMMA", "UTMALDG") + (ATOMIC_OPS if name in NO_ATOMICS else ())


def check_hopper_body(name: str, lib_path, log_text: str, ops=None) -> dict:
    """Phase 2, the libraries of A, B, K9, C and D: the Hopper body must be
    compiled at every (KS, mode) of HOPPER_EXPECTED[name], no instantiation
    may spill, ptxas must keep its register split (no C7508 "setmaxnreg
    ignored"), and the SASS must hold wgmma (HGMMA) and TMA loads (UTMALDG);
    in C's and D's libraries it must hold no atomic (ATOMIC_OPS), nor their
    Hopper body's source. `ops`: the library's `sass_opcodes` of
    `hopper_opcodes(name)`, read here when not given. Returns what it
    read."""
    insts = wgmma_instantiations(log_text)
    for kern, ks, mode, nreg, spill in insts:
        log(f"    {kern}<KS={ks}, {mode}>: {nreg} registers at launch, {spill} spill bytes")
    warnings = sorted({line.strip() for line in log_text.splitlines()
                       if "setmaxnreg" in line or "serialized" in line})
    for line in warnings:
        log(f"    ptxas: {line}")
    if ops is None:
        ops = sass_opcodes(lib_path, hopper_opcodes(name))
    atomics = {op: ops[op] for op in ATOMIC_OPS if ops.get(op)}
    if name in NO_ATOMICS:
        atomics.update({w: 1 for w in bwd_source_atomics()})
    log(f"    SASS: {ops}")
    spilled = {(ks, mode): spill for _, ks, mode, _, spill in insts if spill}
    found = {(ks, mode) for _, ks, mode, _, _ in insts}
    if (found != HOPPER_EXPECTED[name] or spilled or not (ops["HGMMA"] and ops["UTMALDG"])
            or atomics or any("setmaxnreg" in w and "ignored" in w for w in warnings)):
        raise AssertionError(f"{name}: Hopper body instantiations {sorted(found)} (expected "
                             f"{sorted(HOPPER_EXPECTED[name])}), spills {spilled}, SASS {ops}, "
                             f"atomics {atomics}, ptxas {warnings}")
    return dict(instantiations=[dict(kernel=kern, KS=ks, mode=mode, registers=nreg,
                                     spill_bytes=spill)
                                for kern, ks, mode, nreg, spill in insts],
                sass=ops, ptxas_warnings=warnings)


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


# (kernel, B, S, H, D, bank batch, launches per DDIM step) of
# `sdxl-pose.serve-f4` (magicpose-sdxl at 1024x1024, 4 frames): 64-wide heads,
# 10 at 64x64 (4 + 6 blocks a UNet pass, 4 in the ControlNet) and 20 at 32x32
# (20 + 10 + 30, the ControlNet's 30); the write pass (B = 1), the ControlNet
# and the uncond pass (B = 4) self-attend, the cond pass reads a batch-1 bank
SDXL_FRAMES = 4
SDXL_SHAPES = (("self_attention", 1, 4096, 10, 64, None, 10),
               ("self_attention", SDXL_FRAMES, 4096, 10, 64, None, 4 + 10),
               ("two_source_attention", SDXL_FRAMES, 4096, 10, 64, 1, 10),
               ("self_attention", 1, 1024, 20, 64, None, 60),
               ("self_attention", SDXL_FRAMES, 1024, 20, 64, None, 30 + 60),
               ("two_source_attention", SDXL_FRAMES, 1024, 20, 64, 1, 60))


def attention_checker():
    """Phase 3's gates: (errs, ratios, checked, check), the largest error
    and error over the plain output's RMS and the count of checks by
    kernel, and `check(name, got, want, tol, label)`, which holds a kernel's
    output to its plain version and logs it (bf16: max-abs <= min(tol, a
    tenth of the plain output's RMS); fp32: max-abs <= tol)."""
    import torch

    errs = {"self_attention": 0.0, "two_source_attention": 0.0}
    ratios = {"self_attention": 0.0, "two_source_attention": 0.0}
    checked = {"self_attention": 0, "two_source_attention": 0}

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

    return errs, ratios, checked, check


def hold_attention_shapes(cases, rnd, check, rows, path=None) -> None:
    """Kernels A and B at each (kernel, B, S, H, D, bank batch, launches per
    DDIM step) of `cases` against their plain versions: in bf16 on the
    Hopper body, which `attention_body` must pick there, and on attention_tc
    (mma.sync), each timed beside the plain version, the library call and
    the bound, then in fp32. The rows of another path than SD1.5 image
    serving carry `path`."""
    import torch
    import torch.nn.functional as F

    from magicdance_tpu_torch.ops import kernels as K
    from magicdance_tpu_torch.ops.kernels.attention import attention_body
    from magicdance_tpu_torch.utils.timing import device_time_ms, host_call_us

    for name, b, s, heads, d, bb, per_step in cases:
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
            label = (f"{str(dtype)[6:]} B={b} S={s} H={heads} D={d}"
                     + (f" bank_batch={bb}" if bb else ""))
            got = kern(*args)
            want = plain(*args)
            check(name, got, want, tol, label)
            if dtype != torch.bfloat16:
                continue
            chosen = attention_body(dtype, d, rows=s, keys=tuple(n for _, n in kv))
            if chosen != "wgmma":
                raise AssertionError(f"{name} {label}: the main path's shape takes {chosen}, "
                                     "not the Hopper body")
            # the earlier body (attention_tc, mma.sync) on the same inputs
            check(name, kern(*args, body="mma_sync"), want, tol, label + " mma_sync")
            ms = device_time_ms(lambda: kern(*args))
            tc_ms = device_time_ms(lambda: kern(*args, body="mma_sync"))
            host_us = {body: host_call_us(lambda: kern(*args, body=body))
                       for body in ("wgmma", "mma_sync")}
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
                             launches_per_step=per_step, kernel_ms=ms, mma_sync_ms=tc_ms,
                             plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                             bound_by=bound_by, exp_bound_ms=exp_ms,
                             host_us_per_call=host_us, **({"path": path} if path else {})))
            log(f"      kernel_ms={ms:.4f} mma_sync_ms={tc_ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={lib_ms:.4f} bound_ms={bound:.4f} ({bound_by}) "
                f"exp_bound_ms={exp_ms:.4f}; host us per call wgmma "
                f"{host_us['wgmma']:.1f} mma_sync {host_us['mma_sync']:.1f}")
            del q, k, v, args
            torch.cuda.empty_cache()


def check_kernels(frames: int, heads: int = 8):
    import torch
    import torch.nn.functional as F

    from magicdance_tpu_torch.ops import kernels as K
    from magicdance_tpu_torch.utils.timing import device_time_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    errs, ratios, checked, check = attention_checker()
    rows = []
    # every main-path shape, in bf16 (timed) and fp32
    hold_attention_shapes([(name, b, s, heads, d, bb, n)
                           for name, b, s, d, bb, n in main_path_shapes(frames)],
                          rnd, check, rows)

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

        want = plain_by_frames()
        label = f"bfloat16 video B={vframes} S={s} D={d} bank_batch=1"
        check("two_source_attention", K.two_source_attention(*args), want, BF16_TOL, label)
        check("two_source_attention", K.two_source_attention(*args, body="mma_sync"), want,
              BF16_TOL, label + " mma_sync")
        del want
        ms = device_time_ms(lambda: K.two_source_attention(*args))
        tc_ms = device_time_ms(lambda: K.two_source_attention(*args, body="mma_sync"))
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
                         mma_sync_ms=tc_ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound, bound_by=bound_by, exp_bound_ms=exp_ms))
        log(f"      kernel_ms={ms:.4f} mma_sync_ms={tc_ms:.4f} plain_ms={plain_ms:.4f} "
            f"(by {chunk} frames) "
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
            tc_ms = device_time_ms(lambda: K.self_attention(q, k, v, body="mma_sync"))
            plain_ms = device_time_ms(lambda: K.self_attention_ref(q, k, v),
                                      min_total_s=0.1, max_iters=5)
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            lib_ms = device_time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
            bound, bound_by = attention_bound_ms(2, 1024, heads, 80, [(2, 1024)])
            rows.append(dict(kernel="self_attention", B=2, S=1024, D=80, H=heads,
                             bank_batch=None, layout="BSNH-strided", launches_per_step=0,
                             kernel_ms=ms, mma_sync_ms=tc_ms, plain_ms=plain_ms,
                             library_ms=lib_ms,
                             bound_ms=bound, bound_by=bound_by,
                             exp_bound_ms=exp_bound_ms(2, 1024, heads, [(2, 1024)])))
            log(f"      BSNH-strided: kernel_ms={ms:.4f} mma_sync_ms={tc_ms:.4f} "
                f"plain_ms={plain_ms:.4f} "
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
              "two_source_attention": TWO_SOURCE_PER_STEP * steps * requests,
              "groupnorm_silu": K8_PER_STEP * steps * requests}
    if launches != expect:
        raise AssertionError(f"kernel launches {launches}, expected {expect} "
                             f"({SELF_PER_STEP} + {TWO_SOURCE_PER_STEP} + {K8_PER_STEP} per "
                             f"DDIM step)")
    peak = torch.cuda.max_memory_allocated()
    log(f"  {requests} requests x {frames} frames, DDIM-{steps}, CFG {scfg.cfg_scale}: "
        f"seconds per request {[round(s, 3) for s in secs]}, frames/s "
        f"{[round(frames / s, 4) for s in secs]}, peak memory {peak / 2**30:.2f} GiB")
    log(f"  launches {launches} = {SELF_PER_STEP} self + {TWO_SOURCE_PER_STEP} "
        f"two-source + {K8_PER_STEP} K8 per DDIM step")
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

    def spatial(ds, ch, depth):
        out.extend([("spatial", (latent // ds) ** 2, ucfg.heads_at(ch)[1])] * depth)

    def motion(ds, ch):
        if ucfg.use_motion_modules:
            out.append(("motion", (latent // ds) ** 2, ch))

    for u in units:
        if u["kind"] == "res":
            if u["attn"]:
                spatial(u["ds"], u["ch"], u["depth"])
            motion(u["ds"], u["ch"])
    spatial(ds_mid, ucfg.model_channels * ucfg.channel_mult[-1], ucfg.depth_middle)
    if decoder:
        for u in decoder_plan(ucfg):
            if u["attn"]:
                spatial(u["ds"], u["ch"], u["depth"])
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
    norms, the UNet's output norm), ("norm", hw, C) per GroupNorm without
    SiLU (a spatial transformer's or a motion module's, before its other
    sites), ("spatial", S, D, poolable) per transformer block's
    self-attention, ("motion", hw, C) per motion module.
    `shallow_level`: the DeepCache shallow pass over levels 0..shallow_level
    (models/unet.py). `pool_mid`: whether the middle block's self keys may
    be pooled (the UNet's may, the ControlNet's never, as in JAX)."""
    from magicdance_tpu_torch.models.unet import decoder_plan, unet_plan

    units, skip_ch, ds_mid = unet_plan(ucfg)
    out = []
    shallow = shallow_level is not None

    def hw(ds):
        return (latent // ds) ** 2

    def spatial(ds, ch, depth, poolable=True):
        out.append(("norm", hw(ds), ch))
        out.extend([("spatial", hw(ds), ucfg.heads_at(ch)[1], poolable)] * depth)

    def motion(ds, ch):
        if ucfg.use_motion_modules:
            out.extend([("norm", hw(ds), ch), ("motion", hw(ds), ch)])

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
                spatial(u["ds"], ch, u["depth"])
            motion(u["ds"], ch)
    mid_ch = ucfg.model_channels * ucfg.channel_mult[-1]
    if not shallow:
        res(ds_mid, ch, mid_ch)
        spatial(ds_mid, mid_ch, ucfg.depth_middle, pool_mid)
        res(ds_mid, mid_ch, mid_ch)
    if decoder:
        ch, skips = mid_ch, list(skip_ch)
        for u in decoder_plan(ucfg):
            skip = skips.pop()
            if not shallow or u["level"] <= shallow_level:
                res(u["ds"], ch + skip, u["ch"])
                if u["attn"]:
                    spatial(u["ds"], u["ch"], u["depth"])
                motion(u["ds"], u["ch"])
            ch = u["ch"]
        out.append(("gn", hw(1), ucfg.model_channels))
    return out


def request_launch_plan(model_cfg, latent: int, batch: int, scfg, frames: int = 1,
                        fused_gn: bool = True, video: bool = False) -> dict:
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
    bank_downsample_min_seq. `fused_gn`: the card's default, every
    GroupNorm with H*W >= layers.FUSED_GN_MIN_HW, with SiLU or without,
    launches K8's two kernels; False: MAGICDANCE_FUSED_GN=0 (none does)."""
    from collections import Counter

    from magicdance_tpu_torch.models.controlnet import controlnet_unet_config
    from magicdance_tpu_torch.models.layers import FUSED_GN_MIN_HW
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
            if site[0] in ("gn", "norm"):
                if fused_gn and site[1] >= FUSED_GN_MIN_HW:
                    c["groupnorm_silu"] += 2
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


def flash_launch_plan(cfg, latent: int, batch: int):
    """Kernel launches of one train step under attention_impl="flash", by
    (mode, B, S_q, S_kv, D) (S_kv: a bank read's self and bank keys
    together): JAX's dispatch under the override sends every denoiser site
    to its BSNH flash kernels -- self-attention, bank reads and the
    cross-attention over the context's tokens at any S, the temporal S = F
    sites too (no grouped kernel) -- so each site runs the autograd
    Functions where its inputs need a gradient (the LSE forward twice under
    remat, dQ where the queries need one, dK/dV per source whose keys need
    one) and kernel A or B without the LSE once where they do not.

    Stage 2 (FINETUNE_CONTROL, `batch` images): the appearance UNet and the
    ControlNet train, so each of their sites needs every gradient, except the
    appearance UNet's last transformer block, which feeds nothing the loss
    reads; in the frozen main UNet every bank read needs the bank's dK/dV and
    all but the first dQ and the self source's dK/dV, and every
    cross-attention needs dQ alone (the context and the frozen projections
    need none). Stage 3 (MOTION_ONLY, `batch` clips of cfg.video_frames):
    the appearance UNet and the ControlNet launch A and B without the LSE;
    in the main UNet the sites before the first motion module too, each
    motion-module attention needs every gradient, and every later bank read
    needs dQ and the self source's dK/dV (the frozen bank none), every later
    cross-attention dQ. The VAE and CLIP run under "auto"."""
    from collections import Counter

    from magicdance_tpu_torch.config import FreezeRegime
    from magicdance_tpu_torch.models.controlnet import controlnet_unet_config
    from magicdance_tpu_torch.models.magicpose import appearance_unet_config

    m = cfg.model
    ctx = m.clip.max_length
    fwd = 2 if m.unet.remat else 1
    plan = Counter()

    def function(b, sq, kv, d, dq=True, dkv=(True,)):
        """One site through an autograd Function: kv lists its sources'
        lengths, dkv whether each source's keys need a gradient."""
        two = len(kv) == 2
        plan["two_source_attention_lse" if two else "self_attention_lse", b, sq, sum(kv), d] += fwd
        if dq:
            plan["attention_dq_two_source" if two else "attention_dq", b, sq, sum(kv), d] += 1
        for sk, need in zip(kv, dkv):
            if need:
                plan["attention_dkv", b, sq, sk, d] += 1

    def spatial(ucfg, decoder=True):
        return [(s, d) for kind, s, d in unet_sites(ucfg, latent, decoder) if kind == "spatial"]

    app = spatial(appearance_unet_config(m)) if m.has_appearance else []
    cn = (spatial(controlnet_unet_config(m.pose_control, m.unet.in_channels), decoder=False)
          if m.has_pose else [])
    if cfg.freeze is FreezeRegime.FINETUNE_CONTROL and not m.has_temporal:
        for i, (s, d) in enumerate(app):
            last = i == len(app) - 1
            function(batch, s, [s], d, dq=not last, dkv=(not last,))
            function(batch, s, [ctx], d, dq=not last, dkv=(not last,))
        for s, d in cn:
            function(batch, s, [s], d)
            function(batch, s, [ctx], d)
        for i, (s, d) in enumerate(spatial(m.unet)):
            function(batch, s, [s, s], d, dq=i > 0, dkv=(i > 0, True))
            function(batch, s, [ctx], d, dkv=(False,))
    elif cfg.freeze is FreezeRegime.MOTION_ONLY and m.has_temporal:
        frames = cfg.video_frames
        n = batch * frames
        for s, d in app:
            plan["self_attention", batch, s, s, d] += 1
            plan["self_attention", batch, s, ctx, d] += 1
        for s, d in cn:
            plan["self_attention", n, s, s, d] += 1
            plan["self_attention", n, s, ctx, d] += 1
        grad, u = False, m.unet
        for kind, s, x in unet_sites(u, latent):
            if kind == "motion":
                grad = True
                for _ in range(u.motion_layers * u.motion_attn_blocks):
                    function(batch * s, frames, [frames], x // u.motion_num_heads)
            elif grad:
                function(n, s, [s, s], x, dkv=(True, False))
                function(n, s, [ctx], x, dkv=(False,))
            else:
                plan["two_source_attention", n, s, 2 * s, x] += 1
                plan["self_attention", n, s, ctx, x] += 1
    else:
        raise ValueError(f"no flash launch plan for {cfg.freeze} on {m.variant}")
    return plan


def plan_totals(plan) -> dict:
    """Launches by kernel mode of a plan keyed (mode, ...)."""
    out = {}
    for key, n in plan.items():
        out[key[0]] = out.get(key[0], 0) + n
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
        if timed:  # the earlier body (attention_tc) on the same inputs
            got_o, got_lse = fwd(*fargs, body="mma_sync")
            check(fname, got_o, out, f"{label} o mma_sync", grad=False)
            check(fname, got_lse, lse, f"{label} lse mma_sync", grad=False)
        delta = V.attention_delta(dout, out)
        dq_args = (q, k, v, dout, lse, delta, None, kb, vb)
        bf16 = q.dtype == torch.bfloat16
        b, sq, h, d = q.shape
        if bf16:  # C and D on both bodies, and the default one twice
            hold_bwd_bodies(check, "attention_dq", lambda **kw: V.attention_dq(*dq_args, **kw),
                            V.attention_dq_ref(*dq_args), label, d, "dq")
        else:
            check("attention_dq", V.attention_dq(*dq_args), V.attention_dq_ref(*dq_args),
                  f"{label} dQ", grad=True)
        for src, (kk, vv) in (("self", (k, v)),) + ((("bank", (kb, vb)),) if two else ()):
            dkv_args = (kk, vv, q, dout, lse, delta)
            if bf16:
                hold_bwd_bodies(check, "attention_dkv",
                                lambda kw_args=dkv_args, **kw: V.attention_dkv(*kw_args, **kw),
                                V.attention_dkv_ref(*dkv_args), f"{label} ({src} source)", d,
                                "dkv")
                continue
            for g_, w_, nm in zip(V.attention_dkv(*dkv_args), V.attention_dkv_ref(*dkv_args),
                                  ("dK", "dV")):
                check("attention_dkv", g_, w_, f"{label} {nm} ({src} source)", grad=True)
        if not timed:
            return
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
            "lse": (lambda **kw: fwd(*fargs, **kw), lambda: fwd_ref(*fargs), kv,
                    "two_source_attention_lse" if two else "self_attention_lse"),
            "dq": (lambda **kw: V.attention_dq(*dq_args, **kw),
                   lambda: V.attention_dq_ref(*dq_args), kv,
                   "attention_dq_two_source" if two else "attention_dq"),
            "dkv": (lambda **kw: V.attention_dkv(*src_kv, q, dout, lse, delta, **kw),
                    lambda: V.attention_dkv_ref(*src_kv, q, dout, lse, delta),
                    [(src_kv[0].shape[0], src_kv[0].shape[1])], "attention_dkv"),
        }
        for kind, (kern, plain, kv_, mode) in cases.items():
            bodies = {}
            if kind == "lse":
                ms = device_time_ms(kern)
                tc_ms = device_time_ms(lambda: fwd(*fargs, body="mma_sync"))
            else:  # C or D: both bodies, the one attention_body picks is the kernel's time
                walked = sq * (b if kind == "dkv" and kv_[0][0] == 1 and b > 1 else 1)
                chosen, t = body_times(kern, d, walked, tuple(n for _, n in kv_), kind)
                ms, tc_ms = t[chosen], t.get("mma_sync")
                bodies = dict(body=chosen, wgmma_ms=t.get("wgmma"))
            plain_ms = device_time_ms(plain, min_total_s=0.1, max_iters=5)
            bound, bound_by = training_bound_ms(kind, b, sq, h, d, kv_)
            # dK/dV of a bank source at bank batch B has the self source's
            # shapes: the plan's dK/dV launches at (S, D) go to the self row
            per_step = 0 if (kind == "dkv" and two) else plan.get((mode, sq, d), 0)
            rows.append(dict(mode=mode, kind=kind, B=b, S=sq, D=d, H=h,
                             bank_batch=kb.shape[0] if two else None,
                             launches_per_step=per_step, kernel_ms=ms, plain_ms=plain_ms,
                             library_ms=lib[kind], bound_ms=bound, bound_by=bound_by,
                             exp_bound_ms=exp_bound_ms(b, sq, h, kv_), **bodies,
                             **({"mma_sync_ms": tc_ms} if tc_ms is not None else {})))
            log(f"      {mode:25s} kernel_ms={ms:.4f} " + bodies_text(bodies, tc_ms)
                + f"plain_ms={plain_ms:.4f} "
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

        def dq_kern(**kw):
            return V.attention_dq(q, k, v, dout, lse, delta, None, kb, vb, **kw)

        def dq_plain():
            return by_frames(lambda q_, k_, v_, do_, l_, d_: V.attention_dq_ref(
                q_, k_, v_, do_, l_, d_, None, kb, vb), q, k, v, dout, lse, delta)

        def dkv_kern(**kw):
            return V.attention_dkv(k, v, q, dout, lse, delta, **kw)

        def dkv_plain():
            return by_frames(V.attention_dkv_ref, k, v, q, dout, lse, delta)

        hold_bwd_bodies(check, "attention_dq", dq_kern, dq_plain(), label, d, "dq")
        hold_bwd_bodies(check, "attention_dkv", dkv_kern, dkv_plain(), f"{label} (self source)",
                        d, "dkv")
        kh = torch.cat([k, kb.expand(frames, -1, -1, -1)], 1)
        vh = torch.cat([v, vb.expand(frames, -1, -1, -1)], 1)
        qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_() for t in (q, kh, vh))
        lib_out = F.scaled_dot_product_attention(qs, ks, vs)
        g = dout.transpose(1, 2)
        for kind, mode, kern, plain, kv in (
                ("dq", "attention_dq_two_source", dq_kern, dq_plain, [(frames, s), (1, s)]),
                ("dkv", "attention_dkv", dkv_kern, dkv_plain, [(frames, s)])):
            chosen, t = body_times(kern, d, s, tuple(n for _, n in kv), kind)
            ms, bodies = t[chosen], dict(body=chosen, wgmma_ms=t.get("wgmma"),
                                          mma_sync_ms=t.get("mma_sync"))
            plain_ms = device_time_ms(plain, min_total_s=0.1, max_iters=3)
            lib = device_time_ms(lambda: torch.autograd.grad(
                lib_out, [qs] if kind == "dq" else [ks, vs], g, retain_graph=True))
            bound, bound_by = training_bound_ms(kind, frames, s, heads, d, kv)
            rows.append(dict(mode=mode, kind=kind, path="stage 3", B=frames, S=s, D=d, H=heads,
                             bank_batch=1 if kind == "dq" else None,
                             launches_per_step=per_step, kernel_ms=ms, plain_ms=plain_ms,
                             library_ms=lib, bound_ms=bound, bound_by=bound_by,
                             exp_bound_ms=exp_bound_ms(frames, s, heads, kv), **bodies))
            log(f"      {mode:25s} kernel_ms={ms:.4f} " + bodies_text(bodies)
                + f"plain_ms={plain_ms:.4f} (by {chunk} "
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
            check(errs, checked, "two_source_attention_gated",
                  K.two_source_attention(*args, bank_mask=mask, body="mma_sync"),
                  K.two_source_attention_ref(*args, bank_mask=mask), tol, label + " mma_sync")
            ms = device_time_ms(lambda: K.two_source_attention(*args, bank_mask=mask))
            tc_ms = device_time_ms(lambda: K.two_source_attention(*args, bank_mask=mask,
                                                                  body="mma_sync"))
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
                             kernel_ms=ms, mma_sync_ms=tc_ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bound, bound_by=by,
                             exp_bound_ms=exp_ms))
            log(f"      kernel_ms={ms:.4f} mma_sync_ms={tc_ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={lib_ms:.4f} "
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
                    ("self_attention", lambda **kw: K.self_attention(q, k, v, **kw),
                     lambda: K.self_attention_ref(q, k, v), [(frames, sk)], k, v),
                    ("two_source_attention",
                     lambda **kw: K.two_source_attention(q, k, v, kb, vb, **kw),
                     lambda: K.two_source_attention_ref(q, k, v, kb, vb),
                     [(frames, sk), (1, sk)], torch.cat([k, kb.expand(frames, -1, -1, -1)], 1),
                     torch.cat([v, vb.expand(frames, -1, -1, -1)], 1))):
                chosen, t = body_times(kern, 40, 4096, tuple(n for _, n in kv))
                ms = t[chosen]
                plain_ms = device_time_ms(plain, min_total_s=0.1, max_iters=5)
                kh, vh = kk.transpose(1, 2), vv.transpose(1, 2)
                lib_ms = device_time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
                bound, by = attention_bound_ms(frames, 4096, heads, 40, kv)
                exp_ms = exp_bound_ms(frames, 4096, heads, kv)
                rows.append(dict(kernel=name, B=frames, S=4096, S_k=sk, D=40, H=heads,
                                 pooled=p, launches_per_step=0, body=chosen, kernel_ms=ms,
                                 wgmma_ms=t["wgmma"], mma_sync_ms=t["mma_sync"],
                                 plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                                 bound_by=by, exp_bound_ms=exp_ms))
                log(f"      {name} pooled {p}x{p}: kernel_ms={ms:.4f} ({chosen}) "
                    f"wgmma_ms={t['wgmma']:.4f} mma_sync_ms={t['mma_sync']:.4f} "
                    f"plain_ms={plain_ms:.4f} "
                    f"library_ms={lib_ms:.4f} bound_ms={bound:.4f} ({by}) "
                    f"exp_bound_ms={exp_ms:.4f}")
            del q, k, v, kb, vb
            torch.cuda.empty_cache()
    return rows, errs, checked


@contextlib.contextmanager
def recording_groupnorm_sites(model, seen: dict):
    """While the block runs, count into `seen` each (B, HW, C, groups, eps,
    act) at which a GroupNorm32 module of `model` runs with HW >=
    layers.FUSED_GN_MIN_HW, act "silu" (a ResBlock's, the output norm) or
    None (a transformer's): forward hooks."""
    from magicdance_tpu_torch.models.layers import FUSED_GN_MIN_HW, GroupNorm32

    def hook(mod, inputs, _out):
        b, c, hh, ww = inputs[0].shape
        if hh * ww >= FUSED_GN_MIN_HW:
            key = (b, hh * ww, c, mod.norm.num_groups, mod.norm.eps,
                   "silu" if mod.act else None)
            seen[key] = seen.get(key, 0) + 1

    handles = [mod.register_forward_hook(hook) for mod in model.modules()
               if isinstance(mod, GroupNorm32)]
    try:
        yield seen
    finally:
        for h in handles:
            h.remove()


def sorted_gn_sites(seen: dict) -> list:
    return sorted(seen.items(), key=lambda kv: (-kv[0][1], kv[0][2], kv[0][0], str(kv[0][5])))


def groupnorm_sites(pipe, frames: int) -> list:
    """Every (B, HW, C, groups, eps, act) at which the appearance UNet
    (B = 1), the ControlNet and the main UNet (B = frames) call GroupNorm
    with HW >= layers.FUSED_GN_MIN_HW at 512x512 (`recording_groupnorm_sites`
    over one call of each pass), with its count."""
    import torch

    m = pipe.model
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(frames, 64, 64, 4, generator=gen, device="cuda")
    t = torch.full((frames,), 501, dtype=torch.int64, device="cuda")
    hint = torch.rand(frames, 512, 512, 3, generator=gen, device="cuda")
    with recording_groupnorm_sites(m, {}) as seen, torch.inference_mode():
        ctx = pipe.encode_empty(1).expand(frames, -1, -1)
        bank = m.compute_bank(x[:1], t[:1], ctx[:1])
        res = m.compute_control_residuals(x, hint, t, ctx)
        m.unet(x, t, ctx, bank=bank, pose_residuals=res)
    return sorted_gn_sites(seen)


# the first level of the 16-frame video request: K8's largest input (B, HW,
# C, groups, eps, act), timed beside the image sites
GN_VIDEO_SITE = (16, 4096, 320, 32, 1e-5, "silu")


def check_groupnorm_kernel(sites, per_step: dict, extra=(GN_VIDEO_SITE,)):
    """Phase 14b: K8 against its plain version at every GroupNorm site of
    the model, with its epilogue (SiLU or none), and at `extra` (bf16
    with a bf16 affine, timed, and fp32), each run twice on the same input
    and required to give the same bits (no atomics, no order that depends
    on scheduling). Bound: one read and one write of x over the memory rate
    vs ~10 operations per element. Library: F.group_norm, then F.silu where
    the site has it. `per_step`: {(B, HW, C, act): K8 calls per DDIM step,
    two launches each}; the rows' `launches_per_step` carry those calls (a
    call's time covers both kernels), the `extra` sites' 0 and path
    "video"."""
    import torch
    import torch.nn.functional as F

    from magicdance_tpu_torch.ops.kernels import groupnorm as GN
    from magicdance_tpu_torch.utils.timing import device_time_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(99)
    errs, checked, rows = {}, {}, []
    for (b, hw, c, groups, eps, act), n_calls in list(sites) + [(x, 0) for x in extra]:
        w32 = torch.randn(c, generator=gen, device=dev) * 0.2 + 1
        bias32 = torch.randn(c, generator=gen, device=dev) * 0.2
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            w, bias = w32.to(dtype), bias32.to(dtype)  # stored as the model stores them
            x = torch.randn(b, hw, c, generator=gen, device=dev).to(dtype)
            label = (f"{str(dtype)[6:]} B={b} HW={hw} C={c} groups={groups} eps={eps:g} "
                     f"act={act}")
            got = GN.groupnorm_act(x, w, bias, groups, eps, act)
            check(errs, checked, "groupnorm_silu", got,
                  GN.groupnorm_silu_ref(x, w, bias, groups, eps, act), tol, label)
            again = GN.groupnorm_act(x, w, bias, groups, eps, act)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"groupnorm_silu {label}: two runs on the same input "
                                     f"differ (max {(got.float() - again.float()).abs().max()})")
            if dtype != torch.bfloat16:
                continue
            side = int(round(hw ** 0.5))
            xn = x.view(b, side, side, c).permute(0, 3, 1, 2)  # NCHW, channels_last
            ms = device_time_ms(lambda: GN.groupnorm_act(x, w, bias, groups, eps, act))
            plain_ms = device_time_ms(
                lambda: GN.groupnorm_silu_ref(x, w, bias, groups, eps, act),
                min_total_s=0.1, max_iters=10)
            lib = (lambda: F.silu(F.group_norm(xn, groups, w, bias, eps))) if act else (
                lambda: F.group_norm(xn, groups, w, bias, eps))
            lib_ms = device_time_ms(lib)
            n = b * hw * c
            t_mem = 2 * n * x.element_size() / PEAK_BYTES * 1e3
            t_ops = 10.0 * n / PEAK_BF16_FLOPS * 1e3
            bound, by = (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")
            launches = per_step.get((b, hw, c, act), 0) if n_calls else 0
            rows.append(dict(kernel="groupnorm_silu", B=b, HW=hw, C=c, groups=groups, eps=eps,
                             act=act or "none",
                             sites_per_pass=n_calls, launches_per_step=launches, kernel_ms=ms,
                             plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by,
                             **({} if n_calls else {"path": "video"})))
            log(f"      kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                f"bound_ms={bound:.4f} ({by}) x{launches} calls/step")
    return rows, errs, checked


def gn_plan_by_shape(model_cfg, latent: int, frames: int) -> dict:
    """K8 calls (two launches each) per DDIM step of the exact recipe, by
    (B, HW, C, act), act "silu" or None: write pass (B = 1), ControlNet,
    cond and uncond passes (B = frames)."""
    from collections import Counter

    from magicdance_tpu_torch.models.controlnet import controlnet_unet_config
    from magicdance_tpu_torch.models.layers import FUSED_GN_MIN_HW
    from magicdance_tpu_torch.models.magicpose import appearance_unet_config

    c = Counter()
    cn = controlnet_unet_config(model_cfg.pose_control, model_cfg.unet.in_channels)
    for ucfg, b, decoder, passes in ((appearance_unet_config(model_cfg), 1, True, 1),
                                     (cn, frames, False, 1), (model_cfg.unet, frames, True, 2)):
        for site in pass_sites(ucfg, latent, decoder):
            if site[0] in ("gn", "norm") and site[1] >= FUSED_GN_MIN_HW:
                c[b, site[1], site[2], "silu" if site[0] == "gn" else None] += passes
    return dict(c)


def small_turbo_checks():
    """Phase 15: narrow models at 128x128, the card (kernels) against the CPU
    (plain versions), fp32, the same weights and x_T: one fused-CFG sample,
    the `turbo` and `turbo_max` stacks (pooling thresholds at the narrow
    model's 256-token first level), the `turbo` stack through the overlap
    sampler on the temporal model (F = 10, windows of 4, stride 3), all with
    K8 at its sites (the default), and an exact sample with
    MAGICDANCE_FUSED_GN=0 (no K8). Each card run is held to its launch plan
    (request_launch_plan, plus the reference's VAE encode)."""
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
    cases = {"fused_cfg": (False, dict(steps=4, fused_cfg=True), True),
             "turbo": (False, dict(steps=4, **TURBO, **NARROW_POOL), True),
             "turbo_max": (False, dict(TURBO_MAX, steps=6, **NARROW_POOL), True),
             "video_turbo": (True, dict(steps=4, window=4, stride=3, **TURBO, **NARROW_POOL),
                             True),
             "plain_gn": (False, dict(steps=3), False)}
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
        if not fused_gn:
            os.environ["MAGICDANCE_FUSED_GN"] = "0"
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
                   video: bool = False, fused_gn: bool = True, image_hints: bool = False):
    """`requests` full-width requests of `frames` pose maps at 512x512 under
    `scfg` (with as many image hints for the DUAL_CONTROL variant when
    `image_hints`; with MAGICDANCE_FUSED_GN=0 unless `fused_gn`), each held
    to `plan` (launches per request); seconds per request, frames/s and
    peak memory."""
    import torch

    from magicdance_tpu_torch.ops import kernels as K

    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = [(torch.rand(frames, 512, 512, 3, generator=gen, device="cuda"),
               torch.rand(1, 512, 512, 3, generator=gen, device="cuda") * 2 - 1,
               torch.rand(frames, 512, 512, 3, generator=gen, device="cuda") if image_hints
               else None)
              for _ in range(requests)]
    saved = os.environ.get("MAGICDANCE_FUSED_GN")
    if not fused_gn:
        os.environ["MAGICDANCE_FUSED_GN"] = "0"
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
    from magicdance_tpu_torch.utils.profiling import device_busy_ms, span, top_ops, trace

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
        with span("ddim_step"):
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
# phase 25: distribution on the card (torch.distributed)
# --------------------------------------------------------------------------

P25_TRAIN_STEPS = 3
P25_VIDEO = dict(frames=16, steps=10, window=8, stride=4)  # 4 windows of 8: 2 a rank at world 2


def p25_train_config(batch: int):
    """Phase 9's stage-2 preset at `batch` images a rank, warm-up 1, with
    adam_eps 1e-4 (as the CPU trainer tests): Adam divides every element by
    its own scale, and 1e-4 keeps rounding noise in near-zero gradients from
    becoming O(lr) steps, so updates compare to 2% of the learning rate."""
    import dataclasses

    from magicdance_tpu_torch import config as C

    cfg = C.stage2_pose_control()
    return dataclasses.replace(cfg, batch_size_per_device=batch, optim=dataclasses.replace(
        cfg.optim, warmup_steps=1, adam_eps=1e-4))


def p25_batches(rows=None):
    """Phase 9's first batches (the same generator seed), B = 2; `rows`:
    (start, stop) of them a rank keeps."""
    import torch

    from magicdance_tpu_torch.data.tokenizer import empty_prompt_ids

    gen = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.from_numpy(empty_prompt_ids(2, 77)).cuda()
    out = []
    for _ in range(P25_TRAIN_STEPS):
        b = {"image": torch.rand(2, 512, 512, 3, generator=gen, device="cuda") * 2 - 1,
             "reference": torch.rand(2, 512, 512, 3, generator=gen, device="cuda") * 2 - 1,
             "pose": torch.rand(2, 512, 512, 3, generator=gen, device="cuda"),
             "input_ids": ids}
        out.append({k: v[rows[0]:rows[1]] for k, v in b.items()} if rows else b)
    return out


def p25_train(steps: int, batch: int, rows=None, keep_step: int = 0):
    """`steps` stage-2 steps of a fresh trainer (seeded weights, phase 9's
    batches; under a process group its rows of them): per step loss, grad
    norm, seconds and launches; the optimizer bytes this rank holds and the
    peak memory; the trainable parameters after `keep_step` (on the host)
    and after the last step (on the card)."""
    import torch

    from magicdance_tpu_torch.ops import kernels as K
    from magicdance_tpu_torch.train.trainer import Trainer

    cfg = p25_train_config(batch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, device="cuda")
    tr.init_random(seed=0)
    build_s = time.perf_counter() - t0
    out = dict(loss=[], grad_norm=[], seconds=[], launches=[], build_s=build_s,
               lr=cfg.optim.learning_rate)
    for i, b in enumerate(p25_batches(rows)[:steps]):
        K.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = tr.train_step(b)
        torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t)
        out["launches"].append({k: n for k, n in K.LAUNCHES.items() if n})
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        if i + 1 == keep_step:
            out["kept"] = {k: p.detach().cpu() for k, p in tr.train_params.items()}
    out["opt_bytes"] = tr.opt.state_bytes()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["params"] = {k: p.detach().clone() for k, p in tr.train_params.items()}
    out["mesh"] = (dict(zip(tr.mesh.mesh_dim_names, tr.mesh.shape)) if tr.mesh is not None
                   else None)
    del tr
    torch.cuda.empty_cache()
    return out


def p25_inputs(frames: int):
    """One request's pose maps and reference (512x512) and shared x_T."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(25)
    pose = torch.rand(frames, 512, 512, 3, generator=gen, device="cuda")
    ref = torch.rand(1, 512, 512, 3, generator=gen, device="cuda") * 2 - 1
    x_T = torch.randn(1, 64, 64, 4, generator=gen, device="cuda").expand(frames, 64, 64, 4)
    return pose, ref, x_T.contiguous()


def p25_request(pipe, scfg, frames: int, mesh, video: bool, plan: dict, label: str):
    """One request (seeded inputs; video: fixed offsets) with `mesh` or
    without; its output on the host, seconds, launches (held to `plan`)."""
    import torch

    from magicdance_tpu_torch.ops import kernels as K

    pose, ref, x_T = p25_inputs(frames)
    offsets = [(5 * i) % frames for i in range(scfg.steps)] if video else None
    K.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = pipe.sample_frames(pose, ref, scfg, x_T=x_T, video=video, window_offsets=offsets,
                             mesh=mesh)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = {m: n for m, n in K.LAUNCHES.items() if n}
    if launches != plan:
        raise AssertionError(f"{label}: launches {launches}, plan {plan}")
    if tuple(out.shape) != (frames, 512, 512, 3) or not torch.isfinite(out).all():
        raise AssertionError(f"{label}: bad output {tuple(out.shape)}")
    return out.cpu(), secs, launches


def p25_serving(mesh, rows_of_windows: int, unsharded: bool = False):
    """The image request (F = 2, DDIM-50, CFG 7) and the video request
    (16 frames in windows of 8, stride 4, DDIM-10) with `mesh`, each on a
    fresh full-width pipeline with seeded weights; with `unsharded`, the
    same requests without the mesh first, on the same pipeline."""
    import torch

    from magicdance_tpu_torch.config import ModelConfig, SampleConfig
    from magicdance_tpu_torch.parallel.mesh import as_axis
    from magicdance_tpu_torch.pipeline import MagicPosePipeline

    axis = as_axis(mesh)
    v = P25_VIDEO
    f0, f1 = axis.rows(2)
    image_cfg, video_cfg = ModelConfig(), temporal_model_config()
    image_scfg = SampleConfig()
    video_scfg = SampleConfig(steps=v["steps"], window=v["window"], stride=v["stride"])
    out = {}
    for name, cfg, scfg, frames, video, plan in (
            ("image", image_cfg, image_scfg, 2, False,
             request_launch_plan(image_cfg, 64, f1 - f0, image_scfg)),
            ("video", video_cfg, video_scfg, v["frames"], True,
             request_launch_plan(video_cfg, 64, rows_of_windows, video_scfg,
                                 frames=v["window"], video=True))):
        t0 = time.perf_counter()
        pipe = MagicPosePipeline(cfg, device="cuda")
        pipe.init_params(seed=0)
        torch.cuda.synchronize()
        out[f"{name}_build_s"] = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        if unsharded:
            out[f"{name}_plain"] = p25_request(pipe, scfg, frames, None, video, plan,
                                               f"unsharded {name} request")
        out[name] = p25_request(pipe, scfg, frames, mesh, video, plan, f"{name} request")
        out[f"{name}_peak_bytes"] = torch.cuda.max_memory_allocated()
        del pipe
        torch.cuda.empty_cache()
    return out


def p25_windows(world: int, rank: int) -> int:
    """Rows of this rank's windows in one pass of the video request (the
    windows split as `torch.tensor_split` splits them)."""
    from magicdance_tpu_torch.sampling.overlap import window_starts

    v = P25_VIDEO
    n = len(window_starts(v["frames"], v["window"], v["stride"]))
    return (n // world + (1 if rank < n % world else 0)) * v["window"]


def bf16_agreement(got, want, label: str) -> str:
    """'bit for bit', or the max deviation within min(5e-2, 0.1 x RMS) of
    `want` (the bf16 rule); raises beyond it."""
    import torch

    if torch.equal(got, want):
        return "bit for bit"
    err = float((got.float() - want.float()).abs().max())
    rms = float(want.float().pow(2).mean().sqrt())
    tol = min(BF16_TOL, BF16_REL_TOL * rms)
    if not err <= tol:
        raise AssertionError(f"{label}: max abs {err:.3e} > bf16 tolerance {tol:.3e}")
    return f"max abs {err:.3e} <= {tol:.3e} (bf16 rule, RMS {rms:.3e})"


def params_agree(got: dict, want: dict, lr: float, label: str) -> float:
    """Every trainable tensor within 2% of the learning rate; the largest
    deviation."""
    worst = 0.0
    for k, w in want.items():
        err = float((got[k].to(w.device) - w).abs().max())
        worst = max(worst, err)
        if not err <= 0.02 * lr:
            raise AssertionError(f"{label}: {k} differs by {err:.3e} > 2% of lr {lr:g}")
    return worst


def rel_agree(got: list, want: list, tol: float, label: str) -> None:
    for i, (a, b) in enumerate(zip(got, want)):
        if not abs(a - b) <= tol * abs(b):
            raise AssertionError(f"{label} step {i + 1}: {a!r} vs {b!r} (> {tol:g} relative)")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def distribution_on_card(card: str) -> dict:
    """Phase 25: 25a one rank over NCCL, 25b two ranks sharing the card over
    gloo (spawned), each held to the unsharded or world-1 results."""
    import shutil
    import subprocess

    import torch
    import torch.distributed as dist

    from magicdance_tpu_torch.parallel.mesh import make_mesh
    from magicdance_tpu_torch.parallel.multihost import initialize_distributed

    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "chiprun_out", "phase25")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    res = {"card": card}
    try:
        # -- 25a: the unsharded references, then one NCCL rank -----------------
        _, totals, _ = training_launch_plan(p25_train_config(2).model, 64)
        plain = p25_train(P25_TRAIN_STEPS, 2)
        initialize_distributed(backend="nccl", init_method=f"tcp://localhost:{free_port()}",
                               world_size=1, rank=0)
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError("25a: not a one-rank NCCL group")
        dp = p25_train(P25_TRAIN_STEPS, 2, keep_step=2)
        mesh = make_mesh(("data",))
        serve_dp = p25_serving(mesh, p25_windows(1, 0), unsharded=True)
        serve_plain = {k: serve_dp[f"{k}_plain"] for k in ("image", "video")}
        dist.destroy_process_group()
        expect = {m: n for m, n in totals.items() if n}
        for label, run in (("plain", plain), ("world 1", dp)):
            for i, got in enumerate(run["launches"]):
                if got != expect:
                    raise AssertionError(f"25a {label} step {i + 1}: launches {got}, plan "
                                         f"{expect}")
        rel_agree(dp["loss"], plain["loss"], 1e-3, "25a loss")
        rel_agree(dp["grad_norm"], plain["grad_norm"], 1e-3, "25a grad norm")
        worst = params_agree(dp["params"], plain["params"], dp["lr"], "25a parameters")
        if dp["mesh"] != {"data": 1}:
            raise AssertionError(f"25a: mesh {dp['mesh']}")
        agree_image = bf16_agreement(serve_dp["image"][0], serve_plain["image"][0],
                                     "25a image request")
        agree_video = bf16_agreement(serve_dp["video"][0], serve_plain["video"][0],
                                     "25a video request")
        steady = lambda s: sum(s[1:]) / max(1, len(s) - 1)  # noqa: E731
        log(f"  25a training, world 1 over NCCL vs the plain trainer ({P25_TRAIN_STEPS} steps, "
            f"B = 2): losses {[round(x, 6) for x in dp['loss']]} vs "
            f"{[round(x, 6) for x in plain['loss']]}, grad norms "
            f"{[round(x, 6) for x in dp['grad_norm']]}; parameters within {worst:.3e} "
            f"(2% of lr = {0.02 * dp['lr']:.1e}); s/step {[round(x, 3) for x in dp['seconds']]} "
            f"(steady {steady(dp['seconds']):.3f}) vs plain "
            f"{[round(x, 3) for x in plain['seconds']]} (steady {steady(plain['seconds']):.3f}); "
            f"optimizer bytes {dp['opt_bytes']} vs {plain['opt_bytes']}; peak memory "
            f"{dp['peak_bytes'] / 2**30:.2f} vs {plain['peak_bytes'] / 2**30:.2f} GiB; "
            f"launches per step {expect}; trainer built in {dp['build_s']:.1f} s, pipelines "
            f"in {serve_dp['image_build_s']:.1f} / {serve_dp['video_build_s']:.1f} s")
        log(f"  25a image request (F = 2, DDIM-50, CFG 7), frame-parallel world 1: "
            f"{serve_dp['image'][1]:.3f} s vs unsharded {serve_plain['image'][1]:.3f} s, "
            f"{agree_image}; video request (16 frames, windows of 8 stride 4, DDIM-10), "
            f"window-parallel world 1: {serve_dp['video'][1]:.3f} s vs unsharded "
            f"{serve_plain['video'][1]:.3f} s, {agree_video}")
        res["a"] = dict(
            train_plain=dict(loss=plain["loss"], grad_norm=plain["grad_norm"],
                             seconds=plain["seconds"], opt_bytes=plain["opt_bytes"],
                             peak_bytes=plain["peak_bytes"]),
            train_world1=dict(loss=dp["loss"], grad_norm=dp["grad_norm"],
                              seconds=dp["seconds"], opt_bytes=dp["opt_bytes"],
                              peak_bytes=dp["peak_bytes"], params_max_dev=worst),
            image=dict(seconds=serve_dp["image"][1], unsharded_s=serve_plain["image"][1],
                       agreement=agree_image, peak_bytes=serve_dp["image_peak_bytes"]),
            video=dict(seconds=serve_dp["video"][1], unsharded_s=serve_plain["video"][1],
                       agreement=agree_video, peak_bytes=serve_dp["video_peak_bytes"]))
        launches = {"train": dict(sum_counts(dp["launches"])),
                    "image": serve_dp["image"][2], "video": serve_dp["video"][2]}
        world1 = dict(image=serve_dp["image"][0], video=serve_dp["video"][0],
                      kept=dp["kept"], loss=dp["loss"][:2], grad_norm=dp["grad_norm"][:2],
                      lr=dp["lr"], opt_bytes=dp["opt_bytes"])
        del plain, dp, serve_plain, serve_dp
        torch.cuda.empty_cache()

        # -- 25b: two ranks on the one card over gloo --------------------------
        t_b = time.perf_counter()
        init = f"file://{os.path.join(work, 'rdzv')}"
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        logs = [open(os.path.join(work, f"rank{r}.log"), "w") for r in range(2)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--p25-rank",
                                   str(r), "--p25-init", init, "--p25-work", work],
                                  stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=ROOT)
                 for r in range(2)]
        try:
            for p in procs:
                p.wait(timeout=max(1.0, 600 - (time.perf_counter() - t_b)))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                with open(os.path.join(work, f"rank{r}.log")) as f:
                    tail = f.read()[-4000:]
                raise AssertionError(f"25b rank {r} exited {p.returncode}:\n{tail}")
        for r in range(2):
            with open(os.path.join(work, f"rank{r}.log")) as f:
                for line in f:
                    if line.startswith("  rank"):
                        log(line.rstrip())
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        b_secs = time.perf_counter() - t_b
        for r, got in enumerate(ranks):
            if not torch.equal(got["image"][0], ranks[0]["image"][0]) or not torch.equal(
                    got["video"][0], ranks[0]["video"][0]):
                raise AssertionError(f"25b: rank {r}'s result differs from rank 0's")
            rel_agree(got["loss"], world1["loss"], 1e-3, f"25b rank {r} loss")
            rel_agree(got["grad_norm"], world1["grad_norm"], 1e-3, f"25b rank {r} grad norm")
            for i, l in enumerate(got["launches"]):
                if l != expect:
                    raise AssertionError(f"25b rank {r} step {i + 1}: launches {l}, plan "
                                         f"{expect}")
        b_image = bf16_agreement(ranks[0]["image"][0], world1["image"], "25b image request")
        b_video = bf16_agreement(ranks[0]["video"][0], world1["video"], "25b video request")
        kept = torch.load(os.path.join(work, "rank0_params.pt"), weights_only=False)
        b_worst = params_agree(kept, world1["kept"], world1["lr"], "25b parameters")
        log(f"  25b two ranks over gloo on one card (collectives staged through host "
            f"memory): image request one frame a rank {[round(x['image'][1], 3) for x in ranks]} "
            f"s, {b_image}; video request two windows a rank "
            f"{[round(x['video'][1], 3) for x in ranks]} s, {b_video}")
        log(f"  25b training, B = 1 a rank (2 steps) vs world 1 at B = 2: losses "
            f"{[round(x, 6) for x in ranks[0]['loss']]} vs "
            f"{[round(x, 6) for x in world1['loss']]}, grad norms "
            f"{[round(x, 6) for x in ranks[0]['grad_norm']]} vs "
            f"{[round(x, 6) for x in world1['grad_norm']]}; parameters after step 2 within "
            f"{b_worst:.3e}; s/step {[[round(s, 3) for s in x['seconds']] for x in ranks]}; "
            f"optimizer bytes a rank {[x['opt_bytes'] for x in ranks]} vs world 1 "
            f"{world1['opt_bytes']}; peak memory a rank "
            f"{[round(x['peak_bytes'] / 2**30, 2) for x in ranks]} GiB; phase 25b "
            f"{b_secs:.1f} s")
        res["b"] = dict(
            image=dict(seconds=[x["image"][1] for x in ranks], agreement=b_image),
            video=dict(seconds=[x["video"][1] for x in ranks], agreement=b_video),
            train=dict(loss=ranks[0]["loss"], grad_norm=ranks[0]["grad_norm"],
                       seconds=[x["seconds"] for x in ranks],
                       opt_bytes=[x["opt_bytes"] for x in ranks],
                       world1_opt_bytes=world1["opt_bytes"], params_max_dev=b_worst),
            peak_bytes=[x["peak_bytes"] for x in ranks], phase_s=b_secs)
        for name in ("train", "image", "video"):
            launches[f"b_{name}"] = dict(sum_counts([x["launch_totals"][name] for x in ranks]))
        res["launches"] = launches
    finally:
        torch.backends.cudnn.deterministic = deterministic
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 25 in {res['phase_s']:.1f} s [{card}]")
    return res


def sum_counts(dicts):
    from collections import Counter

    total = Counter()
    for d in dicts:
        total.update(d)
    return total


def p25_rank(rank: int, init: str, work: str) -> int:
    """One of phase 25b's two ranks: the image and video requests on its
    share, two training steps on its row, results to `work`."""
    import torch

    from magicdance_tpu_torch.parallel.mesh import make_mesh, MeshAxis
    from magicdance_tpu_torch.parallel.multihost import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    initialize_distributed(backend="gloo", init_method=init, world_size=2, rank=rank,
                           timeout_s=600)
    mesh = make_mesh(("data",))
    log(f"  rank {rank}: group in {time.perf_counter() - t0:.1f} s")
    serve = p25_serving(mesh, p25_windows(2, rank))
    log(f"  rank {rank}: served at {time.perf_counter() - t0:.1f} s (pipelines built in "
        f"{serve['image_build_s']:.1f} / {serve['video_build_s']:.1f} s, requests "
        f"{serve['image'][1]:.1f} / {serve['video'][1]:.1f} s)")
    axis = MeshAxis(mesh)
    train = p25_train(2, 1, rows=axis.rows(2), keep_step=2)
    log(f"  rank {rank}: trained at {time.perf_counter() - t0:.1f} s (trainer built in "
        f"{train['build_s']:.1f} s, steps {[round(x, 1) for x in train['seconds']]} s)")
    out = dict(image=serve["image"], video=serve["video"], loss=train["loss"],
               grad_norm=train["grad_norm"], seconds=train["seconds"],
               launches=train["launches"], opt_bytes=train["opt_bytes"],
               peak_bytes=max(train["peak_bytes"], serve["image_peak_bytes"],
                              serve["video_peak_bytes"]),
               launch_totals=dict(train=dict(sum_counts(train["launches"])),
                                  image=serve["image"][2], video=serve["video"][2]))
    if rank == 0:
        torch.save(train["kept"], os.path.join(work, "rank0_params.pt"))
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    log(f"  rank {rank}: saved at {time.perf_counter() - t0:.1f} s")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


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
    fp32; at G = 1, D = 40 (BG 192, S 4096: the probe's heads one by one);
    at the ends of the packed width, G*D = 8 and 256 (bf16, on the body that
    `packed_body` routes them to). Kernel A against its plain version on the
    probe's unpacked q, k, v (BSNH, the shape P3 gives it). Timed in bf16 at
    the probe's shape: the kernel (on its Hopper body), the same launch on
    the earlier body (attention_tc, mma.sync), the bound, the plain version,
    SDPA on the unpacked per-head tensors (the same result for block-diagonal
    K/V from a third of the operations) and SDPA at equal work (q repeated
    over the G segments, (BG, G, Sq, G*D) against kbd / vbd viewed as (BG,
    G, S, G*D): K9's operations); K9 at G = 1 beside kernel A on the same
    heads. The library calls are yardsticks only."""
    import torch
    import torch.nn.functional as F

    from magicdance_tpu_torch.ops import kernels as K
    from magicdance_tpu_torch.ops.kernels import packed as P
    from magicdance_tpu_torch.scripts.bench_head_packing import P3_SHAPE
    from magicdance_tpu_torch.utils.timing import device_time_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5678)
    errs, checked, rows, extra = {}, {}, [], {}

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    b, h, s, d, g = (P3_SHAPE[key] for key in ("B", "H", "S", "D", "G"))
    bg, gd = b * h // g, g * d
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
        q, k, v = (rnd(b, s, h, d, dtype=dtype) for _ in range(3))
        qp, kbd, vbd = P.pack_heads(q, g), P.blockdiag(k, g), P.blockdiag(v, g)
        label = (f"{str(dtype)[6:]} BG={bg} S={s} G={g} D={d} block-diagonal "
                 f"({P.packed_body(dtype, gd)})")
        check(errs, checked, "packed_attention", P.packed_attention(qp, kbd, vbd, g),
              P.packed_attention_ref(qp, kbd, vbd, g), tol, label)
        if dtype == torch.bfloat16:
            ms = device_time_ms(lambda: P.packed_attention(qp, kbd, vbd, g))
            mma_ms = device_time_ms(lambda: P.packed_attention(qp, kbd, vbd, g, body="mma_sync"))
            plain_ms = device_time_ms(lambda: P.packed_attention_ref(qp, kbd, vbd, g),
                                      min_total_s=0.1, max_iters=3)
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            lib_ms = device_time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
            qe = qp.unsqueeze(1).expand(bg, g, s, gd).contiguous()
            ke, ve = kbd.view(bg, g, s, gd), vbd.view(bg, g, s, gd)
            lib_eq_ms = device_time_ms(
                lambda: F.scaled_dot_product_attention(qe, ke, ve, scale=d ** -0.5))
            del qe
            bound, bound_by = packed_bound_ms(bg, s, s, g, gd)
            rows.append(dict(kernel="packed_attention", BG=bg, Sq=s, S=s, G=g, D=d,
                             body=P.packed_body(dtype, gd), launches_per_step=1, kernel_ms=ms,
                             mma_sync_ms=mma_ms, plain_ms=plain_ms, library_ms=lib_ms,
                             library_equal_work_ms=lib_eq_ms, bound_ms=bound,
                             bound_by=bound_by,
                             exp_bound_ms=exp_bound_ms(bg, s, g, [(bg, s)])))
            log(f"      kernel_ms={ms:.4f} (attention_tc, mma.sync: {mma_ms:.4f}) "
                f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} (per head) "
                f"library_equal_work_ms={lib_eq_ms:.4f} bound_ms={bound:.4f} ({bound_by}) "
                f"exp_bound_ms={rows[-1]['exp_bound_ms']:.4f}")
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
              f"{str(dtype)[6:]} ragged BG=3 Sq=200 S=300 G={g} D={d} random K/V "
              f"({P.packed_body(dtype, gd)})")

    # G = 1: the probe's heads one by one (BG = B * H), K9 beside kernel A
    q, k, v = (rnd(b, s, h, d, dtype=torch.bfloat16) for _ in range(3))
    q1, k1, v1 = (P.pack_heads(t, 1) for t in (q, k, v))
    want = by_rows(lambda *ts: P.packed_attention_ref(*ts, 1), [q1, k1, v1], n=32)
    check(errs, checked, "packed_attention", P.packed_attention(q1, k1, v1, 1), want,
          BF16_TOL, f"bfloat16 BG={b * h} S={s} G=1 D={d} per head "
                    f"({P.packed_body(torch.bfloat16, d)})")
    g1_ms = device_time_ms(lambda: P.packed_attention(q1, k1, v1, 1))
    a_ms = device_time_ms(lambda: K.self_attention(q, k, v))
    g1_bound, g1_by = packed_bound_ms(b * h, s, s, 1, d)
    extra["g1"] = dict(BG=b * h, S=s, G=1, D=d, body=P.packed_body(torch.bfloat16, d),
                       kernel_ms=g1_ms, kernel_a_ms=a_ms, bound_ms=g1_bound, bound_by=g1_by,
                       over_kernel_a=g1_ms / a_ms)
    log(f"      G=1: kernel_ms={g1_ms:.4f} kernel A (same heads) {a_ms:.4f} "
        f"({g1_ms / a_ms:.2f}x) bound_ms={g1_bound:.4f} ({g1_by})")
    del q, k, v, q1, k1, v1, want
    torch.cuda.empty_cache()

    # the ends of the packed width, on the body each is routed to
    for bg_, sq_, s_, g_, d_ in ((4, 1000, 1000, 1, 8), (4, 1000, 1000, 2, 128)):
        qp = rnd(bg_, sq_, g_ * d_, dtype=torch.bfloat16)
        kbd, vbd = (rnd(bg_, g_ * s_, g_ * d_, dtype=torch.bfloat16) for _ in range(2))
        check(errs, checked, "packed_attention", P.packed_attention(qp, kbd, vbd, g_),
              P.packed_attention_ref(qp, kbd, vbd, g_), BF16_TOL,
              f"bfloat16 BG={bg_} Sq={sq_} S={s_} G={g_} D={d_} G*D={g_ * d_} random K/V "
              f"({P.packed_body(torch.bfloat16, g_ * d_)})")
    return rows, errs, checked, extra


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
    for key, what in (("max_abs_err", f"K9 (G={p3['shape']['G']})"),
                      ("g1_max_abs_err", "K9 (G=1)")):
        if not p3[key] <= tol:
            raise AssertionError(f"P3: {what} and kernel A differ by {p3[key]:.3e} > {tol:.3e}")
    for mode in ("packed_attention", "self_attention"):
        if launches[mode] < 1:
            raise AssertionError(f"the probe launched no {mode} kernel: {launches}")
    log(f"  launches in the probe's run: "
        f"{ {k: v for k, v in launches.items() if v} }")
    return result, launches


# --------------------------------------------------------------------------
# phase 26: the training leftovers (int8 frozen storage, attention_impl
# "flash" / "xla", the native C++ batch loader, the Flax-style init, dropout)
# --------------------------------------------------------------------------

# "flash" / "xla" vs "auto", relative, each step. Sound runs on an H100
# differ by <= 6.6e-7 (loss) and 1.1e-4 (grad norm); temporal dK/dV 1% too
# large moves the grad norm by 2.9e-3 (`p26_control`)
P26_LOSS_GAP = 1e-5
P26_GRAD_GAP = 1e-3


def p26_config(**over):
    """Phase 25's stage-2 config (phase 9's preset, B = 2, warm-up 1,
    adam_eps 1e-4) with `over` in its optimizer or its own fields."""
    cfg = p25_train_config(2)
    optim = {k: v for k, v in over.items() if hasattr(cfg.optim, k)}
    rest = {k: v for k, v in over.items() if k not in optim}
    return dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, **optim), **rest)


def p26_steps(tr, batches, draws, plan=None, label=""):
    """Steps of `tr` on the given batches and draws: losses, grad norms,
    seconds, launches per step (each held to `plan`, {mode: launches}, when
    given) and the peak memory."""
    import torch

    from magicdance_tpu_torch.ops import kernels as K

    out = dict(loss=[], grad_norm=[], seconds=[], launches=[])
    torch.cuda.reset_peak_memory_stats()
    for b, d in zip(batches, draws):
        K.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = tr.train_step(b, d)
        torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t)
        got = {k: n for k, n in K.LAUNCHES.items() if n}
        out["launches"].append(got)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        if plan is not None and got != {k: n for k, n in plan.items() if n}:
            raise AssertionError(f"{label} step {len(out['loss'])}: launches {got}, plan {plan}")
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    if not all(map(math.isfinite, out["loss"] + out["grad_norm"])):
        raise AssertionError(f"{label}: non-finite loss or grad norm {out}")
    return out


def p26_summary(r) -> str:
    secs = r["seconds"]
    return (f"losses {[round(x, 6) for x in r['loss']]}, grad norms "
            f"{[round(x, 6) for x in r['grad_norm']]}, s/step {[round(x, 3) for x in secs]} "
            f"(steady {sum(secs[1:]) / max(1, len(secs) - 1):.3f}), peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB")


def p26_agreement(got, want, lr, label) -> str:
    """Losses, grad norms and final parameters: 'bit for bit', or within
    1e-3 relative and 2% of the learning rate (phase 25's rules); raises
    beyond them."""
    import torch

    same = (got["loss"] == want["loss"] and got["grad_norm"] == want["grad_norm"]
            and all(torch.equal(got["params"][k].cpu(), w.cpu())
                    for k, w in want["params"].items()))
    if same:
        return "bit for bit"
    rel_agree(got["loss"], want["loss"], 1e-3, f"{label} loss")
    rel_agree(got["grad_norm"], want["grad_norm"], 1e-3, f"{label} grad norm")
    worst = params_agree(got["params"], {k: w.to(got["params"][k].device)
                                         for k, w in want["params"].items()}, lr, label)
    return f"within phase 25's rules (parameters {worst:.3e} apart)"


def p26_int8_and_impls(card: str) -> dict:
    """26a: int8 frozen storage vs a bf16-frozen trainer holding the
    dequantized values; 26b (steps): the same start under "flash" and
    "xla", and one stage-3 step under "flash"."""
    import torch

    from magicdance_tpu_torch.models import quant
    from magicdance_tpu_torch.train.trainer import Trainer

    res = {}
    q_cfg = p26_config(frozen_dtype="int8")
    lr = q_cfg.optim.learning_rate
    batches = p25_batches()
    _, totals, _ = training_launch_plan(q_cfg.model, q_cfg.image_size // 8)
    t0 = time.perf_counter()
    q8 = Trainer(q_cfg, device="cuda")
    q8.init_random(seed=0)
    # the frozen leaves int8 leaves in fp32 get bf16 values, so that the
    # bf16 trainer below stores the very numbers the int8 one computes with
    with torch.no_grad():
        for m in (q8.model, q8.vae, q8.clip):
            for p in m.parameters():
                if p.dtype == torch.float32 and not p.requires_grad:
                    p.copy_(p.bfloat16().float())
    init = {n: {k: t.cpu() for k, t in quant.dequantize_state_dict(
        getattr(q8, n).state_dict()).items()} for n in ("model", "vae", "clip")}
    draws = [q8.draw(b) for b in batches]
    frozen_q = quant.storage_bytes((q8.model, q8.vae, q8.clip), q8.train_params)
    n_int8 = sum(p.numel() for m in (q8.model, q8.vae, q8.clip) for p in m.parameters()
                 if p.dtype == torch.int8)
    log(f"  26a int8: trainer built in {time.perf_counter() - t0:.1f} s; {n_int8 / 1e9:.4f} B "
        f"frozen parameters held in int8")
    r8 = p26_steps(q8, batches, draws, totals, "int8")
    r8["params"] = {k: p.detach().cpu() for k, p in q8.train_params.items()}
    del q8
    torch.cuda.empty_cache()

    def start(cfg):
        tr = Trainer(cfg, device="cuda")
        tr.load_state_dicts(init["model"], init["vae"], init["clip"])
        return tr

    bf = start(p26_config())
    frozen_b = quant.storage_bytes((bf.model, bf.vae, bf.clip), bf.train_params)
    rb = p26_steps(bf, batches, draws, totals, "bf16")
    rb["params"] = {k: p.detach().cpu() for k, p in bf.train_params.items()}
    del bf
    torch.cuda.empty_cache()
    agree = p26_agreement(r8, rb, lr, "int8 vs bf16 of the dequantized values")
    del r8["params"], rb["params"]
    log(f"  int8 + scales: frozen storage {frozen_q:,} bytes ({frozen_q / 1e9:.3f} GB) vs bf16 "
        f"{frozen_b:,} bytes ({frozen_b / 1e9:.3f} GB), ratio {frozen_q / frozen_b:.4f}")
    log(f"  int8 {p26_summary(r8)}")
    log(f"  bf16 {p26_summary(rb)}")
    log(f"  int8 vs bf16 holding the dequantized values: {agree}; launches per step "
        f"{r8['launches'][0]} (phase 9's plan, every step)")
    res["int8"] = dict(frozen_bytes_int8=frozen_q, frozen_bytes_bf16=frozen_b,
                       int8_params=n_int8, int8=r8, bf16=rb, agreement=agree)

    # 26b: the same start under "flash" and "xla"
    f_cfg = p26_config(attention_impl="flash")
    fplan = flash_launch_plan(f_cfg, f_cfg.image_size // 8, 2)
    ftot = plan_totals(fplan)
    fl = start(f_cfg)
    rf = p26_steps(fl, batches, draws, ftot, "flash")
    del fl
    torch.cuda.empty_cache()
    gaps = p26_gaps(rf, rb, "flash vs auto")
    log(f"  26b flash {p26_summary(rf)}; launches per step {rf['launches'][0]} "
        f"(flash_launch_plan, every step)")
    log(f"  flash vs auto (the bf16 run above): {p26_gap_line(gaps)}")
    ctx = f_cfg.model.clip.max_length
    with p26_fault("attention_dq", 0.0, lambda q, k: k.shape[1] == ctx):
        ctl = p26_control(p26_steps(start(f_cfg), batches[:2], draws[:2], None, "control"), rb,
                          "stage 2, cross-attention dQ zero", must_catch=False)
    torch.cuda.empty_cache()
    xl = start(p26_config(attention_impl="xla"))
    rx = p26_steps(xl, batches[:1], draws[:1], {}, "xla")
    del xl
    torch.cuda.empty_cache()
    xgaps = p26_gaps(rx, rb, "xla vs auto")
    log(f"  26b xla one step: {p26_summary(rx)}; attention-kernel launches "
        f"{rx['launches'][0] or 0} (none); to auto: {p26_gap_line(xgaps)}")
    res["flash"] = dict(r=rf, gaps=gaps, control=ctl, plan={" ".join(map(str, k)): n
                                                            for k, n in fplan.items()},
                        totals=ftot)
    res["xla"] = dict(r=rx, gaps=xgaps)

    # two stage-3 steps under "auto", then the same two from the same state
    # under "flash": the temporal sites through A/C/D
    cfg3, tr3, make_batch = stage3_trainer()
    b3 = [make_batch() for _ in range(2)]
    d3 = [tr3.draw(b) for b in b3]
    snap = p26_snapshot(tr3)
    clips = cfg3.batch_size_per_device
    ra3 = p26_steps(tr3, b3, d3, stage3_launch_plan(cfg3, cfg3.image_size, clips), "stage-3 auto")
    p26_restore(tr3, snap)
    tr3.cfg = dataclasses.replace(cfg3, attention_impl="flash")
    s3plan = flash_launch_plan(tr3.cfg, cfg3.image_size // 8, clips)
    r3 = p26_steps(tr3, b3, d3, plan_totals(s3plan), "stage-3 flash")
    gaps3 = p26_gaps(r3, ra3, "stage-3 flash vs auto")
    log(f"  26b stage-3 steps (one 16-frame clip each), auto {p26_summary(ra3)}")
    log(f"  stage-3 flash {p26_summary(r3)}; launches per step {r3['launches'][0]} "
        f"(no grouped kernel); to auto from the same state: {p26_gap_line(gaps3)}")
    p26_restore(tr3, snap)
    frames = cfg3.video_frames
    with p26_fault("attention_dkv", 1.01, lambda q, k: q.shape[1] == k.shape[1] == frames):
        ctl3 = p26_control(p26_steps(tr3, b3, d3, None, "control"), ra3,
                           "stage 3, temporal dK/dV 1% too large", must_catch=True)
    del tr3, b3, snap
    torch.cuda.empty_cache()
    res["stage3_flash"] = dict(r=r3, auto=ra3, gaps=gaps3, control=ctl3,
                               plan={" ".join(map(str, k)): n for k, n in s3plan.items()})
    res["launches"] = {
        "int8": sum_counts(r8["launches"]), "bf16": sum_counts(rb["launches"]),
        "flash": sum_counts(rf["launches"]), "xla": sum_counts(rx["launches"]),
        "stage3_flash": sum_counts(r3["launches"])}
    return res


def p26_rel_gaps(got, want) -> dict:
    """Relative loss and grad-norm gaps of `got` to `want`, step by step."""
    return {key: [abs(a - b) / abs(b) for a, b in zip(got[key], want[key])]
            for key in ("loss", "grad_norm")}


def p26_within(gaps) -> bool:
    return max(gaps["loss"]) <= P26_LOSS_GAP and max(gaps["grad_norm"]) <= P26_GRAD_GAP


def p26_gaps(got, want, label) -> dict:
    """`p26_rel_gaps`; raises beyond P26_LOSS_GAP / P26_GRAD_GAP."""
    gaps = p26_rel_gaps(got, want)
    if not p26_within(gaps):
        raise AssertionError(f"{label}: relative gaps {gaps} beyond {P26_LOSS_GAP:g} (loss) / "
                             f"{P26_GRAD_GAP:g} (grad norm)")
    return gaps


def p26_gap_line(gaps) -> str:
    return (f"relative gaps loss {[f'{g:.2e}' for g in gaps['loss']]} (bound "
            f"{P26_LOSS_GAP:g}), grad norm {[f'{g:.2e}' for g in gaps['grad_norm']]} "
            f"(bound {P26_GRAD_GAP:g})")


@contextlib.contextmanager
def p26_fault(name: str, factor: float, where):
    """Within the block, flash_vjp.<name> (attention_dq or attention_dkv)
    returns its real output times `factor` wherever `where(q, k)` holds: a
    deliberately wrong kernel for `p26_control`, the real one again after."""
    from magicdance_tpu_torch.ops.kernels import flash_vjp as V

    real = getattr(V, name)

    def wrong(*args, **kw):
        out = real(*args, **kw)
        q, k = (args[0], args[1]) if name == "attention_dq" else (args[2], args[0])
        if not where(q, k):
            return out
        return tuple(t * factor for t in out) if isinstance(out, tuple) else out * factor

    setattr(V, name, wrong)
    try:
        yield
    finally:
        setattr(V, name, real)


def p26_control(r, want, label: str, must_catch: bool) -> dict:
    """The gaps of steps `r`, run under a `p26_fault`, to the sound "auto"
    steps `want` from the same state: how far the P26 bounds see that fault.
    Raises when `must_catch` and the gaps stay within the bounds."""
    gaps = p26_rel_gaps(r, want)
    caught = not p26_within(gaps)
    log(f"  control, {label}: {p26_gap_line(gaps)}: "
        f"{'beyond the bounds' if caught else 'within the bounds'}")
    if must_catch and not caught:
        raise AssertionError(f"the bounds do not see {label}: {gaps}")
    return dict(label=label, loss=r["loss"], grad_norm=r["grad_norm"], gaps=gaps,
                caught=caught)


def p26_snapshot(tr) -> dict:
    """Copies of what a train step changes: the trainable weights, the
    optimizer's moments, the EMA and the step."""
    def clone(x):
        if isinstance(x, dict):
            return {k: clone(t) for k, t in x.items()}
        return x.detach().clone() if hasattr(x, "detach") else x

    return dict(params=clone(dict(tr.train_params)), opt=clone(tr.opt.state_dict()),
                ema=clone(tr.full_ema()), step=tr.step)


def p26_restore(tr, snap) -> None:
    import torch

    with torch.no_grad():
        for k, p in tr.train_params.items():
            p.copy_(snap["params"][k])
    tr.opt.load_state_dict(snap["opt"])
    if tr.ema_params is not None:
        tr.set_ema(snap["ema"])
    tr.step = snap["step"]


P26_KIND = {"self_attention": "fwd", "two_source_attention": "fwd",
            "self_attention_lse": "lse", "two_source_attention_lse": "lse",
            "attention_dq": "dq", "attention_dq_two_source": "dq", "attention_dkv": "dkv"}


def p26_checked_before(frames: int, stage2_plan, stage3_sites, frames3: int = 16) -> set:
    """The kernel shapes phases 3 and 7 hold against their plain versions,
    as (mode, B, S_q, S_kv, D, bank batch) (S_kv: a bank read's self and bank
    keys together; bank batch None for one source): phase 3's A at B = 1 and
    `frames` and its bank reads (a batch-1 and a per-image bank, 16 frames
    over a batch-1 bank); phase 7's LSE forward, C and D at every (S, D) of
    the stage-2 plan at B = `frames` (a per-image bank) and at the stage-3
    bank reads over a batch-1 bank."""
    out = set()
    for name, b, s, d, bb, _ in main_path_shapes(frames):
        out.add((name, b, s, 2 * s if bb else s, d, bb))
    for s, d in ((4096, 40), (1024, 80), (256, 160)):
        out.add(("two_source_attention", frames, s, 2 * s, d, frames))
        out.add(("two_source_attention", frames3, s, 2 * s, d, 1))
    for _, s, d in stage2_plan:
        out |= {("self_attention_lse", frames, s, s, d, None),
                ("attention_dq", frames, s, s, d, None),
                ("attention_dkv", frames, s, s, d, None),
                ("two_source_attention_lse", frames, s, 2 * s, d, frames),
                ("attention_dq_two_source", frames, s, 2 * s, d, frames)}
    for s, d in stage3_sites:
        out |= {("two_source_attention_lse", frames3, s, 2 * s, d, 1),
                ("attention_dq_two_source", frames3, s, 2 * s, d, 1),
                ("attention_dkv", frames3, s, s, d, None)}
    return out


def p26_cases(plans, checked: set) -> dict:
    """The sites of the "flash" plans at shapes not in `checked`, {(path, B,
    S_q, K/V lengths, D, bank batch): {kind: (mode, launches per step)}};
    plans: (path, plan, bank batch of a B-row bank read). A dK/dV launch goes
    to the one-source site of its shape (the kernel sees one source)."""
    cases = {}
    for path, plan, bank in plans:
        for (mode, b, sq, skv, d), n in plan.items():
            two = mode in ("two_source_attention", "two_source_attention_lse",
                           "attention_dq_two_source")
            bb = bank(b) if two else None
            if (mode, b, sq, skv, d, bb) in checked:
                continue
            kv = (sq, skv - sq) if two else (skv,)
            cases.setdefault((path, b, sq, kv, d, bb), {})[P26_KIND[mode]] = (mode, n)
    return cases


def by_rows(fn, ts, tail=(), n=None):
    """fn(*ts, *tail) over chunks of n rows of the batched tensors `ts`
    (`tail` whole, e.g. a batch-1 bank), the outputs concatenated; one call
    when n is None."""
    import torch

    if n is None:
        return fn(*ts, *tail)
    outs = [fn(*(t[i:i + n] for t in ts), *tail) for i in range(0, ts[0].shape[0], n)]
    return (tuple(map(torch.cat, zip(*outs))) if isinstance(outs[0], tuple)
            else torch.cat(outs))


def p26_flash_shapes(cases, heads: int = 8):
    """26b (kernels): every site of `cases` (`p26_cases`: the shapes the
    "flash" override adds to a stage-2 or stage-3 step) against the plain
    versions by phases 3 and 7's rules, bf16 (timed) and fp32 -- A or B
    without the LSE where the plan launches them, else the LSE forward, C
    and D (every source whose batch is the queries') -- each launched mode
    with its ms, plain ms, SDPA library ms and bound. A plain call whose
    fp32 logits pass 2 GiB runs by row chunks (rows are independent)."""
    import torch
    import torch.nn.functional as F

    from magicdance_tpu_torch.ops import kernels as K
    from magicdance_tpu_torch.ops.kernels import flash_vjp as V
    from magicdance_tpu_torch.utils.timing import device_time_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2626)
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
        log(f"  ok  {name:22s} {label:58s} max_abs_err={err:.3e} rms={rms:.3e} "
            f"(tol {tol:.3e})")

    def dq_ref(q, k, v, dout, lse, delta, kb=None, vb=None):
        return V.attention_dq_ref(q, k, v, dout, lse, delta, None, kb, vb)

    for (path, b, sq, kv, d, bb), kinds in sorted(
            cases.items(), key=lambda c: (c[0][0], -c[0][2], -c[0][1], c[0][3])):
        two = len(kv) == 2
        fname = "two_source_attention" if two else "self_attention"
        chunk = heads * sq * sum(kv) * 4
        chunk = max(1, (2 << 30) // chunk) if b * chunk > (2 << 30) else None
        grads = bool(kinds.keys() & {"lse", "dq", "dkv"})
        what = ("cross-attention" if kv == (77,) else "temporal" if sq <= 32 else
                f"bank read (bank batch {bb})" if two else "self-attention")
        label = f"{path} {what} B={b} S={sq} S_k={'+'.join(map(str, kv))} D={d}"
        for dtype in (torch.bfloat16, torch.float32):
            tag = f"{str(dtype)[6:]} {label}"
            q, dout = (rnd(b, sq, heads, d, dtype=dtype) for _ in range(2))
            k, v = (rnd(b, kv[0], heads, d, dtype=dtype) for _ in range(2))
            kb = vb = None
            if two:
                kb, vb = (rnd(bb, kv[1], heads, d, dtype=dtype) for _ in range(2))
            # a per-image bank is cut into rows with the queries, a batch-1 bank goes whole
            src, tail = (((q, k, v, kb, vb), ()) if two and bb == b
                         else ((q, k, v), (kb, vb) if two else ()))
            kern = {}
            if "fwd" in kinds:
                fwd = K.two_source_attention if two else K.self_attention
                fwd_ref = K.two_source_attention_ref if two else K.self_attention_ref
                kern["fwd"] = (lambda **kw: fwd(*src, *tail, **kw),
                               lambda: by_rows(fwd_ref, src, tail, chunk))
                check(fname, kern["fwd"][0](), kern["fwd"][1](), f"{tag} o (no LSE)",
                      grad=False)
            if grads:
                lfwd = V.two_source_attention_lse if two else V.self_attention_lse
                lref = V.two_source_attention_lse_ref if two else V.self_attention_lse_ref
                got_o, got_lse = lfwd(*src, *tail)
                out, lse = by_rows(lref, src, tail, chunk)
                check(fname, got_o, out, f"{tag} o", grad=False)
                check(fname, got_lse, lse, f"{tag} lse", grad=False)
                delta = V.attention_delta(dout, out)
                del got_o, got_lse, out
                qside = (q, k, v, dout, lse, delta) + ((kb, vb) if two and bb == b else ())
                kern["lse"] = (lambda **kw: lfwd(*src, *tail, **kw),
                               lambda: by_rows(lref, src, tail, chunk))
                kern["dq"] = (lambda **kw: V.attention_dq(q, k, v, dout, lse, delta, None, kb, vb,
                                                          **kw),
                              lambda: by_rows(dq_ref, qside, tail, chunk))
                kern["dkv"] = (lambda **kw: V.attention_dkv(k, v, q, dout, lse, delta, **kw),
                               lambda: by_rows(V.attention_dkv_ref, (k, v, q, dout, lse, delta),
                                               (), chunk))
                bf16 = dtype == torch.bfloat16
                if bf16:  # C and D on both bodies, and the default one twice
                    hold_bwd_bodies(check, "attention_dq", kern["dq"][0], kern["dq"][1](), tag, d,
                                    "dq")
                else:
                    check("attention_dq", kern["dq"][0](), kern["dq"][1](), f"{tag} dQ",
                          grad=True)
                sources = [("self", k, v)] + ([("bank", kb, vb)] if two and bb == b else [])
                for name_, kk, vv in sources:
                    dkv_args = (kk, vv, q, dout, lse, delta)
                    want = by_rows(V.attention_dkv_ref, dkv_args, (), chunk)
                    if bf16:
                        hold_bwd_bodies(check, "attention_dkv",
                                        lambda a_=dkv_args, **kw: V.attention_dkv(*a_, **kw), want,
                                        f"{tag} ({name_} source)", d, "dkv")
                        continue
                    for g_, w_, nm in zip(V.attention_dkv(*dkv_args), want, ("dK", "dV")):
                        check("attention_dkv", g_, w_, f"{tag} {nm} ({name_} source)", grad=True)
            if dtype != torch.bfloat16:
                del q, k, v, dout, kb, vb, src, tail, kern
                if grads:
                    del lse, delta, qside
                torch.cuda.empty_cache()
                continue
            kh = torch.cat([k, kb.expand(b, -1, -1, -1)], 1) if two else k
            vh = torch.cat([v, vb.expand(b, -1, -1, -1)], 1) if two else v
            qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_(grads) for t in (q, kh, vh))
            g = dout.transpose(1, 2)
            lib = {"fwd": device_time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs))}
            lib["lse"] = lib["fwd"]
            if grads:
                lib_out = F.scaled_dot_product_attention(qs, ks, vs)
                lib["dq"] = device_time_ms(lambda: torch.autograd.grad(lib_out, [qs], g,
                                                                       retain_graph=True))
                lib["dkv"] = device_time_ms(lambda: torch.autograd.grad(lib_out, [ks, vs], g,
                                                                        retain_graph=True))
                del lib_out
            kvs = [(b, kv[0])] + ([(bb, kv[1])] if two else [])
            for kind, (mode, n) in sorted(kinds.items()):
                run, plain = kern[kind]
                bodies = {}
                if kind in ("fwd", "lse"):  # A or B: both bodies
                    chosen, t = body_times(run, d, sq, kv)
                else:  # C or D: each body that takes the width (D's on the self source)
                    chosen, t = body_times(run, d, sq, kv if kind == "dq" else kv[:1], kind)
                ms = t[chosen]
                bodies = dict(body=chosen, wgmma_ms=t.get("wgmma"), mma_sync_ms=t.get("mma_sync"))
                plain_ms = device_time_ms(plain, min_total_s=0.1, max_iters=5)
                if kind == "fwd":
                    bound, bound_by = attention_bound_ms(b, sq, heads, d, kvs)
                else:
                    bound, bound_by = training_bound_ms(kind, b, sq, heads, d,
                                                        kvs[:1] if kind == "dkv" else kvs)
                rows.append(dict(mode=mode, kind=kind, case=label, B=b, S=sq,
                                 S_kv=kv[0] if kind == "dkv" else sum(kv), D=d, H=heads,
                                 bank_batch=bb, path=path, launches_per_step=n, kernel_ms=ms,
                                 plain_ms=plain_ms, library_ms=lib[kind], bound_ms=bound,
                                 bound_by=bound_by, **bodies))
                log(f"      {mode:25s} kernel_ms={ms:.4f} " + bodies_text(bodies)
                    + f"plain_ms={plain_ms:.4f} "
                    f"library_ms={lib[kind]:.4f} bound_ms={bound:.4f} ({bound_by}) "
                    f"x{n}/{path} flash step")
            del q, k, v, dout, kb, vb, src, tail, kern, qs, ks, vs, kh, vh, g
            if grads:
                del lse, delta, qside
            torch.cuda.empty_cache()
    return rows, errs, checked


def p26_tree(root: str, videos: int = 2, frames: int = 4, size: int = 512, seed: int = 26):
    """A seeded TikTok-layout training tree at size^2: JPEG frames and PNG
    pose maps (each under its frame's file name, as the dataset looks them
    up; both decoders read the format from the file's bytes)."""
    import numpy as np
    from PIL import Image

    rs = np.random.RandomState(seed)
    for v in range(videos):
        for split in ("train_set", "pose_map_train_set"):
            os.makedirs(os.path.join(root, split, f"vid{v}"))
        for i in range(frames):
            name = f"{i:04d}.jpg"
            img = rs.randint(0, 256, (size, size, 3)).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(root, "train_set", f"vid{v}", name),
                                      format="JPEG", quality=90)
            pose = rs.randint(0, 256, (size, size, 3)).astype(np.uint8)
            Image.fromarray(pose).save(os.path.join(root, "pose_map_train_set", f"vid{v}", name),
                                       format="PNG")


def p26_cli(card: str) -> dict:
    """26c: `cli.train` at full SD1.5 width, frozen int8, no checkpoint (the
    Flax-style init), POSE_ONLY (the ControlNet trains: a smaller checkpoint
    to write), 2 steps at B = 2 with the sample grid at step 2, on a seeded
    512x512 tree decoded by the native loader; then the loader alone, native
    vs PIL."""
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch

    from magicdance_tpu_torch import config as C
    from magicdance_tpu_torch.cli import train as T
    from magicdance_tpu_torch.data import native
    from magicdance_tpu_torch.data.tiktok import TikTokPairDataset
    from magicdance_tpu_torch.ops import kernels as K
    from magicdance_tpu_torch.train.trainer import Trainer

    work = os.path.join(ROOT, "chiprun_out", "phase26")
    shutil.rmtree(work, ignore_errors=True)
    data, run = os.path.join(work, "data"), os.path.join(work, "run")
    res = {}
    try:
        p26_tree(data)
        have_tools = native.toolchain_present()
        st = native.status()
        if have_tools and st["path"] != "native":
            raise AssertionError(f"g++ and the jpeg/png headers are here, yet the native loader "
                                 f"did not build: {st['reason']}")
        log(f"  native loader: {native.describe()}; toolchain present: {have_tools}"
            + ("" if have_tools else " (so the PIL path runs, as the JAX package's would)"))
        res["native"] = dict(st, toolchain=have_tools)

        cfg = C.stage2_pose_control()
        cfg = dataclasses.replace(cfg, freeze=C.FreezeRegime.POSE_ONLY, logging_steps=1,
                                  logging_gen_steps=2, vis_steps=2, save_steps=1000,
                                  optim=dataclasses.replace(cfg.optim, frozen_dtype="int8",
                                                            warmup_steps=1))
        C.save_json(cfg, os.path.join(work, "cfg.json"))
        checked = {}
        orig = Trainer.init_flax

        def init_and_check(self, seed=0):
            orig(self, seed)
            zero = ones = 0
            for m in (self.model, self.vae, self.clip):
                for name, mod in m.named_modules():
                    if getattr(mod, "zero_init", False):
                        if bool(mod.weight.any()):
                            raise AssertionError(f"zero-init {name}.weight is not zero")
                        zero += 1
                    if isinstance(mod, (torch.nn.GroupNorm, torch.nn.LayerNorm)):
                        if not bool((mod.weight == 1).all()):
                            raise AssertionError(f"{name}.weight is not ones")
                        ones += 1
            checked.update(zero=zero, ones=ones, int8=sum(
                p.dtype == torch.int8 for m in (self.model, self.vae, self.clip)
                for p in m.parameters()))

        Trainer.init_flax = init_and_check
        out = io.StringIO()
        K.reset_launches()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                T.main(["--config", os.path.join(work, "cfg.json"), "--data", data,
                        "--output", run, "--steps", "2", "--batch", "2", "--image_size", "512"])
        finally:
            Trainer.init_flax = orig
        secs = time.perf_counter() - t0
        launches = {k: n for k, n in K.LAUNCHES.items() if n}
        text = out.getvalue()
        for line in text.splitlines():
            log(f"    | {line}")
        if not checked or checked["zero"] < 60 or not checked["int8"]:
            raise AssertionError(f"the CLI's init was not checked: {checked}")
        grid = os.path.join(run, "samples", "step_00000002.png")
        if "visualize failed" in text or not os.path.exists(grid):
            raise AssertionError("the int8 run's sample grid was not written")
        lines = [json.loads(x) for x in open(os.path.join(run, "tb", "metrics.jsonl"))]
        if [r["step"] for r in lines] != [1, 2] or not all(math.isfinite(r["loss"])
                                                           for r in lines):
            raise AssertionError(f"metrics {lines}")
        want_decode = "native" if have_tools else "pil"
        if f"image decode: {want_decode}" not in text:
            raise AssertionError(f"the CLI did not report the {want_decode} decode path")
        log(f"  cli.train, 2 steps at full width, frozen int8, Flax-style init: {secs:.1f} s "
            f"(build, init, 2 steps, the sample grid, a checkpoint); at step 0 "
            f"{checked['zero']} zero-init kernels exactly zero, {checked['ones']} norm scales "
            f"one, {checked['int8']} int8 tensors; losses "
            f"{[round(r['loss'], 5) for r in lines]}; launches {launches}")
        res["cli"] = dict(seconds=secs, init=checked, losses=[r["loss"] for r in lines],
                          launches=launches)

        # the loader alone: native vs PIL on the same tree, and the crops
        ds = TikTokPairDataset(root=data, image_size=512, seed=3)
        rates = {}
        for path, use in (("native", True), ("pil", False)):
            if use and not native.native_rrc_available():
                continue
            it = ds.batches(2, use_native=use)
            next(it)
            t = time.perf_counter()
            for _ in range(4):
                next(it)
            rates[path] = 4 * 2 * 3 / (time.perf_counter() - t)  # target, reference, pose
        log(f"  decoded images/s (512x512, B = 2, target + reference + pose): "
            + ", ".join(f"{k} {v:.1f}" for k, v in rates.items()))
        if native.native_rrc_available():
            paths = sorted(os.path.join(data, "train_set", "vid0", f)
                           for f in os.listdir(os.path.join(data, "train_set", "vid0")))
            seeds = [1, 22, 333, 4444]
            nv = native.batch_load_images_rrc(paths, 512, seeds)
            lib = native._LIB
            native._LIB = None
            try:
                fb = native.batch_load_images_rrc(paths, 512, seeds)
            finally:
                native._LIB = lib
            mean_abs = float(np.abs(nv - fb).mean())
            if not mean_abs < 0.05:
                raise AssertionError(f"native vs rrc_params crops: mean abs {mean_abs:.4f}")
            log(f"  native crops vs the port's rrc_params-driven PIL crops: mean abs "
                f"{mean_abs:.4f} (< 0.05, the JAX test's bound)")
            res["crop_mean_abs"] = mean_abs
        res["images_per_s"] = rates
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return res


def p26_narrow_checks() -> dict:
    """26d: narrow fp32 card vs CPU (phase 8's config at 128x128): one
    stage-2 step frozen in int8, one under "flash", one under "xla"
    (loss and gradients within 2e-4), each held to its launch plan; and a
    narrow image request with dropout 0.1 (phase 4's check), equal to
    dropout 0 on the card."""
    import torch

    from magicdance_tpu_torch.config import SampleConfig
    from magicdance_tpu_torch.ops import kernels as K
    from magicdance_tpu_torch.pipeline import MagicPosePipeline
    from magicdance_tpu_torch.train.trainer import Trainer

    out = {}
    base = narrow_train_config()
    g = torch.Generator().manual_seed(8)
    batch = {"image": torch.rand(2, 128, 128, 3, generator=g) * 2 - 1,
             "reference": torch.rand(2, 128, 128, 3, generator=g) * 2 - 1,
             "pose": torch.rand(2, 128, 128, 3, generator=g),
             "input_ids": torch.zeros(2, 77, dtype=torch.long)}
    _, auto_totals, _ = training_launch_plan(base.model, 16)
    for label, cfg, totals in (
            ("int8", dataclasses.replace(base, optim=dataclasses.replace(
                base.optim, frozen_dtype="int8")), auto_totals),
            ("flash", dataclasses.replace(base, attention_impl="flash"),
             plan_totals(flash_launch_plan(dataclasses.replace(
                 base, attention_impl="flash"), 16, 2))),
            ("xla", dataclasses.replace(base, attention_impl="xla"), {})):
        cpu = Trainer(cfg, device="cpu")
        cpu.init_random(seed=3, scale=0.1)
        gpu = Trainer(cfg, device="cuda")
        for name in ("model", "vae", "clip"):
            getattr(gpu, name).load_state_dict(getattr(cpu, name).state_dict())
        draws = cpu.draw(batch)
        loss_c, _, grads_c = cpu.loss_and_grads(batch, draws)
        K.reset_launches()
        loss_g, _, grads_g = gpu.loss_and_grads(gpu.to_device(batch), draws)
        torch.cuda.synchronize()
        launches = {k: n for k, n in K.LAUNCHES.items() if n}
        # the narrow VAE's 64-wide mid attention at S = 256 runs kernel A
        # without gradients, once per encode: the encoders stay on "auto"
        expect = {**{k: n for k, n in totals.items() if n}, "self_attention": 2 +
                  totals.get("self_attention", 0)}
        if launches != expect:
            raise AssertionError(f"narrow {label} step launches {launches}, plan {expect}")
        loss_err = abs(float(loss_g) - float(loss_c))
        gmax = max(t.abs().max().item() for t in grads_c.values())
        gerr = max((grads_g[k].cpu() - grads_c[k]).abs().max().item() for k in grads_c)
        if not (loss_err <= 2e-4 * max(1.0, abs(float(loss_c))) and gerr <= 2e-4 * gmax):
            raise AssertionError(f"narrow {label} card vs CPU: loss err {loss_err:.3e}, max grad "
                                 f"err {gerr:.3e} (max |grad| {gmax:.3e})")
        log(f"  ok  narrow stage-2 step, {label}, card vs CPU (fp32): loss "
            f"{float(loss_c):.6f} err {loss_err:.3e}; max grad err {gerr:.3e} (max |grad| "
            f"{gmax:.3e}); launches {launches}")
        out[label] = dict(loss_err=loss_err, grad_err=gerr, grad_max=gmax, launches=launches)
        del cpu, gpu
    mc = narrow_model_config()
    mc_d = dataclasses.replace(mc, unet=dataclasses.replace(mc.unet, dropout=0.1))
    g = torch.Generator().manual_seed(7)
    pose = torch.rand(2, 128, 128, 3, generator=g)
    ref = torch.rand(1, 128, 128, 3, generator=g) * 2 - 1
    x_T = torch.randn(1, 16, 16, 4, generator=g).expand(2, -1, -1, -1)
    scfg = SampleConfig(steps=4)
    cpu = MagicPosePipeline(mc_d, device="cpu")
    cpu.init_params(seed=3, scale=0.1)
    outs = {}
    for label, cfg in (("dropout 0.1", mc_d), ("dropout 0", mc)):
        gpu = MagicPosePipeline(cfg, device="cuda")
        for name in ("model", "vae", "clip"):
            getattr(gpu, name).load_state_dict(getattr(cpu, name).state_dict())
        outs[label] = gpu.sample_frames(pose, ref, scfg, x_T=x_T).cpu()
        del gpu
    want = cpu.sample_frames(pose, ref, scfg, x_T=x_T)
    err = (outs["dropout 0.1"] - want).abs().max().item()
    tol = 1e-4 * max(1.0, want.abs().max().item())
    same = torch.equal(outs["dropout 0.1"], outs["dropout 0"])
    if not (err <= tol and same):
        raise AssertionError(f"dropout serving: card vs CPU {err:.3e} (tol {tol:.1e}), equal to "
                             f"dropout 0 on the card: {same}")
    log(f"  ok  narrow 4-step CFG-7 sample with dropout 0.1, card vs CPU: max_abs_err "
        f"{err:.3e} (tol {tol:.1e}); on the card bit for bit equal to dropout 0")
    out["dropout"] = dict(err=err, equal_to_dropout_0=same)
    return out


def p26_new_cases(frames: int) -> dict:
    """`p26_cases` of the stage-2 (B = 2, a per-image bank) and stage-3 (one
    16-frame clip, a batch-1 bank) "flash" plans, less what phases 3 and 7
    (run with `frames`) held."""
    from magicdance_tpu_torch.config import stage3_motion

    f_cfg = p26_config(attention_impl="flash")
    s3 = dataclasses.replace(stage3_motion(), attention_impl="flash")
    latent = f_cfg.image_size // 8
    checked = p26_checked_before(
        frames, training_launch_plan(f_cfg.model, latent)[0],
        stage3_grad_sites(s3.model, s3.image_size // 8), s3.video_frames)
    return p26_cases(
        [("stage 2", flash_launch_plan(f_cfg, latent, 2), lambda b: b),
         ("stage 3", flash_launch_plan(s3, s3.image_size // 8, s3.batch_size_per_device),
          lambda b: s3.batch_size_per_device)], checked)


def training_leftovers_on_card(card: str, frames: int) -> dict:
    """Phase 26 (see the module docstring); cuDNN deterministic for the
    phase, as in phase 25, so that equal inputs give equal bits."""
    import torch

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _training_leftovers(card, frames)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _training_leftovers(card: str, frames: int) -> dict:
    import torch

    log("  26d: narrow fp32, card vs CPU")
    narrow = p26_narrow_checks()
    torch.cuda.empty_cache()
    log("  26a / 26b: full-width stage-2 steps (int8, bf16, flash, a control, xla), stage-3 "
        "steps under auto and flash")
    steps = p26_int8_and_impls(card)
    log("  26b: kernels at the shapes the flash override adds (every site of both flash "
        "plans that phases 3 and 7 did not hold)")
    rows, errs, checked = p26_flash_shapes(p26_new_cases(frames))
    torch.cuda.empty_cache()
    log("  26c: the training CLI end to end (int8, Flax-style init, native loader)")
    cli = p26_cli(card)
    return dict(narrow=narrow, steps=steps, shapes=rows, errs=errs, checked=checked, cli=cli,
                launches={**steps["launches"], "cli": cli["cli"]["launches"]})


# --------------------------------------------------------------------------
# phase 27: magicpose-sdxl, the shapes and the step of sdxl-pose.serve-f4
# --------------------------------------------------------------------------

SDXL_CONFIG = os.path.join(ROOT, "port_bench", "configs", "magicpose-sdxl.json")


def sdxl_on_card() -> dict:
    """Phase 27: kernels A and B at SDXL_SHAPES (phase 3's hold, bf16 timed
    and fp32); `magicpose-sdxl` at its published widths with seeded random
    weights serving one request of SDXL_FRAMES pose maps at 1024x1024 for
    one DDIM step (CFG 7), the counts set to 0 just before it and held to
    `serving_launch_plan` (the VAE and the towers launch none); the
    GroupNorm sites the denoisers ran in that step held to
    `gn_plan_by_shape`, and K8 at each of them against its plain version
    (phase 14b's hold)."""
    import torch

    from magicdance_tpu_torch.config import ModelConfig, SampleConfig, from_dict
    from magicdance_tpu_torch.ops import kernels as K
    from magicdance_tpu_torch.pipeline import MagicPosePipeline

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2300)

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    errs, ratios, checked, check = attention_checker()
    rows = []
    hold_attention_shapes(SDXL_SHAPES, rnd, check, rows, path="sdxl serving")

    with open(SDXL_CONFIG) as f:
        cfg = from_dict(ModelConfig, json.load(f)["model"])
    latent, size = cfg.latent_size, 8 * cfg.latent_size
    t0 = time.perf_counter()
    pipe = MagicPosePipeline(cfg, device="cuda")
    pipe.init_params(seed=0)
    torch.cuda.synchronize()
    log(f"  magicpose-sdxl built, {sum(p.numel() for p in pipe.model.parameters()) / 1e9:.3f} B "
        f"denoiser parameters, seeded random weights, {time.perf_counter() - t0:.1f} s")
    pose = torch.rand(SDXL_FRAMES, size, size, 3, generator=gen, device=dev)
    ref = torch.rand(1, size, size, 3, generator=gen, device=dev) * 2 - 1
    scfg = SampleConfig(steps=1)
    plan = serving_launch_plan(cfg, latent, SDXL_FRAMES, 1)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with recording_groupnorm_sites(pipe.model, {}) as seen:
        K.reset_launches()
        t = time.perf_counter()
        out = pipe.sample_frames(pose, ref, scfg, generator=gen)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = {m: n for m, n in K.LAUNCHES.items() if n}
    if tuple(out.shape) != (SDXL_FRAMES, size, size, 3) or not torch.isfinite(out).all():
        raise AssertionError(f"sdxl: bad output {tuple(out.shape)}, finite="
                             f"{bool(torch.isfinite(out).all())}")
    if launches != plan:
        raise AssertionError(f"sdxl: launches of one DDIM step {launches}, plan {plan}")
    peak = torch.cuda.max_memory_allocated()
    log(f"  one request of {SDXL_FRAMES} frames at {size}x{size}, DDIM-1, CFG "
        f"{scfg.cfg_scale}: {secs:.3f} s (the first: kernels built and tuned), peak memory "
        f"{peak / 2**30:.2f} GiB; launches {launches} = the plan")
    del pipe, out
    torch.cuda.empty_cache()

    gn_per_step = gn_plan_by_shape(cfg, latent, SDXL_FRAMES)
    sites = sorted_gn_sites(seen)
    by_shape = {}
    for (b, hw, c, _, _, act), n in sites:
        by_shape[b, hw, c, act] = by_shape.get((b, hw, c, act), 0) + n
    if by_shape != gn_per_step:
        raise AssertionError(f"sdxl: GroupNorm calls of one DDIM step {by_shape}, plan "
                             f"{gn_per_step}")
    gn_rows, gn_errs, gn_checked = check_groupnorm_kernel(sites, gn_per_step, extra=())
    for r in gn_rows:
        r["path"] = "sdxl serving"
    errs.update(gn_errs)
    checked.update(gn_checked)
    return dict(shapes=rows + gn_rows, errs=errs, ratios=ratios, checked=checked,
                launches=launches, seconds=secs, peak_bytes=peak)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--report", default=None,
                    help="also write every measurement as JSON to this path")
    # phase 25b runs this script again as each of its two ranks
    ap.add_argument("--p25-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--p25-init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--p25-work", default=None, help=argparse.SUPPRESS)
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

    if args.p25_rank is not None:
        return p25_rank(args.p25_rank, args.p25_init, args.p25_work)

    frames, requests = 2, 2
    phase("== phase 1: card")
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

    phase("== phase 2: build")
    t0 = time.perf_counter()
    paths = build.build()
    log(f"  built {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(HOPPER_EXPECTED)) as pool:  # one cuobjdump a library at once
        sass = {n: pool.submit(sass_opcodes, paths[n], hopper_opcodes(n))
                for n in HOPPER_EXPECTED}
        sass = {n: f.result() for n, f in sass.items()}
    hopper = {}
    for name in paths:
        text = build.build_log(name) or ""
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill", text))
        log(f"  {name}: {len(regs)} instantiations, registers per thread "
            f"{min(regs, default=0)}-{max(regs, default=0)}, spill bytes {spills}")
        for inst, nreg, spill in tc_instantiations(text) + gn_instantiations(text):
            log(f"    {inst}: {nreg} registers, {spill} spill bytes")
        if name in HOPPER_EXPECTED:
            hopper[name] = check_hopper_body(name, paths[name], text, sass[name])
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

    phase("== phase 2b: kernel gate (ops/kernel_gate.py::run_gate, production cases)")
    gate = kernel_gate()

    phase("== phase 3: kernels vs plain versions")
    rows, errs, ratios, checked = check_kernels(frames)

    phase("== phase 4: small-input reference")
    small_reference_check()

    steps = SampleConfig().steps
    phase(f"== phase 5: main path (full SD1.5 width, 512x512, DDIM-{steps})")
    pipe, e2e = main_path(requests, frames, steps)

    phase("== phase 6: where one request's time goes (time per piece)")
    e2e["breakdown_ms"] = step_breakdown(pipe, frames)
    del pipe
    torch.cuda.empty_cache()

    from collections import Counter

    from magicdance_tpu_torch.config import stage2_pose_control, stage3_motion

    train_cfg = stage2_pose_control()
    plan, _, _ = training_launch_plan(train_cfg.model, train_cfg.image_size // 8)
    s3_cfg = stage3_motion()
    s3_sites = Counter(stage3_grad_sites(s3_cfg.model, s3_cfg.image_size // 8))
    phase("== phase 7: training kernels vs plain versions (full-width stage-2 shapes, B = 2; "
        "C and D at the stage-3 shapes, 16 frames)")
    train_rows, train_errs, train_checked = check_training_kernels(
        plan, s3_sites, batch=frames, frames=s3_cfg.video_frames)

    phase("== phase 8: small-input training reference")
    small_train = small_training_check()

    phase("== phase 9: training path (full SD1.5 width, stage 2, B = 2, 512x512)")
    train = full_width_training(steps=4, batch=frames)
    torch.cuda.empty_cache()

    phase("== phase 10: grouped (temporal) kernel G vs plain versions (full-width motion shapes)")
    grouped_rows, grouped_errs, grouped_checked = check_grouped_kernels()

    phase("== phase 11: small-input video references (narrow temporal model, card vs CPU)")
    small_video = small_video_check()
    small_stage3 = small_stage3_check()

    phase(f"== phase 12: video path (full SD1.5 width + motion modules, 16 frames at 512x512, "
        f"DDIM-{steps})")
    vpipe, video = video_main_path(requests, 16, steps)
    phase("== phase 12b: where one video request's time goes (time per piece, 16 frames)")
    video["breakdown_ms"] = step_breakdown(vpipe, 16, num_frames=16)
    del vpipe
    torch.cuda.empty_cache()

    phase("== phase 13: stage-3 training path (full SD1.5 width, one 16-frame clip, 512x512)")
    stage3 = full_width_stage3(steps=3)
    torch.cuda.empty_cache()

    from magicdance_tpu_torch.config import ModelConfig
    from magicdance_tpu_torch.pipeline import MagicPosePipeline

    model_cfg = ModelConfig()
    fused_plan = {}
    for site in pass_sites(model_cfg.unet, 64):
        if site[0] == "spatial" and site[1] >= 256:
            fused_plan[site[1], site[2]] = fused_plan.get((site[1], site[2]), 0) + 1
    phase("== phase 14: kernel B gated (fused CFG) and pooled key lengths; K8 (fused "
        "GroupNorm, SiLU or identity) at every site of the model")
    fused_rows, fused_errs, fused_checked = check_fused_cfg_and_pooled_kernels(frames, fused_plan)
    pipe = MagicPosePipeline(model_cfg, device="cuda")
    pipe.init_params(seed=0)
    gn_sites = groupnorm_sites(pipe, frames)
    gn_per_step = gn_plan_by_shape(model_cfg, 64, frames)
    if {(*key[:3], key[5]) for key, _ in gn_sites} != set(gn_per_step):
        raise AssertionError(f"GroupNorm sites of the model {[k for k, _ in gn_sites]} differ "
                             f"from the launch plan's {sorted(gn_per_step)}")
    gn_rows, gn_errs, gn_checked = check_groupnorm_kernel(gn_sites, gn_per_step)

    phase("== phase 15: small-input references of fused CFG, the turbo stacks and the plain "
        "GroupNorm (narrow models, card vs CPU)")
    small_turbo = small_turbo_checks()

    phase(f"== phase 16: fused CFG, turbo, turbo_max and plain-GroupNorm requests (full SD1.5 "
        f"width, {requests} x {frames} frames at 512x512), in turns with the exact recipe")
    served = {}
    for label, scfg, fused_gn in (
            ("exact", SampleConfig(steps=steps), True),
            ("fused_cfg", SampleConfig(steps=steps, fused_cfg=True), True),
            ("plain_gn", SampleConfig(steps=steps), False),
            ("turbo", SampleConfig(steps=steps, **TURBO), True),
            ("turbo_max", SampleConfig(steps=20, **TURBO_MAX), True),
            ("exact_again", SampleConfig(steps=steps), True)):
        plan = request_launch_plan(model_cfg, 64, frames, scfg, fused_gn=fused_gn)
        served[label] = serve_requests(pipe, scfg, requests, frames, plan, label,
                                       fused_gn=fused_gn)
    log(f"  beside phase 5's exact requests (same process): seconds per request "
        f"{[round(x, 3) for x in e2e['seconds_per_request']]}, peak memory "
        f"{e2e['peak_bytes'] / 2**30:.2f} GiB")
    del pipe
    torch.cuda.empty_cache()

    phase(f"== phase 17: video turbo (full SD1.5 width + motion modules, 16 frames at 512x512, "
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

    phase("== phase 18: kernel K9 (head-packed attention) vs plain versions, then the "
        "head-packing probe (P1-P4)")
    packed_rows, packed_errs, packed_checked, packed_extra = check_packed_kernel()
    probe, probe_launches = head_packing_probe()
    torch.cuda.empty_cache()

    phase(f"== phase 19: DUAL_CONTROL image serving (pose and image ControlNets, full SD1.5 "
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
    phase(f"== phase 20: PLMS, DPM-Solver++ 2M and 3M (SDE, sde_eta=1) (full SD1.5 width, 1 "
        f"request x {frames} frames at 512x512 each, {sampler_steps} steps, CFG 7)")
    spipe = MagicPosePipeline(model_cfg, device="cuda")
    spipe.init_params(seed=0)
    samplers = sampler_requests(spipe, frames, sampler_steps)

    phase("== phase 21: profile of one exact image DDIM step (utils/profiling.trace, "
        "torch.profiler)")
    profile = profile_ddim_step(spipe, frames, os.path.join(ROOT, "chiprun_out", "profile"))
    del spipe
    torch.cuda.empty_cache()

    phase(f"== phase 22: a reference checkpoint through the sampling CLI (full SD1.5 width, "
        f"fp16 reference-layout file, 1 request x {frames} frames at 512x512, DDIM-{steps}; "
        f"then --video, 16 frames, DDIM-10)")
    cli = sample_cli_checkpoint(card, frames=frames, steps=steps)

    phase("== phase 23: OpenPose on the card (body, hand and face nets, card vs CPU in fp32; "
        "the detector end to end)")
    openpose = openpose_on_card(card)

    phase(f"== phase 24: evaluation on the card (cli.eval at full SD1.5 width, 2 videos x 1 "
        f"request of F = 8 at 512x512, DDIM-{steps}; every metric type through "
        f"get_all_eval_scores and the CLIP similarity; the metric nets card vs CPU in fp32)")
    evaluation = eval_on_card(card, steps=steps)

    phase("== phase 25: distribution on the card (25a: one rank over NCCL; 25b: two ranks "
        "sharing the card over gloo), full SD1.5 width")
    distribution = distribution_on_card(card)
    dl = distribution["launches"]

    phase("== phase 26: training leftovers (frozen int8, attention_impl flash / xla, the native "
        "batch loader, the Flax-style init, dropout), full SD1.5 width")
    t26 = time.perf_counter()
    leftovers = training_leftovers_on_card(card, frames)
    ll = leftovers["launches"]
    log(f"  phase 26 in {time.perf_counter() - t26:.1f} s")

    phase(f"== phase 27: magicpose-sdxl (A and B at its 64-wide heads, one DDIM step of "
          f"{SDXL_FRAMES} frames at 1024x1024 held to its launch plan, K8 at its GroupNorm "
          f"sites)")
    sdxl = sdxl_on_card()

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
                evaluation["generation"]["launches"],
             f"distributed training, world 1 over NCCL (stage 2, {P25_TRAIN_STEPS} steps)":
                dl["train"],
             "frame-parallel image serving, world 1 over NCCL (1 request x 50 DDIM steps)":
                dl["image"],
             "window-parallel video serving, world 1 over NCCL (1 request x 10 DDIM steps)":
                dl["video"],
             "distributed training, 2 ranks over gloo (stage 2, 2 steps, both ranks)":
                dl["b_train"],
             "frame-parallel image serving, 2 ranks over gloo (1 request x 50 DDIM steps, "
             "both ranks)": dl["b_image"],
             "window-parallel video serving, 2 ranks over gloo (1 request x 10 DDIM steps, "
             "both ranks)": dl["b_video"],
             f"image training, frozen int8 (stage 2, {P25_TRAIN_STEPS} steps)": ll["int8"],
             f"image training, bf16 holding int8's dequantized values (stage 2, "
             f"{P25_TRAIN_STEPS} steps)": ll["bf16"],
             f"image training, attention_impl=flash (stage 2, {P25_TRAIN_STEPS} steps)":
                ll["flash"],
             "image training, attention_impl=xla (stage 2, 1 step)": ll["xla"],
             "video training, attention_impl=flash (stage 3, 2 steps)": ll["stage3_flash"],
             "training CLI, frozen int8, Flax-style init (stage 2 POSE_ONLY, 2 steps)":
                ll["cli"],
             f"magicpose-sdxl image serving (1 request x {SDXL_FRAMES} frames, 1 DDIM step)":
                sdxl["launches"]}
    kernels = []
    for name, meta in KERNELS.items():
        by_path = {p: sum(launches.get(m, 0) for m in meta["modes"])
                   for p, launches in paths.items()}
        if name in ("two_source_attention_gated", "groupnorm_silu"):
            main_rows = [r for r in (fused_rows if name.startswith("two") else gn_rows)
                         if r["kernel"] == name]
            err = max((fused_errs if name.startswith("two") else gn_errs)[name],
                      sdxl["errs"].get(name, 0.0))
            n_checked = ((fused_checked if name.startswith("two") else gn_checked)[name]
                         + sdxl["checked"].get(name, 0))
            kernels.append(dict(
                name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
                body=meta["body"],
                launches=sum(by_path.values()), launches_by_path=by_path, max_abs_err=err,
                ms=per_step(main_rows, "kernel_ms"), plain_ms=per_step(main_rows, "plain_ms"),
                bound_ms=per_step(main_rows, "bound_ms"), bound_by=bound_by(main_rows),
                library_ms=per_step(main_rows, "library_ms"),
                **({"mma_sync_ms": per_step(main_rows, "mma_sync_ms"),
                    "hopper_body": hopper["two_source_attention"]}
                   if name.startswith("two") else {}),
                per="one DDIM step of the image serving path"
                    + (" with fused_cfg=True" if name.startswith("two") else "")
                    + " (sum over its calls)",
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
                library_equal_work_ms=per_step(packed_rows, "library_equal_work_ms"),
                mma_sync_ms=per_step(packed_rows, "mma_sync_ms"), g1=packed_extra["g1"],
                hopper_body=hopper[name],
                per="one launch at the probe's shape (BG 64, S 4096, G 3, D 40, bf16); "
                    "library_ms: SDPA per head (a third of K9's operations); "
                    "library_equal_work_ms: SDPA on q repeated over the G segments",
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
                      packed_errs.get(name, 0.0), leftovers["errs"][name],
                      sdxl["errs"].get(name, 0.0))
            n_checked = (checked.get(name, 0) + train_checked[name]
                         + fused_checked.get(name, 0) + packed_checked.get(name, 0)
                         + leftovers["checked"][name] + sdxl["checked"].get(name, 0))
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
            entry["max_err_over_rms"] = max(ratios[name], sdxl["ratios"][name])
        if name in HOPPER_EXPECTED:
            entry["hopper_body"] = hopper[name]
        if main_rows and all("mma_sync_ms" in r for r in main_rows):
            entry["mma_sync_ms"] = per_step(main_rows, "mma_sync_ms")
        if all("exp_bound_ms" in r for r in main_rows):
            entry["exp_bound_ms"] = per_step(main_rows, "exp_bound_ms")
        if video_rows:
            entry["video_step"] = dict(
                ms=per_step(video_rows, "kernel_ms"), plain_ms=per_step(video_rows, "plain_ms"),
                mma_sync_ms=per_step(video_rows, "mma_sync_ms"),
                bound_ms=per_step(video_rows, "bound_ms"),
                exp_bound_ms=per_step(video_rows, "exp_bound_ms"),
                library_ms=per_step(video_rows, "library_ms"), bound_by=bound_by(video_rows),
                per="one DDIM step of the video serving path (16 frames), the bank reads' "
                    "launches")
        if stage3_rows:
            entry["stage3_step"] = dict(
                ms=per_step(stage3_rows, "kernel_ms"), plain_ms=per_step(stage3_rows, "plain_ms"),
                mma_sync_ms=per_step(stage3_rows, "mma_sync_ms"),
                bound_ms=per_step(stage3_rows, "bound_ms"),
                exp_bound_ms=per_step(stage3_rows, "exp_bound_ms"),
                library_ms=per_step(stage3_rows, "library_ms"), bound_by=bound_by(stage3_rows),
                per="one stage-3 training step (a 16-frame clip, a batch-1 bank; sum over its "
                    "launches)")
        flash_rows = [r for r in leftovers["shapes"] if r["mode"] in meta["modes"]]
        if flash_rows:
            entry["flash_shapes"] = [
                {k: r[k] for k in ("mode", "case", "B", "S", "S_kv", "D", "path",
                                   "launches_per_step", "kernel_ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by", "body", "wgmma_ms", "mma_sync_ms")
                 if k in r} for r in flash_rows]
            for path in ("stage 2", "stage 3"):
                sub = [r for r in flash_rows if r["path"] == path]
                if sub:
                    entry[f"flash_{path.replace(' ', '')}_new_shapes"] = dict(
                        ms=per_step(sub, "kernel_ms"), plain_ms=per_step(sub, "plain_ms"),
                        bound_ms=per_step(sub, "bound_ms"),
                        library_ms=per_step(sub, "library_ms"), bound_by=bound_by(sub),
                        per=f"one {path} training step under attention_impl=flash, the "
                            "launches at the shapes the override adds (sum)")
        if serving and training:
            entry["training_step"] = dict(
                ms=per_step(training, "kernel_ms"), plain_ms=per_step(training, "plain_ms"),
                mma_sync_ms=per_step([r for r in training if "mma_sync_ms" in r],
                                     "mma_sync_ms"),
                bound_ms=per_step(training, "bound_ms"),
                library_ms=per_step(training, "library_ms"), bound_by=bound_by(training),
                per="one training step, the LSE forward's launches")
        kernels.append(entry)
    for entry in kernels:
        sub = [r for r in sdxl["shapes"] if r["kernel"] == entry["name"]]
        if sub:
            entry["sdxl_step"] = dict(
                ms=per_step(sub, "kernel_ms"), plain_ms=per_step(sub, "plain_ms"),
                bound_ms=per_step(sub, "bound_ms"), library_ms=per_step(sub, "library_ms"),
                bound_by=bound_by(sub),
                per=f"one DDIM step of magicpose-sdxl image serving ({SDXL_FRAMES} frames at "
                    "1024x1024; sum over its launches, K8's over its calls)")
    end_phase()
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
                           openpose=openpose, evaluation=evaluation,
                           distribution={k: v for k, v in distribution.items()
                                         if k != "launches"},
                           training_leftovers=leftovers, sdxl=sdxl, kernels=kernels,
                           phase_s=dict(PHASE_S)), f,
                      indent=1)
    log(f"== all phases passed in {time.perf_counter() - t_start:.1f} s; by phase "
        f"{json.dumps(dict(PHASE_S))}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
