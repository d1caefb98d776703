"""Sliding-window ("overlap") DDIM sampling of a video (PyTorch).

Counterpart of `magicdance_tpu.sampling.overlap`
(ref ldm/models/diffusion/ddim.py:569-594): the temporal UNet sees windows of
`scfg.window` frames; a longer video is covered by windows `scfg.stride`
apart whose per-frame eps predictions are averaged before the DDIM update.
Every step denoises all windows as one batch (clip major, frames inner) and
rotates the window boundaries by a random cyclic offset -- even a single
window, whose frames are then permuted: the motion modules' positional
encoding makes the result order-dependent, so the offset is never skipped.

The offsets are an input: one per step, given (`window_offsets`) or drawn
all at once from the caller's generator before the loop, so a request needs
no host sync for them.

Turbo levers (the image sampler's masks, `ddim.TurboPlan`): the caches that
depend on the window layout live in FRAME space, per absolute frame index --
the uncond eps, the 13 pose residuals and the DeepCache deep features are
scatter-averaged from the window batch onto the frames on refresh steps and
gathered back through the CURRENT step's rotated layout on reuse steps, so
they survive the rotation. The bank does not depend on the windows. As in
JAX, `fused_cfg` does nothing here and the uncond pass is always the
vanilla-SD forward.

`window_sharding` (multi-card serving; a DeviceMesh or its 'data'
`MeshAxis`): the windows of every step split over the ranks, each rank runs
the passes of its windows (and the batch-1 bank itself), and every
scatter-average onto the frames -- the eps, and the frame-space caches of
the turbo levers -- sums its windows locally in fp32 and all-reduces the
sums and the counts: one collective per average. The frame-space latents,
the offsets (rank 0's, broadcast) and every draw stay the same on every
rank. The sums add in another order than on one device, so the result
agrees to rounding, not bit for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from magicdance_tpu_torch.config import Parameterization, SampleConfig
from magicdance_tpu_torch.models.diffusion import output_to_eps
from magicdance_tpu_torch.models.magicpose import refuse_vector
from magicdance_tpu_torch.ops.schedules import DDIMSchedule, DiffusionSchedule, q_sample
from magicdance_tpu_torch.parallel.mesh import MeshAxis, as_axis
from magicdance_tpu_torch.sampling.ddim import (
    TurboPlan,
    check_control_mode,
    ddim_step,
    downsample_bank,
    self_kv_kwargs,
)
from magicdance_tpu_torch.utils.profiling import span


def window_starts(num_frames: int, window: int, stride: int) -> np.ndarray:
    """Cyclic window starts covering [0, F)."""
    if num_frames <= window:
        return np.array([0])
    n = int(np.ceil(num_frames / stride))
    return (np.arange(n) * stride) % num_frames


@torch.inference_mode()
def ddim_sample_video(
    model,
    sched: DiffusionSchedule,
    ddim: DDIMSchedule,
    scfg: SampleConfig,
    x_T: torch.Tensor,
    context: torch.Tensor,
    uncond_context: Optional[torch.Tensor] = None,
    *,
    reference_latent: Optional[torch.Tensor] = None,
    pose_hint: Optional[torch.Tensor] = None,
    image_hint: Optional[torch.Tensor] = None,
    parameterization: Parameterization = Parameterization.EPS,
    window_offsets: Optional[Sequence[int]] = None,
    generator: Optional[torch.Generator] = None,
    window_sharding=None,
) -> torch.Tensor:
    """Sample the latents of an F-frame video from x_T (F, h, w, 4).

    model: a MagicPoseModel with motion modules; context / uncond_context:
    (1, 77, context_dim); reference_latent: (1, h, w, 4); pose_hint:
    (F, H, W, 3); image_hint: (F, H, W, 3), the DUAL_CONTROL image
    ControlNet's hint, gathered per window as the pose maps are.
    `window_offsets`: the per-step cyclic offsets (S ints in [0, F)), else
    drawn from `generator`, which also supplies the noise when eta > 0 or
    wonoise is off. The uncond pass is the vanilla-SD forward, as in the JAX
    video sampler. `window_sharding`: see the module docstring; every rank
    needs at least one window."""
    check_control_mode(scfg)
    axis = as_axis(window_sharding)
    F = x_T.shape[0]
    W = min(scfg.window, F)
    dev = x_T.device
    starts = torch.as_tensor(window_starts(F, scfg.window, scfg.stride), device=dev)
    n_win = starts.shape[0]
    if n_win < axis.size:
        raise ValueError(f"{n_win} window(s) of {W} frames cannot cover {axis.size} ranks; "
                         "use a smaller window")
    w0, w1 = axis.rows(n_win)  # this rank's windows
    S = ddim.num_steps
    if window_offsets is None:  # one draw for every step: no host sync
        offsets = torch.randint(0, F, (S,), generator=generator,
                                device=dev if generator is None else generator.device).to(dev)
        axis.broadcast(offsets)
    else:
        offsets = torch.as_tensor(list(window_offsets), dtype=torch.int64, device=dev)
    if offsets.shape != (S,):
        raise ValueError(f"window_offsets: expected {S} offsets, got {tuple(offsets.shape)}")
    use_cfg = scfg.cfg_scale != 1.0 and uncond_context is not None
    refuse_vector(model.cfg, "the overlap-window video sampler")
    has_appearance = reference_latent is not None and model.cfg.has_appearance
    has_controls = (pose_hint is not None and model.cfg.has_pose) or (
        image_hint is not None and model.cfg.has_image_control)
    plan = TurboPlan(scfg, sched, ddim, use_cfg, has_appearance, has_controls,
                     fused_cfg=False)
    kv_kw = self_kv_kwargs(scfg)

    def tile(c):
        if c is None:
            return None
        return c.expand((w1 - w0) * W, *c.shape[1:]) if c.shape[0] == 1 else c

    def to_eps(out, x, t):
        return output_to_eps(parameterization, sched, out, x, t)

    win_ctx, win_uctx = tile(context), tile(uncond_context)
    ref_ctx = context[:1]
    frame = torch.arange(W, device=dev)
    x = x_T.float()
    # frame-space caches, each refreshed by the schedules at its first use
    eps_u = bank = pose_frames = deep = deep_u = None
    for i in range(S):
        with span("md.ddim.step", " i={}".format, i):
            step = S - 1 - i  # descending t
            t_scalar = int(ddim.timesteps[step])
            idx = (starts[w0:w1, None] + offsets[i] + frame[None, :]) % F  # (windows, W)
            flat = idx.reshape(-1)
            xw = x[flat]
            t = torch.full((flat.shape[0],), t_scalar, dtype=torch.int64, device=dev)

            def to_frames(vals_w):
                return scatter_mean(vals_w, idx, F, axis)

            if has_appearance and plan.bank_refresh[step]:
                t_ref = torch.full((reference_latent.shape[0],), t_scalar, dtype=torch.int64,
                                   device=dev)
                if scfg.wonoise:
                    ref_noisy = reference_latent
                else:
                    ref_noise = torch.randn(reference_latent.shape, generator=generator,
                                            device=dev, dtype=reference_latent.dtype)
                    ref_noisy = q_sample(sched, reference_latent, t_ref, ref_noise)
                bank = downsample_bank(model.compute_bank(ref_noisy, t_ref, ref_ctx),
                                       scfg.bank_downsample, scfg.bank_downsample_min_seq)

            hint_w = pose_hint[flat] if pose_hint is not None else None
            ihint_w = image_hint[flat] if image_hint is not None else None
            pose_kw = {}
            if plan.pose_reuse:
                if plan.pose_refresh[step]:
                    res = model.compute_control_residuals(xw, hint_w, t, win_ctx,
                                                          image_hint=ihint_w, **kv_kw)
                    pose_frames = tuple(to_frames(r) for r in res)
                pose_kw = dict(pose_residuals=tuple(r[flat] for r in pose_frames))
            cond_kw = dict(bank=bank, pose_hint=hint_w, image_hint=ihint_w, num_frames=W,
                           **pose_kw, **kv_kw)
            if plan.deepcache and plan.deep_refresh[step]:
                out_c, d = model(xw, t, win_ctx, collect_deep=True, deep_level=plan.deep_level,
                                 **cond_kw)
                deep = to_frames(d)
            elif plan.deepcache:
                out_c = model(xw, t, win_ctx, deep_cache_in=deep[flat],
                              deep_level=plan.deep_level, **cond_kw)
            else:
                out_c = model(xw, t, win_ctx, **cond_kw)
            eps_c = to_eps(out_c, xw, t)

            uc_kw = dict(uc=True, num_frames=W, **kv_kw)
            if not plan.turbo:
                if use_cfg:
                    eps_uw = to_eps(model(xw, t, win_uctx, **uc_kw), xw, t)
                    eps_c = eps_uw + scfg.cfg_scale * (eps_c - eps_uw)
                eps = to_frames(eps_c)
            else:
                # the turbo path averages cond and uncond onto the frames apart
                # and combines them there (the uncond eps is a frame-space cache)
                eps = to_frames(eps_c)
                if use_cfg:
                    if plan.refresh[step]:
                        if plan.uncond_deepcache and plan.udeep_refresh[step]:
                            out_u, d = model(xw, t, win_uctx, collect_deep=True,
                                             deep_level=plan.deep_level, **uc_kw)
                            deep_u = to_frames(d)
                        elif plan.uncond_deepcache:
                            out_u = model(xw, t, win_uctx, deep_cache_in=deep_u[flat],
                                          deep_level=plan.deep_level, **uc_kw)
                        else:
                            out_u = model(xw, t, win_uctx, **uc_kw)
                        eps_u = to_frames(to_eps(out_u, xw, t))
                    if plan.active[step]:
                        eps = eps_u + scfg.cfg_scale * (eps - eps_u)

            if scfg.eta > 0:
                noise = torch.randn(x.shape, generator=generator, device=dev, dtype=x.dtype)
            else:
                noise = torch.zeros_like(x)
            x, _ = ddim_step(x, eps, ddim.alphas[step], ddim.alphas_prev[step],
                             ddim.sqrt_one_minus_alphas[step], ddim.sigmas[step], noise)
    return x


def scatter_mean(vals_w: torch.Tensor, idx: torch.Tensor, num_frames: int,
                 axis: Optional[MeshAxis] = None) -> torch.Tensor:
    """Average window-batched values (n_win*W, ...) onto the absolute frames
    (num_frames, ...) in fp32, cast back to their dtype (ref ddim.py:586-594
    pred_all/counts). Window by window: a window's frames are distinct, so
    each add is free of duplicate indices, and a frame's contributions are
    summed in window order on every device (JAX's order on the CPU). With
    `axis`, `idx` holds this rank's windows and the sums and counts are
    all-reduced over the ranks before the division."""
    n_win, w = idx.shape
    acc = torch.zeros((num_frames,) + vals_w.shape[1:], dtype=torch.float32,
                      device=vals_w.device)
    if vals_w.dim() == 4 and vals_w.is_contiguous(memory_format=torch.channels_last):
        acc = acc.contiguous(memory_format=torch.channels_last)  # deep features stay NHWC
    counts = torch.zeros((num_frames,), dtype=torch.float32, device=vals_w.device)
    ones = torch.ones((w,), dtype=torch.float32, device=vals_w.device)
    for j in range(n_win):
        acc.index_add_(0, idx[j], vals_w[j * w:(j + 1) * w].float())
        counts.index_add_(0, idx[j], ones)
    if axis is not None and axis.group is not None:
        axis.all_reduce(acc)
        axis.all_reduce(counts)
    return (acc / counts.reshape((num_frames,) + (1,) * (vals_w.dim() - 1))).to(vals_w.dtype)
