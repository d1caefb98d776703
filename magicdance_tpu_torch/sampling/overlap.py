"""Sliding-window ("overlap") DDIM sampling of a video (PyTorch).

Counterpart of the exact path of `magicdance_tpu.sampling.overlap`
(ref ldm/models/diffusion/ddim.py:569-594): the temporal UNet sees windows of
`scfg.window` frames; a longer video is covered by windows `scfg.stride`
apart whose per-frame eps predictions are averaged before the DDIM update.
Every step denoises all windows as one batch (clip major, frames inner) and
rotates the window boundaries by a random cyclic offset -- even a single
window, whose frames are then permuted: the motion modules' positional
encoding makes the result order-dependent, so the offset is never skipped.

The offsets are an input: one per step, given (`window_offsets`) or drawn
all at once from the caller's generator before the loop, so a request needs
no host sync for them. The turbo levers and `window_sharding` are not
ported and raise.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from magicdance_tpu_torch.config import Parameterization, SampleConfig
from magicdance_tpu_torch.models.diffusion import output_to_eps
from magicdance_tpu_torch.ops.schedules import DDIMSchedule, DiffusionSchedule, q_sample
from magicdance_tpu_torch.sampling.ddim import _check_exact, ddim_step


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
    parameterization: Parameterization = Parameterization.EPS,
    window_offsets: Optional[Sequence[int]] = None,
    generator: Optional[torch.Generator] = None,
    window_sharding=None,
) -> torch.Tensor:
    """Sample the latents of an F-frame video from x_T (F, h, w, 4).

    model: a MagicPoseModel with motion modules; context / uncond_context:
    (1, 77, context_dim); reference_latent: (1, h, w, 4); pose_hint:
    (F, H, W, 3). `window_offsets`: the per-step cyclic offsets (S ints in
    [0, F)), else drawn from `generator`, which also supplies the noise when
    eta > 0 or wonoise is off. The uncond pass is the vanilla-SD forward, as
    in the JAX video sampler."""
    _check_exact(scfg)
    if window_sharding is not None:
        raise NotImplementedError("window_sharding is not ported yet (one device)")
    F = x_T.shape[0]
    W = min(scfg.window, F)
    dev = x_T.device
    starts = torch.as_tensor(window_starts(F, scfg.window, scfg.stride), device=dev)
    n_win = starts.shape[0]
    S = ddim.num_steps
    if window_offsets is None:  # one draw for every step: no host sync
        offsets = torch.randint(0, F, (S,), generator=generator,
                                device=dev if generator is None else generator.device).to(dev)
    else:
        offsets = torch.as_tensor(list(window_offsets), dtype=torch.int64, device=dev)
    if offsets.shape != (S,):
        raise ValueError(f"window_offsets: expected {S} offsets, got {tuple(offsets.shape)}")
    use_cfg = scfg.cfg_scale != 1.0 and uncond_context is not None
    has_appearance = reference_latent is not None and model.cfg.has_appearance

    def tile(c):
        if c is None:
            return None
        return c.expand(n_win * W, *c.shape[1:]) if c.shape[0] == 1 else c

    win_ctx, win_uctx = tile(context), tile(uncond_context)
    ref_ctx = context[:1]
    frame = torch.arange(W, device=dev)
    x = x_T.float()
    for i in range(S):
        step = S - 1 - i  # descending t
        t_scalar = int(ddim.timesteps[step])
        idx = (starts[:, None] + offsets[i] + frame[None, :]) % F  # (n_win, W)
        flat = idx.reshape(-1)
        xw = x[flat]
        t = torch.full((flat.shape[0],), t_scalar, dtype=torch.int64, device=dev)

        bank = None
        if has_appearance:
            t_ref = torch.full((reference_latent.shape[0],), t_scalar, dtype=torch.int64,
                               device=dev)
            if scfg.wonoise:
                ref_noisy = reference_latent
            else:
                ref_noise = torch.randn(reference_latent.shape, generator=generator,
                                        device=dev, dtype=reference_latent.dtype)
                ref_noisy = q_sample(sched, reference_latent, t_ref, ref_noise)
            bank = model.compute_bank(ref_noisy, t_ref, ref_ctx)

        hint_w = pose_hint[flat] if pose_hint is not None else None
        eps_w = output_to_eps(parameterization, sched,
                              model(xw, t, win_ctx, bank=bank, pose_hint=hint_w,
                                    num_frames=W), xw, t)
        if use_cfg:
            eps_u = output_to_eps(parameterization, sched,
                                  model(xw, t, win_uctx, uc=True, num_frames=W), xw, t)
            eps_w = eps_u + scfg.cfg_scale * (eps_w - eps_u)

        # scatter-average onto the frames (ref ddim.py:586-594). Window by
        # window: a window's frames are distinct, so each add is free of
        # duplicate indices, and a frame's contributions are summed in window
        # order on every device (JAX's order on the CPU).
        eps = torch.zeros_like(x)
        counts = torch.zeros((F,), dtype=torch.float32, device=dev)
        for w in range(n_win):
            eps.index_add_(0, idx[w], eps_w[w * W:(w + 1) * W])
            counts.index_add_(0, idx[w], torch.ones((W,), device=dev))
        eps = eps / counts[:, None, None, None]

        if scfg.eta > 0:
            noise = torch.randn(x.shape, generator=generator, device=dev, dtype=x.dtype)
        else:
            noise = torch.zeros_like(x)
        x, _ = ddim_step(x, eps, ddim.alphas[step], ddim.alphas_prev[step],
                         ddim.sqrt_one_minus_alphas[step], ddim.sigmas[step], noise)
    return x
