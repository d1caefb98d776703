"""Plain reference of a served request: DDIM with classifier-free guidance.

The recipe of the MagicDance inference scripts: the empty prompt through
CLIP, the reference image through the VAE encoder (posterior mean, scaled),
then per DDIM step (timesteps descending) the appearance UNet writes the
bank from the clean reference latent, the pose ControlNet gives its
residuals, the main UNet reads both (cond), a plain SD pass with the same
empty context gives the uncond eps ("controlnet_important"), and
eps = uncond + scale * (cond - uncond) drives the deterministic (eta = 0)
update. Video: the frames are covered by windows of `window` frames
`stride` apart, rotated by a per-step cyclic offset; each window's eps is
averaged back onto its frames. `decode` turns latents into images (fp32).
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference.model import Numerics

BOS, EOS = 49406, 49407


def empty_ids(batch: int, length: int = 77) -> torch.Tensor:
    ids = torch.full((batch, length), EOS, dtype=torch.int64)
    ids[:, 0] = BOS
    return ids


def alphas_cumprod(d: dict) -> np.ndarray:
    """The "linear" SD schedule (linear in sqrt(beta)), float64."""
    if d["beta_schedule"] != "linear":
        raise ValueError(f"the reference knows the linear schedule, not {d['beta_schedule']!r}")
    betas = np.linspace(d["linear_start"] ** 0.5, d["linear_end"] ** 0.5, d["timesteps"],
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def ddim_table(d: dict, steps: int):
    """(timesteps, alpha, alpha_prev) per DDIM step, t ascending: uniform
    steps T/S apart, shifted by one, as the reference's `make_ddim_timesteps`."""
    acp = alphas_cumprod(d)
    ts = np.arange(steps) * (d["timesteps"] // steps) + 1
    a = acp[ts]
    a_prev = np.concatenate([[acp[0]], acp[ts[:-1]]])
    return ts, a.astype(np.float32), a_prev.astype(np.float32)


def window_starts(frames: int, window: int, stride: int) -> list:
    if frames <= window:
        return [0]
    return [(i * stride) % frames for i in range(-(-frames // stride))]


@torch.no_grad()
def sample(model, vae, clip, cfg: dict, pose, ref_image, x_T, steps: int, scale: float,
           num: Numerics, video: bool = False, offsets=None, window: int = 16,
           stride: int = 12):
    """The latents (F, h, w, 4) of one request, before the decode. pose
    (F, H, W, 3) in [0, 1], ref_image (1, H, W, 3) in [-1, 1], x_T
    (F, h, w, 4); `offsets`: one cyclic window offset per executed step
    (video)."""
    sf = cfg["vae"]["scale_factor"]
    with num.encoders():
        ctx = clip(empty_ids(1).to(x_T.device))
        ref_lat = vae.encode(ref_image)[0] * sf
    ts, a, a_prev = ddim_table(cfg["diffusion"], steps)
    n = x_T.shape[0]
    x = x_T.float().clone()
    w = min(window, n)
    starts = window_starts(n, window, stride) if video else None
    for i in range(steps):
        step = steps - 1 - i
        t1 = torch.full((1,), int(ts[step]), device=x.device)
        bank = model.bank(ref_lat, t1, ctx)
        if video:
            idx = torch.stack([(s + int(offsets[i]) + torch.arange(w, device=x.device)) % n
                               for s in starts])
            flat = idx.reshape(-1)
            xw, tw = x[flat], t1.expand(flat.shape[0])
            ew = model.cond(xw, tw, ctx, bank, pose[flat], frames=w)
            eu = model.uncond(xw, tw, ctx, frames=w)
            ew = eu + scale * (ew - eu)
            acc = torch.zeros_like(x)
            cnt = torch.zeros(n, device=x.device)
            for j in range(idx.shape[0]):
                acc.index_add_(0, idx[j], ew[j * w:(j + 1) * w])
                cnt.index_add_(0, idx[j], torch.ones(w, device=x.device))
            eps = acc / cnt[:, None, None, None]
        else:
            tb = t1.expand(n)
            ec = model.cond(x, tb, ctx, bank, pose)
            eu = model.uncond(x, tb, ctx)
            eps = eu + scale * (ec - eu)
        al, ap = float(a[step]), float(a_prev[step])
        pred_x0 = (x - (1.0 - al) ** 0.5 * eps) / al ** 0.5
        x = ap ** 0.5 * pred_x0 + max(1.0 - ap, 0.0) ** 0.5 * eps
    return x


@torch.no_grad()
def decode(vae, latents, cfg: dict, num: Numerics, chunk: int = 4):
    """Images (F, H, W, 3) of latents (F, h, w, 4): unscaled, then the VAE
    decoder, a few frames at a time."""
    sf = cfg["vae"]["scale_factor"]
    with num.encoders():
        return torch.cat([vae.decode(c / sf) for c in torch.split(latents, chunk)])
