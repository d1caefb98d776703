"""Plain reference of the MagicPose training step.

The frozen VAE encodes the images and the references (posterior samples
from the given noise, scaled), the frozen CLIP the empty prompts; the
denoiser predicts the noise of x_t = sqrt(acp_t) x_0 + sqrt(1 - acp_t) eps
with the reference latents written to the bank (one reference per sample,
or per clip of `frames` frames) and the pose hints through the ControlNet;
the loss is the mean squared error against eps. The gradients of the
trainable leaves are clipped by their global norm, then AdamW (bias
corrected, a learning rate warmed up linearly from 0 over `warmup_steps`
updates, the first update at rate 0) moves them. The batch is taken one
sample (or clip) at a time and the gradients summed, so that it fits.
"""

from __future__ import annotations

import torch

from port_bench.reference.model import Numerics
from port_bench.reference.sample import alphas_cumprod


def trainable(regime: str, key: str) -> bool:
    """The freeze regimes of the two stages measured here."""
    root = key.split(".")[0]
    if regime == "finetune_control":
        return root in ("appearance_unet", "pose_control")
    if regime == "motion_only":
        return any("motion" in p for p in key.split("."))
    raise ValueError(f"the reference knows no freeze regime {regime!r}")


class ReferenceTrainer:
    def __init__(self, model, vae, clip, cfg: dict, train: dict, num: Numerics):
        self.model, self.vae, self.clip, self.num = model, vae, clip, num
        self.cfg, self.train = cfg, train
        self.frames = train["video_frames"] if cfg["variant"] == "appearance_pose_temporal" else 1
        self.params = {k: p for k, p in model.named_parameters()
                       if trainable(train["freeze"], k)}
        for k, p in model.named_parameters():
            p.requires_grad_(k in self.params)
        for p in list(vae.parameters()) + list(clip.parameters()):
            p.requires_grad_(False)
        self.m = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.count = 0
        acp = torch.tensor(alphas_cumprod(cfg["diffusion"]), dtype=torch.float32)
        self.acp = acp.to(next(model.parameters()).device)

    @torch.no_grad()
    def encode(self, batch, draws):
        sf = self.cfg["vae"]["scale_factor"]
        with self.num.encoders():
            def sample(images, noise):
                out = []
                for im, nz in zip(images.split(4), noise.split(4)):
                    mean, logvar = self.vae.encode(im)
                    out.append((mean + torch.exp(0.5 * logvar) * nz) * sf)
                return torch.cat(out)

            x0 = sample(batch["image"], draws["vae_image"])
            ref = sample(batch["reference"], draws["vae_reference"])
            ctx = self.clip(batch["input_ids"])
        return x0, ref, ctx

    def loss_and_grads(self, batch, draws):
        """(loss, {key: gradient}) of the batch, one sample or clip a time."""
        x0, ref, ctx = self.encode(batch, draws)
        t, noise = draws["t"], draws["noise"]
        f = self.frames
        groups = x0.shape[0] // f
        grads = {k: torch.zeros_like(p) for k, p in self.params.items()}
        total = torch.zeros((), device=x0.device)
        for g in range(groups):
            rows = slice(g * f, (g + 1) * f)
            a = self.acp[t[rows]][:, None, None, None]
            x_t = a.sqrt() * x0[rows] + (1 - a).sqrt() * noise[rows]
            with torch.enable_grad():
                bank = self.model.bank(ref[g:g + 1], t[rows][:1], ctx[rows][:1])
                out = self.model.cond(x_t, t[rows], ctx[rows], bank, batch["pose"][rows],
                                      frames=f)
                loss = ((out - noise[rows]) ** 2).mean() / groups
                gs = torch.autograd.grad(loss, list(self.params.values()), allow_unused=True)
            for k, gk in zip(self.params, gs):
                if gk is not None:
                    grads[k] += gk
            total = total + loss.detach()
        return total, grads

    @torch.no_grad()
    def update(self, grads) -> dict:
        """Clip by global norm, AdamW; returns the norm of each leaf's
        clipped gradient (what the optimizer is given)."""
        o = self.train["optim"]
        norm = torch.sqrt(sum(g.pow(2).sum() for g in grads.values()))
        clip = torch.where(norm < o["grad_clip"], torch.ones_like(norm), o["grad_clip"] / norm)
        warm = max(1, o["warmup_steps"])
        lr = o["learning_rate"] * min(1.0, self.count / warm)
        self.count += 1
        b1, b2 = o["adam_b1"], o["adam_b2"]
        norms = {}
        for k, p in self.params.items():
            g = grads[k] * clip
            norms[k] = g.norm()
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (self.m[k] / (1 - b1 ** self.count)) / (
                (self.v[k] / (1 - b2 ** self.count)).sqrt() + o["adam_eps"])
            if o["weight_decay"]:
                upd = upd + o["weight_decay"] * p
            p.add_(upd, alpha=-lr)
        return norms
