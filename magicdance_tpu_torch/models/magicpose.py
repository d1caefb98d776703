"""MagicPose composed denoiser: main UNet + appearance UNet + pose ControlNet
(+ the image ControlNet of the DUAL_CONTROL variant).

Counterpart of `magicdance_tpu.models.magicpose.MagicPoseModel`: the
appearance branch is a second UNet run on the reference latent in bank-write
mode; the pose branch returns the 13 ControlNet residuals, and under
DUAL_CONTROL a second ControlNet (`image_control_model`) on an image hint
returns 13 more, summed position by position with the pose branch's; the CFG
uncond pass (`uc=True`) is a vanilla SD forward that skips every branch.
`concat_cond` (mask / masked-latent channels of the inpaint variants) is
concatenated onto the noisy latent's channels before the UNet and the
ControlNets (`cfg.unet.in_channels` counts them; the appearance UNet reads
the bare reference latent). With motion modules (the temporal variant)
the batch holds clips of `num_frames` frames, clip major; the appearance
UNet and the ControlNet stay per frame, and one reference per clip serves its
frames. The sampler's turbo levers reach the networks through `forward`
(cached `pose_residuals`, DeepCache, self-KV pooling) and `cfg_fused_eps`
(cond and uncond rows in one batch, the bank gated per row).
An SDXL configuration (`ModelConfig.has_vector`) gives every pass the
added vector `y` beside the context: the write pass, the ControlNet, the
cond and the uncond pass; the paths that cannot carry it (fused CFG,
DUAL_CONTROL) refuse such a configuration (`refuse_vector`).
VAE and CLIP live outside (applied once per request, or once per training
batch). The networks compute in `cfg.dtype` whatever dtype their weights are
stored in (a trainer holds fp32 trainable masters beside frozen weights in
`frozen_dtype`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from magicdance_tpu_torch.config import ModelConfig, UNetConfig
from magicdance_tpu_torch.models.controlnet import PoseControlNet
from magicdance_tpu_torch.models.unet import Bank, UNet
from magicdance_tpu_torch.utils.profiling import span


def appearance_unet_config(cfg: ModelConfig) -> UNetConfig:
    """The appearance branch shares the UNet architecture, never with motion
    modules. It reads the reference latent alone, without the concat_cond
    channels: its input has the latent's channels (`out_channels`), as the
    JAX module's conv_in takes them from its input."""
    u = cfg.unet
    return dataclasses.replace(u, in_channels=u.out_channels, use_motion_modules=False)


def refuse_vector(cfg: ModelConfig, path: str) -> None:
    """A path that does not carry the added vector refuses a configuration
    that takes one, rather than dropping it."""
    if cfg.has_vector:
        raise NotImplementedError(
            f"{path} does not carry the added vector y of an SDXL configuration "
            f"(adm_in_channels {cfg.unet.adm_in_channels})")


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _repeat_bank(bank: Bank, b: int) -> Bank:
    """One bank entry per clip, repeated for each of its frames (Bb -> B)."""
    rep = b // bank[0].shape[0]
    return tuple(e.repeat_interleave(rep, dim=0) for e in bank)


class MagicPoseModel(nn.Module):
    """The per-step hot path. Compute dtype is the parameters' dtype (cast
    the module with `.to(model_dtype(cfg))`)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.has_image_control:
            refuse_vector(cfg, "DUAL_CONTROL")
        if cfg.has_pose and cfg.pose_control.adm_in_channels != cfg.unet.adm_in_channels:
            raise ValueError(f"pose_control.adm_in_channels {cfg.pose_control.adm_in_channels} "
                             f"!= unet.adm_in_channels {cfg.unet.adm_in_channels}")
        self.cfg = cfg
        self.unet = UNet(cfg.unet)
        if cfg.has_appearance:
            self.appearance_unet = UNet(appearance_unet_config(cfg))
        if cfg.has_pose:
            self.pose_control = PoseControlNet(cfg.pose_control,
                                               in_channels=cfg.unet.in_channels)
        if cfg.has_image_control:
            # the second ControlNet (image hint); None -> the pose branch's
            # architecture
            self.image_control_model = PoseControlNet(cfg.image_control or cfg.pose_control,
                                                      in_channels=cfg.unet.in_channels)
        for net in (self.unet, getattr(self, "appearance_unet", None),
                    getattr(self, "pose_control", None),
                    getattr(self, "image_control_model", None)):
            if net is not None:
                net.compute_dtype = model_dtype(cfg)

    def compute_bank(self, reference_noisy: torch.Tensor, timesteps: torch.Tensor,
                     context: torch.Tensor, y: Optional[torch.Tensor] = None) -> Bank:
        """Appearance UNet in write mode; its eps output is discarded."""
        with span("md.pass.bank_write"):
            _, bank = self.appearance_unet(reference_noisy, timesteps, context, y=y,
                                           collect_bank=True)
        return bank

    def compute_pose_residuals(self, x_noisy: torch.Tensor, pose_hint: torch.Tensor,
                               timesteps: torch.Tensor, context: torch.Tensor,
                               self_kv_pool: int = 1, self_kv_min_seq: int = 4096,
                               y: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, ...]:
        """The pose branch alone: its residuals (13 at SD1.5 width)."""
        return self.pose_control(x_noisy, pose_hint, timesteps, context,
                                 self_kv_pool, self_kv_min_seq, y=y)

    def compute_control_residuals(self, x_noisy: torch.Tensor,
                                  pose_hint: Optional[torch.Tensor],
                                  timesteps: torch.Tensor,
                                  context: torch.Tensor, self_kv_pool: int = 1,
                                  self_kv_min_seq: int = 4096,
                                  image_hint: Optional[torch.Tensor] = None,
                                  y: Optional[torch.Tensor] = None
                                  ) -> Optional[Tuple[torch.Tensor, ...]]:
        """Every residual branch summed position by position: the pose
        ControlNet's 13 residuals plus, under DUAL_CONTROL with an
        `image_hint`, the image ControlNet's; None without a branch or hint.
        The sum is the quantity the turbo sampler caches, so reuse keeps
        both branches."""
        res = None
        with span("md.pass.controlnet"):
            if self.cfg.has_pose and pose_hint is not None:
                res = self.compute_pose_residuals(x_noisy, pose_hint, timesteps, context,
                                                  self_kv_pool, self_kv_min_seq, y=y)
            if self.cfg.has_image_control and image_hint is not None:
                ir = self.image_control_model(x_noisy, image_hint, timesteps, context,
                                              self_kv_pool, self_kv_min_seq)
                res = ir if res is None else tuple(a + b for a, b in zip(res, ir))
        return res

    def forward(self, x_noisy: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor, *,
                y: Optional[torch.Tensor] = None,
                reference_noisy: Optional[torch.Tensor] = None,
                pose_hint: Optional[torch.Tensor] = None,
                image_hint: Optional[torch.Tensor] = None,
                bank: Optional[Bank] = None, uc: bool = False,
                num_frames: int = 1,
                concat_cond: Optional[torch.Tensor] = None,
                pose_residuals: Optional[Tuple[torch.Tensor, ...]] = None,
                collect_deep: bool = False,
                deep_cache_in: Optional[torch.Tensor] = None,
                deep_level: int = 0,
                self_kv_pool: int = 1, self_kv_min_seq: int = 4096):
        """eps prediction (B, h, w, 4) fp32. Pass `reference_noisy` (bank
        computed inline: the training path, one reference per sample, per
        clip, or one for every frame) or a precomputed `bank`; `uc=True` is
        the CFG uncond vanilla-SD pass. `y` (B, adm_in_channels): the added
        vector of an SDXL configuration, given to every pass. `num_frames`:
        frames per clip for the motion modules. `image_hint` (B, H, W, 3): the DUAL_CONTROL image
        ControlNet's hint. `concat_cond` (B, h, w, C'): channels concatenated
        onto x_noisy. `pose_residuals`, if given, replace every control
        branch (the turbo cache holds their sum); `collect_deep` /
        `deep_cache_in` / `deep_level` are the UNet's DeepCache arguments
        (with collect_deep the return is (eps, deep feature)); `self_kv_pool`
        / `self_kv_min_seq` pool the self keys/values of the main UNet and the
        ControlNets."""
        deep_kw = dict(collect_deep=collect_deep, deep_cache_in=deep_cache_in,
                       deep_level=deep_level, self_kv_pool=self_kv_pool,
                       self_kv_min_seq=self_kv_min_seq)
        if concat_cond is not None:
            x_noisy = torch.cat([x_noisy, concat_cond.to(x_noisy.dtype)], dim=-1)
        if uc:
            with span("md.pass.unet_uncond"):
                res = self.unet(x_noisy, timesteps, context, y=y, num_frames=num_frames,
                                **deep_kw)
            return (res[0], res[2]) if collect_deep else res[0]
        b = x_noisy.shape[0]
        if bank is not None and len(bank) and bank[0].shape[0] not in (1, b):
            bank = _repeat_bank(bank, b)
        if bank is None and self.cfg.has_appearance and reference_noisy is not None:
            # the reference branch uses the same timestep trajectory as the
            # main latent; with fewer references than samples, reference i
            # takes the timestep and context of its stride (magicpose.py:210-226)
            n = reference_noisy.shape[0]
            t_ref = timesteps
            if n != timesteps.shape[0]:
                t_ref = timesteps[::timesteps.shape[0] // n]
            ctx_ref, y_ref = context, y
            if context.shape[0] != n:
                ctx_ref = context[::max(1, context.shape[0] // n)][:n]
            if y is not None and y.shape[0] != n:
                y_ref = y[::max(1, y.shape[0] // n)][:n]
            bank = self.compute_bank(reference_noisy, t_ref, ctx_ref, y_ref)
            if bank[0].shape[0] not in (1, b):
                bank = _repeat_bank(bank, b)
        if pose_residuals is None:
            pose_residuals = self.compute_control_residuals(
                x_noisy, pose_hint, timesteps, context, self_kv_pool, self_kv_min_seq,
                image_hint=image_hint, y=y)
        with span("md.pass.unet_cond"):
            res = self.unet(x_noisy, timesteps, context, y=y, bank=bank,
                            pose_residuals=pose_residuals, num_frames=num_frames, **deep_kw)
        return (res[0], res[2]) if collect_deep else res[0]

    def cfg_fused_eps(self, x_noisy: torch.Tensor, timesteps: torch.Tensor,
                      context: torch.Tensor, uncond_context: torch.Tensor, *,
                      bank: Optional[Bank] = None,
                      pose_hint: Optional[torch.Tensor] = None,
                      image_hint: Optional[torch.Tensor] = None,
                      num_frames: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fused classifier-free guidance: the cond and uncond passes as one
        UNet forward over 2B rows. Uncond rows read the bank through a gate
        of 0 (exactly plain self-attention) and get zero control residuals:
        the `controlnet_important` uncond pass, whatever `control_mode` asks for
        (as in JAX). Returns (eps_cond, eps_uncond), each (B, h, w, 4)."""
        refuse_vector(self.cfg, "fused CFG")
        b = x_noisy.shape[0]
        xx = torch.cat([x_noisy, x_noisy])
        tt = torch.cat([timesteps, timesteps])
        cc = torch.cat([context.expand(b, *context.shape[1:]),
                        uncond_context.expand(b, *uncond_context.shape[1:])])
        mask = torch.cat([torch.ones(b), torch.zeros(b)]).to(x_noisy.device)
        residuals = self.compute_control_residuals(x_noisy, pose_hint, timesteps, context,
                                                   image_hint=image_hint)
        if residuals is not None:
            residuals = tuple(torch.cat([r, torch.zeros_like(r)]) for r in residuals)
        with span("md.pass.unet_fused"):
            if bank is not None and self.cfg.has_appearance:
                out = self.unet(xx, tt, cc, bank=bank, bank_mask=mask,
                                pose_residuals=residuals, num_frames=num_frames)[0]
            else:
                out = self.unet(xx, tt, cc, pose_residuals=residuals,
                                num_frames=num_frames)[0]
        return out[:b], out[b:]
