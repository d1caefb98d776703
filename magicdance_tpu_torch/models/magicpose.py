"""MagicPose composed denoiser: main UNet + appearance UNet + pose ControlNet.

Counterpart of `magicdance_tpu.models.magicpose.MagicPoseModel` for the image
path: the appearance branch is a second UNet run on the reference latent in
bank-write mode; the pose branch returns the 13 ControlNet residuals; the CFG
uncond pass (`uc=True`) is a vanilla SD forward that skips both branches.
VAE and CLIP live outside (applied once per request).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from magicdance_tpu_torch.config import ModelConfig, UNetConfig
from magicdance_tpu_torch.models.controlnet import PoseControlNet
from magicdance_tpu_torch.models.unet import Bank, UNet


def appearance_unet_config(cfg: ModelConfig) -> UNetConfig:
    """The appearance branch shares the UNet architecture, never with motion
    modules."""
    u = cfg.unet
    return UNetConfig(
        in_channels=u.in_channels, out_channels=u.out_channels,
        model_channels=u.model_channels, channel_mult=u.channel_mult,
        num_res_blocks=u.num_res_blocks,
        attention_resolutions=u.attention_resolutions, num_heads=u.num_heads,
        transformer_depth=u.transformer_depth, context_dim=u.context_dim,
        dropout=u.dropout, use_motion_modules=False, remat=u.remat,
    )


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class MagicPoseModel(nn.Module):
    """The per-step hot path. Compute dtype is the parameters' dtype (cast
    the module with `.to(model_dtype(cfg))`)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.has_image_control:
            raise NotImplementedError("the image-control branch is not ported yet")
        self.cfg = cfg
        self.unet = UNet(cfg.unet)
        if cfg.has_appearance:
            self.appearance_unet = UNet(appearance_unet_config(cfg))
        if cfg.has_pose:
            self.pose_control = PoseControlNet(cfg.pose_control,
                                               in_channels=cfg.unet.in_channels)

    def compute_bank(self, reference_noisy: torch.Tensor, timesteps: torch.Tensor,
                     context: torch.Tensor) -> Bank:
        """Appearance UNet in write mode; its eps output is discarded."""
        _, bank = self.appearance_unet(reference_noisy, timesteps, context,
                                       collect_bank=True)
        return bank

    def compute_control_residuals(self, x_noisy: torch.Tensor,
                                  pose_hint: Optional[torch.Tensor],
                                  timesteps: torch.Tensor,
                                  context: torch.Tensor) -> Optional[Tuple[torch.Tensor, ...]]:
        """The pose branch's 13 residuals, or None without a pose branch/hint."""
        if self.cfg.has_pose and pose_hint is not None:
            return self.pose_control(x_noisy, pose_hint, timesteps, context)
        return None

    def forward(self, x_noisy: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor, *,
                reference_noisy: Optional[torch.Tensor] = None,
                pose_hint: Optional[torch.Tensor] = None,
                bank: Optional[Bank] = None, uc: bool = False) -> torch.Tensor:
        """eps prediction (B, h, w, 4) fp32. Pass `reference_noisy` (bank
        computed inline) or a precomputed `bank`; `uc=True` is the CFG uncond
        vanilla-SD pass."""
        if uc:
            return self.unet(x_noisy, timesteps, context)[0]
        if bank is None and self.cfg.has_appearance and reference_noisy is not None:
            # one reference for every frame, or one per frame; the reference
            # pass takes the leading timesteps and contexts
            n = reference_noisy.shape[0]
            if n not in (1, x_noisy.shape[0]):
                raise ValueError(f"reference batch {n} is neither 1 nor the "
                                 f"frame batch {x_noisy.shape[0]}")
            bank = self.compute_bank(reference_noisy, timesteps[:n], context[:n])
        residuals = self.compute_control_residuals(x_noisy, pose_hint, timesteps, context)
        return self.unet(x_noisy, timesteps, context, bank=bank,
                         pose_residuals=residuals)[0]
