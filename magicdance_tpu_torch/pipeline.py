"""Inference pipeline: reference image + pose maps -> frames (PyTorch).

Counterpart of `magicdance_tpu.pipeline.MagicPosePipeline` on one device:
CLIP-encode the (empty) prompt once, VAE-encode the reference once
(posterior mode), denoise the pose frames of a request with the DDIM
sampler under the caller's `SampleConfig` (exact recipe, fused CFG or any
turbo lever), decode in chunks of 8. Images: all frames are one batch. Video
(`video=True` on the temporal variant): the overlap-window sampler
(`sampling.overlap`), windows of `scfg.window` frames `scfg.stride` apart;
a temporal model asked for images samples them with one frame per clip.
Runs on the GPU unless the caller passes device="cpu"; the denoiser runs in
`cfg.dtype`, VAE in
`cfg.vae.compute_dtype`, CLIP in fp32. The pipeline owns that precision:
every public call runs its fp32 work in full fp32 (TF32 off in cuBLAS and
cuDNN for the call, whatever the process-wide flags say), as the JAX
package's fp32 reference computes it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from magicdance_tpu_torch.config import ModelConfig, SampleConfig
from magicdance_tpu_torch.data.tokenizer import CLIPTokenizer, empty_prompt_ids
from magicdance_tpu_torch.device import full_fp32, resolve_device
from magicdance_tpu_torch.models import AutoencoderKL, CLIPTextEncoder, MagicPoseModel
from magicdance_tpu_torch.models.magicpose import model_dtype
from magicdance_tpu_torch.models.vae import encode_to_latent, latent_to_decoder_input
from magicdance_tpu_torch.ops.schedules import make_ddim_schedule, make_schedule
from magicdance_tpu_torch.sampling.ddim import ddim_sample
from magicdance_tpu_torch.sampling.overlap import ddim_sample_video

DECODE_CHUNK = 8


class MagicPosePipeline:
    """The denoiser, VAE and CLIP behind a sampling API."""

    def __init__(self, cfg: ModelConfig, device: Union[str, torch.device] = "cuda",
                 tokenizer: Optional[CLIPTokenizer] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        vae_dtype = torch.bfloat16 if cfg.vae.compute_dtype == "bfloat16" else torch.float32
        self.model = MagicPoseModel(cfg).to(self.device, model_dtype(cfg))
        self.vae = AutoencoderKL(cfg.vae).to(self.device, vae_dtype)
        self.clip = CLIPTextEncoder(cfg.clip).to(self.device)
        for m in (self.model, self.vae, self.clip):
            m.eval().requires_grad_(False)
        self.sched = make_schedule(cfg.diffusion)
        self.tokenizer = tokenizer or CLIPTokenizer()

    # -- initialization ----------------------------------------------------
    @torch.no_grad()
    def init_params(self, seed: int = 0, scale: float = 0.02) -> None:
        """Seeded random weights for tests and smoke runs: EVERY leaf, the
        zero-initialised output convs and zero convs included, is drawn from
        N(0, scale^2) on the pipeline's device (as the JAX package's
        `fast_init_params`). Real runs load converted checkpoints."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for m in (self.model, self.vae, self.clip):
            for p in m.parameters():
                p.copy_(torch.randn(p.shape, generator=gen, device=self.device) * scale)

    def load_state_dicts(self, states) -> None:
        """{"model", "vae", "clip"} state dicts, e.g. a reference checkpoint
        through `convert.torch_convert.convert_magicpose_state`; strict: a
        network without weights, a missing or an unexpected key raises,
        so nothing stays random. Each value is cast to its parameter's dtype
        (the denoiser's is `model_dtype(cfg)`, bf16 by default)."""
        from magicdance_tpu_torch.convert.torch_convert import load_strict

        lacking = [name for name in ("model", "vae", "clip") if name not in states]
        if lacking:
            raise KeyError(f"no weights for {lacking}: the checkpoint lacks them; supply a "
                           "full model_state/.ckpt file")
        for name in ("model", "vae", "clip"):
            load_strict(getattr(self, name), states[name], name)

    def load_jax_params(self, params) -> None:
        """The JAX pipeline's {"model", "vae", "clip"} tree (numpy leaves)."""
        from magicdance_tpu_torch.convert.from_jax import load_flax_params

        for name in ("model", "vae", "clip"):
            load_flax_params(getattr(self, name), params[name])

    # -- encoders ----------------------------------------------------------
    @torch.inference_mode()
    @full_fp32()
    def encode_text(self, prompts: list[str]) -> torch.Tensor:
        ids = self.tokenizer(prompts, self.cfg.clip.max_length)
        return self.clip(torch.from_numpy(ids).to(self.device))

    @torch.inference_mode()
    @full_fp32()
    def encode_empty(self, batch: int = 1) -> torch.Tensor:
        ids = empty_prompt_ids(batch, self.cfg.clip.max_length)
        return self.clip(torch.from_numpy(ids).to(self.device))

    @torch.inference_mode()
    @full_fp32()
    def encode_reference(self, image: torch.Tensor) -> torch.Tensor:
        """image: (1, H, W, 3) in [-1, 1] -> scaled latent (1, H/8, W/8, 4),
        from the posterior mode."""
        post = self.vae.encode(image.to(self.device))
        return encode_to_latent(post.mode(), self.cfg.vae.scale_factor)

    @torch.inference_mode()
    @full_fp32()
    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """(F, h, w, 4) latents -> (F, 8h, 8w, 3) fp32 images, decoded in
        chunks of 8 frames."""
        z = latent_to_decoder_input(latents.to(self.device), self.cfg.vae.scale_factor)
        return torch.cat([self.vae.decode(c).float()
                          for c in torch.split(z, DECODE_CHUNK)], dim=0)

    # -- sampling ----------------------------------------------------------
    @torch.inference_mode()
    @full_fp32()
    def sample_frames(
        self,
        pose_maps: Optional[torch.Tensor],
        reference_image: Optional[torch.Tensor],
        scfg: SampleConfig = SampleConfig(),
        prompts: Optional[list[str]] = None,
        decode: bool = True,
        video: bool = False,
        x_T: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        window_offsets: Optional[Sequence[int]] = None,
        image_hints: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """pose_maps: (F, H, W, 3) in [0, 1] or None; reference_image:
        (1, H, W, 3) in [-1, 1] or None; image_hints: (F, H, W, 3) in [0, 1],
        the second ControlNet's hints (DUAL_CONTROL variant), or None.
        Returns (F, H, W, 3) images in [-1, 1] (or (F, H/8, W/8, 4) latents
        with decode=False).

        x_T: optional (F, h, w, 4) initial noise; otherwise it is drawn from
        `generator` (a torch.Generator on the pipeline's device), one draw
        shared by every frame when scfg.shared_noise. `video=True` on the
        temporal variant samples through the overlap windows, whose per-step
        cyclic offsets are `window_offsets` or drawn from `generator`; on
        any other variant it samples images, as in JAX."""
        cfg = self.cfg
        video = video and cfg.has_temporal
        if image_hints is not None:
            image_hints = image_hints.to(self.device)
        if pose_maps is not None:
            F, H = pose_maps.shape[0], pose_maps.shape[1]
            pose_maps = pose_maps.to(self.device)
        else:
            F, H = 1, cfg.latent_size * 8
        latent = H // 8
        ctx = self.encode_text(prompts) if prompts else self.encode_empty(1)
        uctx = self.encode_empty(1)
        use_ref = reference_image is not None and cfg.has_appearance
        ref_latent = self.encode_reference(reference_image) if use_ref else None
        if x_T is None:
            shape = (1 if scfg.shared_noise else F, latent, latent, 4)
            x_T = torch.randn(shape, generator=generator, device=self.device)
            x_T = x_T.expand(F, latent, latent, 4)
        x_T = x_T.to(self.device, torch.float32).contiguous()
        ddim = make_ddim_schedule(self.sched, scfg.steps, eta=scfg.eta)
        kw = dict(reference_latent=ref_latent, pose_hint=pose_maps, image_hint=image_hints,
                  parameterization=cfg.diffusion.parameterization, generator=generator)
        if video:
            lat = ddim_sample_video(self.model, self.sched, ddim, scfg, x_T, ctx, uctx,
                                    window_offsets=window_offsets, **kw)
        else:
            lat = ddim_sample(self.model, self.sched, ddim, scfg, x_T, ctx, uctx, **kw)
        return self.decode_latents(lat) if decode else lat
