"""Inference pipeline: reference image + pose maps -> frames (PyTorch).

Counterpart of `magicdance_tpu.pipeline.MagicPosePipeline`:
CLIP-encode the (empty) prompt once, VAE-encode the reference once
(posterior mode), denoise the pose frames of a request with the DDIM
sampler under the caller's `SampleConfig` (exact recipe, fused CFG or any
turbo lever), decode in chunks of 8. Images: all frames are one batch. Video
(`video=True` on the temporal variant): the overlap-window sampler
(`sampling.overlap`), windows of `scfg.window` frames `scfg.stride` apart;
a temporal model asked for images samples them with one frame per clip.
With a `mesh` (its 'data' axis) a request is served across ranks: the
images' frames split over the ranks (frame-parallel), the video's windows
per step (window-parallel, `sampling.overlap`), and every rank returns the
whole result.
An SDXL configuration (`ModelConfig.clip_g`, `adm_in_channels`) encodes
its prompts with both towers (`models.clip.DualCLIPTextEncoder`: the context
and the pooled embedding) and builds each request's added vector from the
pooled embedding and the request's image size (`added_vector`), which the
sampler hands to every pass; the uncond pass takes the empty prompt's
context and vector, as the SD1.5 recipe's ("controlnet_important"), not
the zeroed negative embeddings of diffusers' SDXL pipeline.
Runs on the GPU unless the caller passes device="cpu"; the denoiser runs in
`cfg.dtype`, VAE in
`cfg.vae.compute_dtype`, CLIP in fp32. The pipeline owns that precision:
every public call runs its fp32 work in full fp32 (TF32 off in cuBLAS and
cuDNN for the call, whatever the process-wide flags say), as the JAX
package's fp32 reference computes it.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence, Union

import torch

from magicdance_tpu_torch.config import ModelConfig, SampleConfig
from magicdance_tpu_torch.data.tokenizer import CLIPTokenizer, empty_prompt_ids
from magicdance_tpu_torch.device import full_fp32, resolve_device
from magicdance_tpu_torch.models import AutoencoderKL, CLIPTextEncoder, MagicPoseModel
from magicdance_tpu_torch.models.clip import DualCLIPTextEncoder
from magicdance_tpu_torch.models.magicpose import model_dtype
from magicdance_tpu_torch.models.vae import encode_to_latent, latent_to_decoder_input
from magicdance_tpu_torch.ops.schedules import (
    make_ddim_schedule,
    make_schedule,
    timestep_embedding,
)
from magicdance_tpu_torch.parallel.mesh import as_axis
from magicdance_tpu_torch.sampling.ddim import ddim_sample
from magicdance_tpu_torch.sampling.overlap import ddim_sample_video
from magicdance_tpu_torch.utils.profiling import span

DECODE_CHUNK = 8
# width of each size sinusoid of SDXL's added vector (sd_xl_base.yaml's
# ConcatTimestepEmbedderND outdim)
SIZE_EMBED_DIM = 256


def added_vector(pooled: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """SDXL's added vector (B, P + 6 x 256) fp32, in the order of
    sd_xl_base.yaml's embedders: the pooled text embedding (B, P), then
    256-wide sinusoids of original_size (height, width),
    crop_coords_top_left (0, 0) and target_size (height, width)."""
    sizes = torch.tensor([height, width, 0, 0, height, width], dtype=torch.float32,
                         device=pooled.device)
    emb = timestep_embedding(sizes, SIZE_EMBED_DIM).reshape(1, -1)
    return torch.cat([pooled.float(), emb.expand(pooled.shape[0], -1)], dim=1)


class MagicPosePipeline:
    """The denoiser, VAE and CLIP behind a sampling API."""

    def __init__(self, cfg: ModelConfig, device: Union[str, torch.device] = "cuda",
                 tokenizer: Optional[CLIPTokenizer] = None):
        if (cfg.clip_g is not None) != cfg.has_vector:
            raise ValueError("a second text tower (clip_g) and an added vector "
                             "(unet.adm_in_channels) come together")
        self.cfg = cfg
        self.device = resolve_device(device)
        vae_dtype = torch.bfloat16 if cfg.vae.compute_dtype == "bfloat16" else torch.float32
        with self.device:  # built where it runs: no host-side default init
            self.model = MagicPoseModel(cfg).to(self.device, model_dtype(cfg))
            self.vae = AutoencoderKL(cfg.vae).to(self.device, vae_dtype)
            self.clip = (DualCLIPTextEncoder(cfg.clip, cfg.clip_g) if cfg.clip_g is not None
                         else CLIPTextEncoder(cfg.clip)).to(self.device)
        for m in (self.model, self.vae, self.clip):
            m.eval().requires_grad_(False)
        self.sched = make_schedule(cfg.diffusion)
        self.tokenizer = tokenizer or CLIPTokenizer()
        self._request_ids = itertools.count()  # the index an `md.request` span carries

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
    # encode_text / encode_empty give the context (B, 77, context_dim), or
    # with two towers (SDXL) the pair (context, pooled embedding)
    @torch.inference_mode()
    @full_fp32()
    def encode_text(self, prompts: list[str]):
        ids = self.tokenizer(prompts, self.cfg.clip.max_length)
        with span("md.clip"):
            return self.clip(torch.from_numpy(ids).to(self.device))

    @torch.inference_mode()
    @full_fp32()
    def encode_empty(self, batch: int = 1):
        ids = empty_prompt_ids(batch, self.cfg.clip.max_length)
        with span("md.clip"):
            return self.clip(torch.from_numpy(ids).to(self.device))

    @torch.inference_mode()
    @full_fp32()
    def encode_reference(self, image: torch.Tensor) -> torch.Tensor:
        """image: (1, H, W, 3) in [-1, 1] -> scaled latent (1, H/8, W/8, 4),
        from the posterior mode."""
        with span("md.vae.encode"):
            post = self.vae.encode(image.to(self.device))
            return encode_to_latent(post.mode(), self.cfg.vae.scale_factor)

    @torch.inference_mode()
    @full_fp32()
    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """(F, h, w, 4) latents -> (F, 8h, 8w, 3) fp32 images, decoded in
        chunks of 8 frames."""
        z = latent_to_decoder_input(latents.to(self.device), self.cfg.vae.scale_factor)
        images = []
        for c in torch.split(z, DECODE_CHUNK):
            with span("md.vae.decode"):
                images.append(self.vae.decode(c).float())
        return torch.cat(images, dim=0)

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
        mesh=None,
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
        any other variant it samples images, as in JAX.

        mesh: a DeviceMesh with a 'data' axis (JAX `sample_frames(mesh=)`).
        Every rank takes rank 0's x_T (and window offsets). Images: rank r
        samples and decodes its share of the frames (`torch.tensor_split`'s,
        any F) with the batch-1 bank computed by itself; video: the windows
        of each step split over the ranks and the frame-space latents stay
        whole, then the decode splits by frames. An all-gather returns the
        whole (F, ...) result on every rank. The weights are the caller's on
        every rank (the same seed or checkpoint)."""
        with span("md.request", " i={}".format, next(self._request_ids)):
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
            vectors = {}
            if cfg.has_vector:
                (ctx, pooled), (uctx, upooled) = ctx, uctx
                width = pose_maps.shape[2] if pose_maps is not None else H
                with span("md.cond.vector"):
                    vectors = dict(y=added_vector(pooled, H, width),
                                   uncond_y=added_vector(upooled, H, width))
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
            axis = as_axis(mesh)
            axis.broadcast(x_T)
            f0, f1 = axis.rows(F)
            if video:
                lat = ddim_sample_video(self.model, self.sched, ddim, scfg, x_T, ctx, uctx,
                                        window_offsets=window_offsets, window_sharding=axis,
                                        **kw)[f0:f1]
            else:
                share = {k: (v[f0:f1] if k in ("pose_hint", "image_hint") and v is not None else v)
                         for k, v in kw.items()}
                lat = (ddim_sample(self.model, self.sched, ddim, scfg, x_T[f0:f1], ctx, uctx,
                                   rows=(f0, F), **share, **vectors) if f1 > f0 else x_T[f0:f1])
            if decode:
                up = 2 ** (len(cfg.vae.channel_mult) - 1)
                lat = (self.decode_latents(lat) if f1 > f0
                       else lat.new_zeros((0, up * lat.shape[1], up * lat.shape[2], 3)))
            return axis.gather_rows(lat, F)
