"""CLIP image similarity scoring (PyTorch; ref: tool/ClipScore.py:9
CLIPSimilarity -- folder scorer over generated frames).

Counterpart of `magicdance_tpu.metrics.clip_score`: the CLIP ViT-L/14 VISION
tower (its layers are the text tower's `models/clip.py::CLIPLayer`, with a
zero mask), a converter from HF `CLIPModel` state dicts, and a folder-level
scorer with L2-normalised embeddings. Submodules carry the Flax names
(`patch_embedding`, `class_embedding`, `position_embedding`,
`pre_layernorm`, `layer_i`, `post_layernorm`, `visual_projection`).
Weights are local files (none can be fetched); without them the scorer runs
on seeded random weights (scores not comparable).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from magicdance_tpu_torch.config import CLIPTextConfig
from magicdance_tpu_torch.device import full_fp32, resolve_device
from magicdance_tpu_torch.metrics.core import as_tensor, seeded_init
from magicdance_tpu_torch.models.clip import CLIPLayer
from magicdance_tpu_torch.models.layers import Linear

# CLIP normalization constants
_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


class CLIPVisionEncoder(nn.Module):
    """ViT image tower: patch conv -> [CLS]+patches -> pre-LN transformer ->
    post-LN CLS -> projection. `image_size` sizes the position embedding
    (one per patch, plus CLS)."""

    def __init__(self, hidden_size: int = 1024, num_layers: int = 24, num_heads: int = 16,
                 patch_size: int = 14, projection_dim: int = 768, image_size: int = 224):
        super().__init__()
        self.hidden_size, self.num_layers = hidden_size, num_layers
        npos = (image_size // patch_size) ** 2 + 1
        self.patch_embedding = nn.Conv2d(3, hidden_size, patch_size, stride=patch_size,
                                         bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(hidden_size))
        self.position_embedding = nn.Parameter(torch.zeros(npos, hidden_size))
        self.pre_layernorm = nn.LayerNorm(hidden_size, eps=1e-5)
        cfg = CLIPTextConfig(hidden_size=hidden_size, num_heads=num_heads,
                             num_layers=num_layers)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", CLIPLayer(cfg))
        self.post_layernorm = nn.LayerNorm(hidden_size, eps=1e-5)
        self.visual_projection = Linear(hidden_size, projection_dim, bias=False)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels: (B, H, W, 3), CLIP-normalized. Returns projected embeds
        (B, projection_dim), unnormalized."""
        b = pixels.shape[0]
        patches = self.patch_embedding(pixels.permute(0, 3, 1, 2))
        patches = patches.flatten(2).transpose(1, 2)  # (B, h*w, C), row-major
        cls = self.class_embedding.expand(b, 1, self.hidden_size)
        x = torch.cat([cls, patches], dim=1)
        npos = x.shape[1]
        x = x + self.position_embedding[None]
        x = F.layer_norm(x, (self.hidden_size,), self.pre_layernorm.weight,
                         self.pre_layernorm.bias, self.pre_layernorm.eps)
        # the vision tower has no causal mask
        zero_mask = torch.zeros((1, 1, npos, npos), dtype=torch.float32, device=x.device)
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, zero_mask)
        cls_out = F.layer_norm(x[:, 0], (self.hidden_size,), self.post_layernorm.weight,
                               self.post_layernorm.bias, self.post_layernorm.eps)
        return self.visual_projection(cls_out)


def convert_clip_vision(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """HF CLIPModel vision keys -> the port's CLIPVisionEncoder state dict
    (layouts unchanged: both are torch)."""
    p = "vision_model"
    pre = f"{p}.pre_layrnorm" if f"{p}.pre_layrnorm.weight" in sd else f"{p}.pre_layernorm"
    pairs = [
        (f"{p}.embeddings.patch_embedding.weight", "patch_embedding.weight"),
        (f"{p}.embeddings.class_embedding", "class_embedding"),
        (f"{p}.embeddings.position_embedding.weight", "position_embedding"),
        (f"{pre}.weight", "pre_layernorm.weight"),
        (f"{pre}.bias", "pre_layernorm.bias"),
        (f"{p}.post_layernorm.weight", "post_layernorm.weight"),
        (f"{p}.post_layernorm.bias", "post_layernorm.bias"),
        ("visual_projection.weight", "visual_projection.weight"),
    ]
    i = 0
    while f"{p}.encoder.layers.{i}.self_attn.q_proj.weight" in sd:
        lp = f"{p}.encoder.layers.{i}"
        for ref, port in (("self_attn.q_proj", "self_attn.q_proj"),
                          ("self_attn.k_proj", "self_attn.k_proj"),
                          ("self_attn.v_proj", "self_attn.v_proj"),
                          ("self_attn.out_proj", "self_attn.out_proj"),
                          ("layer_norm1", "layer_norm1"), ("layer_norm2", "layer_norm2"),
                          ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
            for leaf in ("weight", "bias"):
                pairs.append((f"{lp}.{ref}.{leaf}", f"layer_{i}.{port}.{leaf}"))
        i += 1
    return {port: as_tensor(sd[ref]) for ref, port in pairs}


def preprocess_clip_image(img: np.ndarray, size: int = 224) -> np.ndarray:
    """uint8 HWC -> CLIP-normalized float (size, size, 3)."""
    from PIL import Image

    pil = Image.fromarray(img.astype(np.uint8)).resize((size, size),
                                                       Image.BICUBIC)
    x = np.asarray(pil, np.float32) / 255.0
    return (x - _MEAN) / _STD


class CLIPScorer:
    """Image-image cosine similarity over folders (ref tool/ClipScore.py),
    on `device` (the GPU unless the caller asks for the CPU), in full fp32
    (the reference runs fp32)."""

    def __init__(self, clip_weights_path: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.vision = CLIPVisionEncoder()
        if clip_weights_path:
            from magicdance_tpu_torch.convert.torch_convert import load_torch_state

            sd = load_torch_state(clip_weights_path)
            self.vision.load_state_dict(convert_clip_vision(sd), strict=True)
            self.calibrated = True
        else:
            seeded_init(self.vision, 0)
            self.calibrated = False
        self.vision.to(self.device).eval().requires_grad_(False)

    @torch.inference_mode()
    def embed_images(self, imgs: np.ndarray) -> np.ndarray:
        with full_fp32():
            x = torch.as_tensor(np.asarray(imgs, np.float32), device=self.device)
            e = self.vision(x).cpu().numpy()
        return e / np.linalg.norm(e, axis=-1, keepdims=True)

    def image_similarity(self, folder_a: str, folder_b: str,
                         batch: int = 16) -> float:
        from magicdance_tpu_torch.metrics.center import paired_batches

        sims = []
        for a, b in paired_batches(folder_a, folder_b, batch):
            ea = self.embed_images(np.stack([preprocess_clip_image(x) for x in a]))
            eb = self.embed_images(np.stack([preprocess_clip_image(x) for x in b]))
            sims.extend((ea * eb).sum(-1).tolist())
        return float(np.mean(sims))
