"""FID feature extraction + distance (PyTorch).

Counterpart of `magicdance_tpu.metrics.fid`, mirroring the vendored
clean-fid pipeline (ref: tool/cleanfid/fid.py -- torchscript InceptionV3
(pt_inception-2015-12-05) pool3 features, bicubic resize to 299, features ->
Frechet distance). The Inception weights are a local file (none can be
fetched):

  * a torchvision `inception_v3` state dict -- through the port's own
    InceptionV3 (metrics/inception.py), first;
  * else a TorchScript file (the clean-fid `.pt`, 1008-wide logits), or a
    torchvision state dict into torchvision's module when torchvision is
    installed.

Every extractor runs on `device` (the GPU unless the caller asks for the
CPU), in full fp32.
"""

from __future__ import annotations

import os
from typing import Union

import numpy as np
import torch
from PIL import Image

from magicdance_tpu_torch.device import full_fp32, resolve_device


def _load_extractor(weights_path: str, device: torch.device):
    try:
        m = torch.jit.load(weights_path, map_location="cpu").eval()
        return ("torchscript", m.to(device))
    except Exception:
        pass
    try:
        from torchvision.models import inception_v3
    except ImportError as e:
        raise ValueError(
            f"{weights_path} is not a TorchScript file and torchvision is "
            "not installed; supply the clean-fid TorchScript InceptionV3 "
            "(pt_inception-2015-12-05.pt) or a torchvision state dict with "
            "torchvision available"
        ) from e

    m = inception_v3(weights=None, aux_logits=True, init_weights=False)
    sd = torch.load(weights_path, map_location="cpu")
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    m.load_state_dict(sd)
    m.fc = torch.nn.Identity()
    m.eval()
    return ("torchvision", m.to(device))


def _image_batches(folder: str, batch: int, size: int, max_images: int = 0):
    """Yield (B, size, size, 3) float32 batches in 0-255 (bicubic resize --
    the clean-fid convention). max_images>0 keeps only the FIRST N frames --
    the reference's FID-Img frame sampling (ref tool/metrics/utils.py:
    251-254 `frame_ids[:sample_frames]`)."""
    files = sorted(
        f for f in os.listdir(folder)
        if f.lower().endswith((".png", ".jpg", ".jpeg"))
    )
    if max_images:
        files = files[:max_images]
    for i in range(0, len(files), batch):
        imgs = []
        for f in files[i : i + batch]:
            img = Image.open(os.path.join(folder, f)).convert("RGB")
            imgs.append(np.asarray(img.resize((size, size), Image.BICUBIC),
                                   np.float32))
        yield np.stack(imgs)


_BACKEND_CACHE: dict = {}


def _get_backend(weights_path: str, device: torch.device):
    """Resolve + cache the extractor backend for a weights file: the port's
    InceptionV3 for torchvision-layout state dicts, TorchScript (or
    torchvision's module) otherwise, on `device`. Cached per (path, device)
    -- multi-folder drivers (FID across sequences, IS) must not re-load per
    folder."""
    key = (weights_path, str(device))
    if key in _BACKEND_CACHE:
        return _BACKEND_CACHE[key]
    try:
        from magicdance_tpu_torch.metrics.inception import InceptionExtractor

        backend = ("inception", InceptionExtractor(weights_path, device))
    except (KeyError, ValueError):
        backend = _load_extractor(weights_path, device)
    _BACKEND_CACHE[key] = backend
    return backend


def _folder_inception(folder, weights_path, batch, size, want,
                      max_images: int = 0, device: Union[str, torch.device] = "cuda"):
    """Shared driver for folder_features / folder_logits. `want` is "pool"
    or "logits". A folder with no images returns shape (0, 0) -- callers
    aggregating folders must skip empties (the logits width depends on the
    backend: 1000 for torchvision layouts, 1008 for the clean-fid
    TorchScript TF-Inception port)."""
    device = resolve_device(device)
    kind, model = _get_backend(weights_path, device)
    if kind == "inception":
        out = []
        for x in _image_batches(folder, batch, size, max_images):
            pool, logits = model(x / 255.0)
            out.append(pool if want == "pool" else logits)
        return np.concatenate(out) if out else np.zeros((0, 0), np.float32)

    if want == "logits" and kind != "torchscript":
        # the torchvision fallback strips fc for features -- pre-fc
        # activations are NOT logits; refuse rather than mis-score
        raise ValueError(
            "inception score needs class logits: supply the clean-fid "
            "TorchScript InceptionV3 or a torchvision-layout state dict "
            "(the port's InceptionV3)")
    out = []
    with torch.inference_mode(), full_fp32():
        for x in _image_batches(folder, batch, size, max_images):
            t = torch.from_numpy(x).permute(0, 3, 1, 2).to(device)
            if kind == "torchscript":
                # clean-fid script: uint8-range input; return_features=True
                # -> pool3, without the flag -> logits
                y = (model(t, return_features=True) if want == "pool"
                     else model(t))
            else:
                y = model(t / 127.5 - 1.0)
                if isinstance(y, tuple):
                    y = y[0]
            out.append(y.cpu().numpy().reshape(len(x), -1))
    return np.concatenate(out) if out else np.zeros((0, 0), np.float32)


def folder_features(
    folder: str, weights_path: str, batch: int = 32, size: int = 299,
    max_images: int = 0, device: Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """Pool3/2048-dim features for every image in a folder. max_images>0
    keeps only the first N frames (FID-Img sampling)."""
    return _folder_inception(folder, weights_path, batch, size, "pool",
                             max_images, device)


def folder_logits(
    folder: str, weights_path: str, batch: int = 32, size: int = 299,
    device: Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """Class logits (N, C) for every image in a folder -- the inception
    score input (ref tool/metrics/utils.py:517-531 'clean_InceptionScore').
    C is backend-dependent (1000 torchvision / 1008 clean-fid TF port)."""
    return _folder_inception(folder, weights_path, batch, size, "logits",
                             device=device)


def fid_between_folders(
    gen_dir: str, gt_dir: str, weights_path: str,
    device: Union[str, torch.device] = "cuda",
) -> float:
    from magicdance_tpu_torch.metrics.core import (
        frechet_distance,
        gaussian_frechet_stats,
    )

    f1 = folder_features(gen_dir, weights_path, device=device)
    f2 = folder_features(gt_dir, weights_path, device=device)
    mu1, s1 = gaussian_frechet_stats(f1)
    mu2, s2 = gaussian_frechet_stats(f2)
    return frechet_distance(mu1, s1, mu2, s2)
