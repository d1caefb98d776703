"""FVD / FID-VID: video-level Frechet metrics (PyTorch).

Counterpart of `magicdance_tpu.metrics.fvd`, mirroring the DisCo video
metrics (ref: tool/metrics/metric_center.py fvd / fid-vid paths;
tool/metrics/inception3d.py [I3D, FVD], resnet3d.py [3D-ResNet50,
FID-VID]). The pretrained 3D backbones are local files (none can be
fetched):

  * FVD: the public I3D state dict (`i3d_pretrained_400.pt`) -- through the
    port's I3D (metrics/i3d.py);
  * FID-VID: the Kinetics 3D-ResNet50 state dict (`resnet-50-kinetics.pth`)
    -- through the port's ResNet3D (metrics/resnet3d.py);
  * TorchScript files work too.

Every backbone runs on `device` (the GPU unless the caller asks for the
CPU), in full fp32. The Frechet math is shared with image FID
(metrics/core.py). Videos are (T, H, W, 3) uint8 folders or arrays.
Preprocessing and clip handling follow the reference PER BACKBONE (ref
utils.py:294-331, 498-503): I3D = 224^2 [-1,1] whole variable-length
videos; 3D-ResNet = 112^2 pixel-mean-subtracted contiguous 16-frame clips.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Union

import numpy as np
import torch
from PIL import Image

from magicdance_tpu_torch.device import full_fp32, resolve_device
from magicdance_tpu_torch.metrics.i3d import I3D, convert_i3d
from magicdance_tpu_torch.metrics.resnet3d import (
    KINETICS_PIXEL_MEAN,
    ResNet3D,
    convert_resnet3d,
)


def _load_video_model(weights_path: str):
    """Returns ("i3d", state_dict) for a raw I3D state dict (the
    `i3d_pretrained_400.pt` format, ref features.py:42-44), ("r3d",
    state_dict) for the Kinetics 3D-ResNet50 one, or ("torchscript", module)
    for a TorchScript file (on the CPU; the extractor moves it)."""
    sd_error: Optional[Exception] = None
    try:
        obj = torch.load(weights_path, map_location="cpu", weights_only=False)
        if isinstance(obj, dict):
            sd = obj.get("state_dict", obj)
            if any(k.startswith("Conv3d_1a_7x7") for k in sd):
                return "i3d", dict(sd)
            if any(k.removeprefix("module.").startswith("layer1.0.conv1")
                   for k in sd):
                # Kinetics 3D-ResNet50 (resnet-50-kinetics.pth) -> FID-VID
                return "r3d", dict(sd)
            sd_error = ValueError(
                "dict has neither I3D (Conv3d_1a_7x7*) nor 3D-ResNet50 "
                "(layer1.0.conv1*) keys")
    except Exception as e:
        # don't swallow the real failure: a corrupt/truncated state dict
        # would otherwise surface only as a confusing TorchScript error
        sd_error = e
    if sd_error is None:
        sd_error = ValueError("loaded object is not a state-dict mapping")
    try:
        m = torch.jit.load(weights_path, map_location="cpu").eval()
        return "torchscript", m
    except Exception as e:
        raise ValueError(
            f"could not load video backbone from {weights_path}: "
            f"state-dict path failed with [{type(sd_error).__name__}: "
            f"{sd_error}]; TorchScript path failed with "
            f"[{type(e).__name__}: {e}]. Provide the I3D state dict "
            "(i3d_pretrained_400.pt), the Kinetics 3D-ResNet50 state dict "
            "(resnet-50-kinetics.pth), or a TorchScript I3D/3D-ResNet file"
        )


def load_video_frames(folder: str, size: int = 224) -> np.ndarray:
    frames = []
    for f in sorted(os.listdir(folder)):
        if not f.lower().endswith((".png", ".jpg", ".jpeg")):
            continue
        img = Image.open(os.path.join(folder, f)).convert("RGB")
        frames.append(np.asarray(img.resize((size, size), Image.BILINEAR)))
    return np.stack(frames) if frames else np.zeros((0, size, size, 3), np.uint8)


def segment_clips(video: np.ndarray, length: int) -> list[np.ndarray]:
    """Split a (T, H, W, 3) video into ceil(T/length) contiguous clips,
    padding the tail by repeating the last frame (the reference FID-VID
    convention, ref utils.py:310-319)."""
    t = video.shape[0]
    if t == 0:
        return [np.zeros((length,) + video.shape[1:], video.dtype)]
    pad = (-t) % length
    if pad:
        video = np.concatenate([video, np.repeat(video[-1:], pad, axis=0)])
    return list(video.reshape(-1, length, *video.shape[1:]))


class VideoFeatureExtractor:
    """Backbone-aware video feature extractor (built ONCE per weights file)
    on `device` (the GPU unless the caller asks for the CPU).

    Conventions follow the reference per BACKBONE, not per engine
    (ref utils.py:294-331, 498-503):

      * ``backbone="i3d"`` (FVD): 224^2 frames, [-1, 1] pixels, the WHOLE
        variable-length video is one sample (the reference's
        FVD-3DInception mode feeds the full video). Videos are grouped by
        length; videos shorter than 10 frames are tail-padded (I3D's
        temporal strides need >= 10).
      * ``backbone="r3d"`` (FID-VID): 112^2 frames, Kinetics pixel-mean
        subtraction, contiguous 16-frame clips with last-frame tail padding
        -- one feature per CLIP.

    ``backbone=None`` infers from the weights (i3d/r3d state-dict layouts);
    a TorchScript file cannot be sniffed, so pass it explicitly there
    (the metrics CLI does: fvd->i3d, fid-vid->r3d).
    """

    MIN_I3D_LEN = 10

    def __init__(self, weights_path: str, backbone: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        engine, model = _load_video_model(weights_path)
        if backbone is None:
            backbone = "r3d" if engine == "r3d" else "i3d"
        assert backbone in ("i3d", "r3d"), backbone
        self.engine, self.backbone = engine, backbone
        self.size = 112 if backbone == "r3d" else 224
        self._torchscript = engine == "torchscript"
        if engine == "i3d":
            net = I3D()
            net.load_state_dict(convert_i3d(model), strict=True)
        elif engine == "r3d":
            net = ResNet3D()
            net.load_state_dict(convert_resnet3d(model), strict=True)
        else:
            net = model
        self.model = net.to(self.device).eval()
        if not self._torchscript:
            self.model.requires_grad_(False)

    def _preprocess(self, x: np.ndarray) -> np.ndarray:
        # x: (B, T, H, W, 3) float32 in 0-255
        if self.backbone == "i3d":
            return x / 127.5 - 1.0  # ref utils.py:501-503
        return x - np.asarray(KINETICS_PIXEL_MEAN, np.float32)

    def _run(self, clips: list[np.ndarray]) -> np.ndarray:
        x = self._preprocess(np.stack(clips).astype(np.float32))
        t = torch.from_numpy(x).to(self.device)
        if self._torchscript:
            t = t.permute(0, 4, 1, 2, 3)
        with torch.inference_mode(), full_fp32():
            out = self.model(t).cpu().numpy()
        return out.reshape(len(clips), -1)

    def __call__(
        self, videos: Iterable[np.ndarray], clip_len: int = 16,
        batch: int = 2,
    ) -> np.ndarray:
        feats = []
        if self.backbone == "r3d":
            buf: list[np.ndarray] = []
            for v in videos:
                buf.extend(segment_clips(v, clip_len))
                while len(buf) >= batch:  # fixed-size flushes
                    feats.append(self._run(buf[:batch]))
                    buf = buf[batch:]
            if buf:
                feats.append(self._run(buf))
            return (np.concatenate(feats) if feats
                    else np.zeros((0, 2048), np.float32))
        # i3d: whole video = one sample; batch videos of one length
        by_len: dict[int, list[np.ndarray]] = {}
        for v in videos:
            t = v.shape[0]
            if t == 0:
                v = np.zeros((self.MIN_I3D_LEN,) + v.shape[1:], v.dtype)
            elif t < self.MIN_I3D_LEN:
                v = np.concatenate(
                    [v, np.repeat(v[-1:], self.MIN_I3D_LEN - t, axis=0)])
            group = by_len.setdefault(v.shape[0], [])
            group.append(v)
            if len(group) >= batch:
                feats.append(self._run(group))
                by_len[v.shape[0]] = []
        for group in by_len.values():
            if group:
                feats.append(self._run(group))
        return (np.concatenate(feats) if feats
                else np.zeros((0, 400), np.float32))


def video_features(
    videos: Iterable[np.ndarray],
    weights_path: str,
    clip_len: int = 16,
    batch: int = 2,
    backbone: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """Features per sample (whole video for I3D, 16-frame clip for the
    3D-ResNet); each input video (T, H, W, 3) uint8. Convenience wrapper --
    for repeated calls build one `VideoFeatureExtractor`."""
    return VideoFeatureExtractor(weights_path, backbone, device)(
        videos, clip_len, batch)


def frechet_video_distance(
    gen_dirs: list[str],
    gt_dirs: list[str],
    weights_path: str,
    clip_len: int = 16,
    backbone: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
) -> float:
    """Frechet distance between the video features of two lists of frame
    folders. Frame size, preprocessing and clip handling follow the
    backbone (ref utils.py:294: 112^2 segmented 16-frame clips for the
    FID-VID 3D-ResNet; 224^2 whole videos for I3D/FVD)."""
    from magicdance_tpu_torch.metrics.core import (
        frechet_distance,
        gaussian_frechet_stats,
    )

    ex = VideoFeatureExtractor(weights_path, backbone, device)
    f1 = ex((load_video_frames(d, ex.size) for d in gen_dirs), clip_len)
    f2 = ex((load_video_frames(d, ex.size) for d in gt_dirs), clip_len)
    mu1, s1 = gaussian_frechet_stats(f1)
    mu2, s2 = gaussian_frechet_stats(f2)
    return frechet_distance(mu1, s1, mu2, s2)


def fvd_between_roots(
    gen_root: str,
    gt_root: str,
    weights_path: str,
    gen_name: str = "gen_images",
    gt_name: str = "gt_images",
    clip_len: int = 16,
    backbone: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
) -> float:
    """Walk `{root}/{seq}/{gen,gt}` video folders and compute the Frechet
    distance between pooled video features (FVD with I3D weights, FID-VID
    with a 3D-ResNet)."""
    seqs = [d for d in sorted(os.listdir(gen_root))
            if os.path.isdir(os.path.join(gen_root, d, gen_name))]
    return frechet_video_distance(
        [os.path.join(gen_root, s, gen_name) for s in seqs],
        [os.path.join(gt_root, s, gt_name) for s in seqs],
        weights_path, clip_len, backbone, device)
