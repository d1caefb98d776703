"""Zero-shot pose retargeting CLI: one reference image + a pose-map folder ->
a generated frame sequence (+ optional GIF/MP4).

Counterpart of `magicdance_tpu.cli.sample` (the reference's
test_any_image_pose.py: :46-82 center-crop preprocessing, :139-172 cond
prep, :210-262 frame loop; scripts/inference_any_image_pose.sh flag set):
the same flags and defaults, plus `--device`. Frames are sampled as one
batch (or in `--batch` chunks, the last padded and trimmed). Runs on the GPU
unless `--device cpu`.

`build_pipeline` (config, weights) and `generate` (arrays in, uint8 frames
out) need no image library; `main` adds the file I/O around them: reading
the reference and the pose maps (PIL), writing the frames, the GIF (PIL)
and the MP4 (cv2).

Usage:
  python -m magicdance_tpu_torch.cli.sample \\
    --checkpoint pretrained_weights/model_state-110000.th \\
    --reference example_data/image/ref.png \\
    --pose_dir example_data/pose_sequence/001 \\
    --output out/ [--steps 50] [--cfg 7.0] [--size 512] [--gif] [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", default=None,
                   help=".th/.ckpt reference checkpoint (converted on load); "
                        "omit for random weights (smoke tests)")
    p.add_argument("--model_config", default=None,
                   help="ModelConfig JSON (defaults to full SD1.5-scale MagicPose)")
    p.add_argument("--reference", required=True, help="reference image path")
    p.add_argument("--pose_dir", required=True, help="folder of pose maps")
    p.add_argument("--image_hint_dir", default=None,
                   help="folder of second-ControlNet hints (DUAL_CONTROL "
                        "variant; same frame names as --pose_dir)")
    p.add_argument("--output", required=True)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--cfg", type=float, default=7.0)
    p.add_argument("--eta", type=float, default=0.0)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--batch", type=int, default=0,
                   help="frames per device batch (0 = all at once)")
    p.add_argument("--prompt", default="", help="text prompt (default empty, "
                   "matching the reference recipe)")
    p.add_argument("--merges", default=None, help="CLIP BPE merges file "
                   "(needed only for non-empty prompts)")
    p.add_argument("--video", action="store_true",
                   help="temporal model variant: motion modules + overlap "
                        "sampling over --window/--stride frame windows")
    p.add_argument("--window", type=int, default=16)
    p.add_argument("--stride", type=int, default=12)
    p.add_argument("--gif", action="store_true")
    p.add_argument("--mp4", action="store_true")
    p.add_argument("--no_pose_noise", dest="wonoise", action="store_true",
                   default=True)
    # opt-in turbo modes (defaults are the exact recipe)
    p.add_argument("--cfg_interval", type=float, nargs=2, default=None,
                   metavar=("LO", "HI"),
                   help="apply CFG only while t/T is in [LO, HI] (inclusive); "
                        "skips the "
                        "uncond forward outside (e.g. 0.15 0.85)")
    p.add_argument("--uncond_every", type=int, default=1,
                   help="refresh the uncond eps every k-th CFG-active step, "
                        "reuse the cached value in between")
    p.add_argument("--pose_every", type=int, default=1,
                   help="refresh pose-ControlNet residuals every k-th step")
    p.add_argument("--deepcache_level", type=int, default=0,
                   help="DeepCache split level: 0 = deepest reuse (fastest),"
                        " 1 = recompute levels 0-1 per step (more accurate)")
    p.add_argument("--deepcache_every", type=int, default=1,
                   help="refresh the cond UNet's deep levels every k-th "
                        "step; run only the level-0 encoder/decoder in "
                        "between (DeepCache)")
    p.add_argument("--bank_every", type=int, default=1,
                   help="refresh the appearance bank (full-UNet-copy write "
                        "pass) every k-th step, reuse the cached bank in "
                        "between; biggest win at small frame batches")
    p.add_argument("--bank_downsample", type=int, default=1,
                   help="average-pool the largest appearance-bank entries "
                        "f x f before the read sites consume them (ToMe-"
                        "style KV reduction; cuts bank-read attention cost "
                        "at the pooled sites ~f^2)")
    p.add_argument("--self_kv_downsample", type=int, default=1,
                   help="average-pool SELF attention keys/values f x f at "
                        "the largest self-attention sites (queries/outputs "
                        "stay full resolution; static ToMe-style token "
                        "reduction)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the sampling run "
                        "into DIR (Chrome trace, loadable in Perfetto)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def model_config(args):
    """--model_config JSON, else the temporal variant with motion modules
    under --video, else the full SD1.5-scale MagicPose."""
    from magicdance_tpu_torch import config as C

    if args.model_config:
        return C.load_json(args.model_config, C.ModelConfig)
    if args.video:
        return C.ModelConfig(variant=C.ModelVariant.APPEARANCE_POSE_TEMPORAL,
                             unet=C.UNetConfig(use_motion_modules=True))
    return C.ModelConfig()


def sample_config(args):
    from magicdance_tpu_torch.config import SampleConfig

    return SampleConfig(steps=args.steps, cfg_scale=args.cfg, eta=args.eta,
                        wonoise=args.wonoise, window=args.window, stride=args.stride,
                        cfg_interval=tuple(args.cfg_interval) if args.cfg_interval else None,
                        uncond_every=args.uncond_every, pose_every=args.pose_every,
                        deepcache_every=args.deepcache_every, bank_every=args.bank_every,
                        bank_downsample=args.bank_downsample,
                        self_kv_downsample=args.self_kv_downsample,
                        deepcache_level=args.deepcache_level)


def build_pipeline(args):
    """The pipeline on `--device` with the `--checkpoint` weights (a
    reference checkpoint through `convert.torch_convert`, loaded strictly;
    the denoiser holds them in its compute dtype, bf16 unless the config
    says otherwise), or seeded random weights without one (smoke mode)."""
    from magicdance_tpu_torch.data.tokenizer import CLIPTokenizer
    from magicdance_tpu_torch.pipeline import MagicPosePipeline

    cfg = model_config(args)
    pipe = MagicPosePipeline(cfg, device=args.device, tokenizer=CLIPTokenizer(args.merges))
    if args.checkpoint:
        from magicdance_tpu_torch.convert.torch_convert import (
            convert_magicpose_state,
            load_torch_state,
        )

        pipe.load_state_dicts(convert_magicpose_state(load_torch_state(args.checkpoint), cfg))
        print(f"[sample] loaded {args.checkpoint}")
    else:
        print("[sample] no checkpoint given — random weights (smoke mode)")
        pipe.init_params(seed=0)
    return pipe


def _pad(a: np.ndarray, n: int) -> np.ndarray:
    return np.concatenate([a, np.repeat(a[-1:], n, 0)]) if n else a


def generate(args, pipe, ref: np.ndarray, poses: np.ndarray,
             image_hints: np.ndarray | None = None) -> np.ndarray:
    """ref: (1, H, W, 3) in [-1, 1]; poses (and image_hints, DUAL_CONTROL):
    (F, H, W, 3) in [0, 1] -> (F, H, W, 3) uint8 frames. Frames go through
    `pipe.sample_frames` in chunks of `--batch` (all at once for 0), the
    last chunk padded with its last pose and trimmed after; every chunk
    draws its noise from a generator seeded with `--seed`."""
    import torch

    from magicdance_tpu_torch.data.transforms import from_model_range

    scfg = sample_config(args)
    profile = contextlib.nullcontext()
    if args.profile:
        from magicdance_tpu_torch.utils.profiling import trace

        profile = trace(args.profile)
    ref_t = torch.from_numpy(np.asarray(ref, np.float32))
    B = args.batch if args.batch > 0 else len(poses)
    frames = []
    with profile:
        for i in range(0, len(poses), B):
            pad = B - len(poses[i : i + B])
            chunk = _pad(poses[i : i + B], pad)
            ih = None
            if image_hints is not None:
                ih = torch.from_numpy(np.asarray(_pad(image_hints[i : i + B], pad), np.float32))
            gen = torch.Generator(device=pipe.device).manual_seed(args.seed)
            imgs = pipe.sample_frames(torch.from_numpy(np.asarray(chunk, np.float32)), ref_t,
                                      scfg, video=args.video, generator=gen, image_hints=ih)
            imgs = imgs.cpu().numpy()
            if pad:
                imgs = imgs[:-pad]
            frames.extend(from_model_range(f) for f in imgs)
    return np.stack(frames)


def read_inputs(args):
    """(frame names, reference (1, H, W, 3) in [-1, 1], pose maps and image
    hints (F, H, W, 3) in [0, 1] or None), each image center-cropped to a
    square and resized to --size."""
    from PIL import Image

    from magicdance_tpu_torch.data.transforms import prepare_image, to_hint_range, to_model_range

    def read(path):
        return prepare_image(np.asarray(Image.open(path).convert("RGB")), args.size)

    ref = to_model_range(read(args.reference))[None]
    names = sorted(f for f in os.listdir(args.pose_dir)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    poses = np.stack([to_hint_range(read(os.path.join(args.pose_dir, f))) for f in names])
    hints = None
    if args.image_hint_dir:
        hints = np.stack([to_hint_range(read(os.path.join(args.image_hint_dir, f)))
                          for f in names])
    return names, ref, poses, hints


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)
    from PIL import Image

    pipe = build_pipeline(args)
    names, ref, poses, hints = read_inputs(args)
    os.makedirs(args.output, exist_ok=True)
    frames = generate(args, pipe, ref, poses, hints)
    for name, frame in zip(names, frames):
        Image.fromarray(frame).save(os.path.join(args.output, name))
    print(f"[sample] wrote {len(frames)} frames to {args.output}")

    if args.gif or args.mp4:
        from magicdance_tpu_torch.utils.video import frames_to_gif, frames_to_mp4

        if args.gif:
            print("[sample]", frames_to_gif(list(frames), os.path.join(args.output, "out.gif")))
        if args.mp4:
            print("[sample]", frames_to_mp4(list(frames), os.path.join(args.output, "out.mp4")))


if __name__ == "__main__":
    main()
