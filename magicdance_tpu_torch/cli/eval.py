"""Eval-set inference: TikTok test split -> gen/gt/pose image trees.

Counterpart of `magicdance_tpu.cli.eval` (the reference's test_tiktok.py:
:341 main, :192-280 visualize -- writes
`{video}/gen_images|gt_images|pose_maps/NNN.jpg` trees consumed by the
metric runner): the same flags and defaults, plus `--device`. The pipeline
is built as `cli/sample.py` builds it (a `--checkpoint` through
`convert/torch_convert.py`, or seeded random weights in smoke mode); each
video's frames go through `cli.sample.generate` in chunks of `--batch` (the
last padded with its last pose and trimmed after), every chunk drawing its
noise from a generator seeded with `--seed`. Videos are split
`rank::world` across processes: `--rank` / `--world` default to the
initialized `torch.distributed` process group's, else 0 / 1. The metric
runner is `python -m magicdance_tpu_torch.metrics.center`. Runs on the GPU
unless `--device cpu`.

Usage:
  python -m magicdance_tpu_torch.cli.eval --checkpoint ...th --data TikTok-v4 \\
      --output eval_out [--steps 50] [--cfg 7.0] [--batch 8] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    from magicdance_tpu_torch.config import SampleConfig

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--model_config", default=None,
                   help="ModelConfig JSON (defaults to full SD1.5-scale MagicPose)")
    p.add_argument("--data", required=True, help="TikTok-v4 root")
    p.add_argument("--output", required=True)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--cfg", type=float, default=7.0)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--batch", type=int, default=8, help="frames per sampling call")
    p.add_argument("--max_videos", type=int, default=0)
    p.add_argument("--every_nth", type=int, default=1)
    p.add_argument("--rank", type=int, default=None,
                   help="shard the eval videos: this process handles videos "
                        "[rank::world] (default: the torch.distributed rank "
                        "when a process group is initialized, else 0 -- the "
                        "reference shards test_tiktok the same way under "
                        "torchrun, test_tiktok.py:357)")
    p.add_argument("--world", type=int, default=None)
    # opt-in turbo modes (defaults exact) -- exposed here so their metric
    # impact can be measured with the same harness
    p.add_argument("--cfg_interval", type=float, nargs=2, default=None,
                   metavar=("LO", "HI"))
    p.add_argument("--uncond_every", type=int, default=1)
    p.add_argument("--pose_every", type=int, default=1)
    p.add_argument("--deepcache_every", type=int, default=1)
    p.add_argument("--deepcache_level", type=int, default=0)
    p.add_argument("--bank_every", type=int, default=1)
    p.add_argument("--bank_downsample", type=int, default=1)
    p.add_argument("--self_kv_downsample", type=int, default=1)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # the rest of what cli.sample's build_pipeline / generate read: the
    # image recipe at SampleConfig's defaults (no prompt, no video)
    d = SampleConfig()
    p.set_defaults(merges=None, video=False, profile=None, eta=d.eta, wonoise=d.wonoise,
                   window=d.window, stride=d.stride)
    return p


def shard(args) -> tuple[int, int]:
    """(rank, world): the flags, else the initialized process group's, else
    (0, 1)."""
    import torch.distributed as dist

    group = dist.is_available() and dist.is_initialized()
    rank = args.rank if args.rank is not None else (dist.get_rank() if group else 0)
    world = args.world if args.world is not None else (dist.get_world_size() if group else 1)
    return rank, world


def main(argv=None) -> list[dict]:
    """Writes the trees; returns one record per video: its name, frames and
    the seconds `generate` took for them (host clock, results on the host)."""
    from PIL import Image

    from magicdance_tpu_torch.cli.sample import build_pipeline, generate
    from magicdance_tpu_torch.data.tiktok import TikTokEvalDataset
    from magicdance_tpu_torch.data.transforms import from_model_range

    args = build_argparser().parse_args(argv)
    pipe = build_pipeline(args, tag="eval")
    rank, world = shard(args)
    ds = TikTokEvalDataset(root=args.data, image_size=args.size,
                           every_nth=args.every_nth, rank=rank, world_size=world)
    records = []
    for vi, seq in enumerate(ds):
        if args.max_videos and vi >= args.max_videos:
            break
        out_dir = os.path.join(args.output, seq["video"])
        for sub in ("gen_images", "gt_images", "pose_maps"):
            os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

        poses, gts = seq["pose"], seq["gt"]
        t0 = time.perf_counter()
        frames = generate(args, pipe, seq["reference"], poses)
        secs = time.perf_counter() - t0
        for j, name in enumerate(seq["frame_names"]):
            Image.fromarray(frames[j]).save(os.path.join(out_dir, "gen_images", name))
            Image.fromarray(from_model_range(gts[j])).save(
                os.path.join(out_dir, "gt_images", name))
            Image.fromarray((poses[j] * 255).astype(np.uint8)).save(
                os.path.join(out_dir, "pose_maps", name))
        records.append(dict(video=seq["video"], frames=len(poses), seconds=secs))
        print(f"[eval] {seq['video']}: {len(poses)} frames in {secs:.2f} s")
    print(f"[eval] done -> {args.output}; run "
          f"`python -m magicdance_tpu_torch.metrics.center --root {args.output}`")
    return records


if __name__ == "__main__":
    main()
