"""Unified metric runner over generated/GT image folder trees (PyTorch).

Counterpart of `magicdance_tpu.metrics.center`, the DisCo-identical
evaluation driver (ref: tool/metrics/metric_center.py:678
get_all_eval_scores, :834-862 CLI -- consumes the
`{itr}/gen_images|gt_images|pose_maps/NNN.jpg` trees written by
test_tiktok.py:193-198 and by `magicdance_tpu_torch.cli.eval`, supports
`--type fid fid-img fid-vid fvd l1 ssim lpips psnr mae is`).

Always-available metrics (pure math): l1, ssim, psnr, mae.
Weight-gated metrics: lpips (torch lpips VGG weights), fid / is (InceptionV3
weights), fid-vid / fvd (3D backbones) -- pass the corresponding
`--*_weights` arguments; without weights they are skipped with a notice
(the weight files are local; none can be fetched).

Every score is computed on `--device` (the GPU unless `--device cpu`) in
full fp32. Results are written to `results.json` in the output folder.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Iterator, Optional, Union

import numpy as np
import torch
from PIL import Image

from magicdance_tpu_torch.device import full_fp32, resolve_device


def _load_folder(folder: str, size: Optional[int] = None) -> Iterator[np.ndarray]:
    for f in sorted(os.listdir(folder)):
        if not f.lower().endswith((".png", ".jpg", ".jpeg")):
            continue
        img = Image.open(os.path.join(folder, f)).convert("RGB")
        if size is not None:
            img = img.resize((size, size), Image.BICUBIC)
        yield np.asarray(img)


def paired_batches(gen_dir: str, gt_dir: str, batch: int = 16):
    gen_it, gt_it = _load_folder(gen_dir), _load_folder(gt_dir)
    while True:
        gens, gts = [], []
        for _ in range(batch):
            try:
                gens.append(next(gen_it))
                gts.append(next(gt_it))
            except StopIteration:
                break
        if not gens:
            return
        yield np.stack(gens), np.stack(gts)


def luma_uint8(rgb: np.ndarray) -> np.ndarray:
    """ITU-R BT.601 grayscale, rounded to uint8 -- the cv2.cvtColor(BGR2GRAY)
    DisCo applies before SSIM (ref ssim_l1_lpips_psnr.py:62-64)."""
    y = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2])
    return np.clip(np.round(y), 0, 255).astype(np.uint8)


def compute_paired_metrics(
    gen_dir: str, gt_dir: str, types: list[str],
    lpips_weights: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
) -> dict:
    """DisCo-convention paired metrics (ref ssim_l1_lpips_psnr.py):
      l1   -- mean |a-b| on 0-255 pixels divided by H*W (the reference's
              l1_eval normalizes the error MAP by H*W before averaging,
              lines 31-34 -- this reproduces DisCo's reported ~1e-4 scale)
      mae  -- plain mean |a-b| with images in [0, 1]
      ssim -- skimage defaults on the BT.601 grayscale channel (lines 62-67)
      psnr -- 255-peak on full-color pixels (lines 12-19)

    Scores are computed on `device` in full fp32 (TF32 off)."""
    device = resolve_device(device)
    with full_fp32():
        return _compute_paired_metrics(gen_dir, gt_dir, types, lpips_weights, device)


def _compute_paired_metrics(
    gen_dir: str, gt_dir: str, types: list[str],
    lpips_weights: Optional[str], device: torch.device,
) -> dict:
    from magicdance_tpu_torch.metrics.core import l1_error, psnr, ssim

    want = set(types)
    sums: dict[str, list[float]] = {t: [] for t in want}
    lp = None
    if "lpips" in want:
        from magicdance_tpu_torch.metrics.lpips import LPIPSScorer

        lp = LPIPSScorer(lpips_weights, device)
        if not lp.calibrated:
            print("[metrics] WARNING: lpips running with random weights "
                  "(no --lpips_weights); scores not comparable")

    def on_device(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    n = 0
    for gens, gts in paired_batches(gen_dir, gt_dir):
        g = on_device(gens) / 255.0
        t = on_device(gts) / 255.0
        bs = len(gens)
        n += bs
        if "l1" in want:
            hw = float(gens.shape[1] * gens.shape[2])
            d = np.abs(gens.astype(np.float64) - gts.astype(np.float64))
            sums["l1"].append(float(d.mean()) / hw * bs)
        if "mae" in want:
            sums["mae"].append(float(l1_error(g, t)) * bs)
        if "ssim" in want:
            gg = on_device(luma_uint8(gens))[..., None] / 255.0
            tt = on_device(luma_uint8(gts))[..., None] / 255.0
            sums["ssim"].append(float(ssim(gg, tt)) * bs)
        if "psnr" in want:
            sums["psnr"].append(float(psnr(g, t)) * bs)
        if lp is not None:
            d = lp(g * 2 - 1, t * 2 - 1)
            sums["lpips"].append(float(d.sum()))
    out = {k: (sum(v) / max(n, 1)) for k, v in sums.items() if v}
    out["num_images"] = n
    return out


def compute_fid(gen_dir: str, gt_dir: str, inception_weights: Optional[str],
                device: Union[str, torch.device] = "cuda") -> Optional[float]:
    if not inception_weights:
        print("[metrics] skipping FID: no --inception_weights "
              "(InceptionV3 weights file required)")
        return None
    from magicdance_tpu_torch.metrics.fid import fid_between_folders

    return fid_between_folders(gen_dir, gt_dir, inception_weights, device)


def get_all_eval_scores(
    root: str,
    types: list[str],
    gen_name: str = "gen_images",
    gt_name: str = "gt_images",
    lpips_weights: Optional[str] = None,
    inception_weights: Optional[str] = None,
    i3d_weights: Optional[str] = None,
    resnet3d_weights: Optional[str] = None,
    sample_frames: int = 0,
    device: Union[str, torch.device] = "cuda",
) -> dict:
    """Walk `{root}/{seq}/{gen_images,gt_images}` trees (flat folders also
    accepted) and aggregate (ref metric_center.py:678).

    Runs on `device` (the GPU unless the caller asks for the CPU) in full
    fp32: metric scores must be exact fp32 -- TF32 breaks SSIM (see
    core._uniform_filter) and would silently perturb the FID/FVD/LPIPS
    feature extractors against the fp32 reference."""
    device = resolve_device(device)
    with full_fp32():
        return _get_all_eval_scores(
            root, types, gen_name, gt_name, lpips_weights,
            inception_weights, i3d_weights, resnet3d_weights, sample_frames, device)


def _get_all_eval_scores(
    root, types, gen_name, gt_name, lpips_weights,
    inception_weights, i3d_weights, resnet3d_weights, sample_frames, device,
) -> dict:
    seqs = []
    if os.path.isdir(os.path.join(root, gen_name)):
        seqs = [root]
    else:
        seqs = [
            os.path.join(root, d) for d in sorted(os.listdir(root))
            if os.path.isdir(os.path.join(root, d, gen_name))
        ]
    if not seqs:
        raise FileNotFoundError(f"no {gen_name} trees under {root}")

    agg: dict[str, float] = {}
    total = 0
    for seq in seqs:
        res = compute_paired_metrics(
            os.path.join(seq, gen_name), os.path.join(seq, gt_name),
            [t for t in types if t in ("l1", "mae", "ssim", "psnr", "lpips")],
            lpips_weights, device,
        )
        k = res.pop("num_images")
        total += k
        for key, v in res.items():
            agg[key] = agg.get(key, 0.0) + v * k
    results = {k: v / max(total, 1) for k, v in agg.items()}
    results["num_images"] = total

    if "fid" in types:
        # FID pools features across all sequences
        fid = compute_fid_multi(seqs, gen_name, gt_name, inception_weights, device=device)
        if fid is not None:
            results["fid"] = fid

    if "fid-img" in types:
        # FID-Img (ref metric_center.py:606-618): frame-level FID where each
        # sequence is a video and only the FIRST sample_frames frames count
        # (ref utils.py:251-254); sample_frames=0 uses all frames, which is
        # then identical to `fid` on materialized frame trees
        fid_img = compute_fid_multi(seqs, gen_name, gt_name,
                                    inception_weights,
                                    max_images=sample_frames, device=device)
        if fid_img is not None:
            results["fid-img"] = fid_img

    # video Frechet metrics: each sequence folder is one video of sorted
    # frames (ref metric_center.py:692 'fvd': FVD-3DInception / I3D,
    # 'fid-vid': FVD-3DRN50 / Kinetics 3D-ResNet50)
    for mtype, weights, backbone, notice in (
        ("fvd", i3d_weights, "i3d", "--i3d_weights"),
        ("fid-vid", resnet3d_weights, "r3d", "--resnet3d_weights"),
    ):
        if mtype not in types:
            continue
        if not weights:
            print(f"[metrics] skipping {mtype}: no {notice} "
                  "(3D backbone weights file required)")
            continue
        from magicdance_tpu_torch.metrics.fvd import frechet_video_distance

        results[mtype] = frechet_video_distance(
            [os.path.join(s, gen_name) for s in seqs],
            [os.path.join(s, gt_name) for s in seqs], weights,
            backbone=backbone, device=device)

    if "is" in types:
        if not inception_weights:
            print("[metrics] skipping IS: no --inception_weights")
        else:
            from magicdance_tpu_torch.metrics.core import inception_score_from_logits
            from magicdance_tpu_torch.metrics.fid import folder_logits

            per_seq = [
                folder_logits(os.path.join(s, gen_name), inception_weights, device=device)
                for s in seqs]
            per_seq = [x for x in per_seq if len(x)]  # empty -> (0, 0)
            if per_seq:
                logits = np.concatenate(per_seq)
                splits = min(10, max(1, len(logits)))
                m, s = inception_score_from_logits(logits, splits=splits)
                results["is_mean"], results["is_std"] = m, s
            else:
                print("[metrics] skipping IS: no generated images found")
    return results


def compute_fid_multi(seqs, gen_name, gt_name, inception_weights,
                      max_images: int = 0, device: Union[str, torch.device] = "cuda"):
    if not inception_weights:
        print("[metrics] skipping FID: no inception weights provided")
        return None
    from magicdance_tpu_torch.metrics.core import frechet_distance, gaussian_frechet_stats
    from magicdance_tpu_torch.metrics.fid import folder_features

    gen_feats, gt_feats = [], []
    for seq in seqs:
        gen_feats.append(folder_features(os.path.join(seq, gen_name),
                                         inception_weights,
                                         max_images=max_images, device=device))
        gt_feats.append(folder_features(os.path.join(seq, gt_name),
                                        inception_weights,
                                        max_images=max_images, device=device))
    gen_feats = [x for x in gen_feats if len(x)]  # empty folders -> (0, 0)
    gt_feats = [x for x in gt_feats if len(x)]
    if not gen_feats or not gt_feats:
        print("[metrics] skipping FID: empty image folders")
        return None
    mu1, s1 = gaussian_frechet_stats(np.concatenate(gen_feats))
    mu2, s2 = gaussian_frechet_stats(np.concatenate(gt_feats))
    return frechet_distance(mu1, s1, mu2, s2)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True,
                   help="folder with {seq}/gen_images|gt_images trees")
    p.add_argument("--type", nargs="+", default=["l1", "ssim", "psnr"],
                   choices=["l1", "mae", "ssim", "psnr", "lpips", "fid",
                            "fid-img", "fid-vid", "fvd", "is"])
    p.add_argument("--sample_frames", type=int, default=0,
                   help="FID-Img: use only the first N frames per sequence "
                        "(0 = all; ref metric_center.py number_sample_frames)")
    p.add_argument("--lpips_weights", default=None)
    p.add_argument("--inception_weights", default=None)
    p.add_argument("--i3d_weights", default=None,
                   help="I3D state dict (i3d_pretrained_400.pt) for FVD")
    p.add_argument("--resnet3d_weights", default=None,
                   help="Kinetics 3D-ResNet50 state dict for FID-VID")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    res = get_all_eval_scores(
        args.root, args.type,
        lpips_weights=args.lpips_weights,
        inception_weights=args.inception_weights,
        i3d_weights=args.i3d_weights,
        resnet3d_weights=args.resnet3d_weights,
        sample_frames=args.sample_frames,
        device=args.device,
    )
    print(json.dumps(res, indent=2))
    out = args.out or os.path.join(args.root, "results.json")
    with open(out, "w") as f:
        json.dump(res, f, indent=2)


if __name__ == "__main__":
    main()
