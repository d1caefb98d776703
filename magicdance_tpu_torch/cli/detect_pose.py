"""Offline pose-map pre-rendering: frame folders → OpenPose skeleton maps.

The product equivalent of the reference's offline preprocessing
(ref: misc_scripts/detect_openpose_map_tiktok.py — per-frame keypoint
detection feeding `pose_map_train_set/` folders, README.md:156-185 "use your
own data"). BLIP2 captioning and ByteDance KV shard writing are explicit
non-goals (internal services; SURVEY §7) — output is the same frame-folder
tree the datasets consume.

Counterpart of `magicdance_tpu.cli.detect_pose`: the same flags, plus
`--device`; the CPM nets run on the GPU unless `--device cpu`.

Usage:
  python -m magicdance_tpu_torch.cli.detect_pose \
    --input TikTok-v4/train_set --output TikTok-v4/pose_map_train_set \
    --body_weights body_pose_model.pth \
    [--hand_weights hand_pose_model.pth] [--face_weights facenet.pth]
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", required=True, help="root of {video}/frame.png trees")
    p.add_argument("--output", required=True)
    p.add_argument("--body_weights", required=True)
    p.add_argument("--hand_weights", default=None)
    p.add_argument("--face_weights", default=None)
    p.add_argument("--save_keypoints", action="store_true",
                   help="also write per-frame keypoint JSON")
    p.add_argument("--min_keypoints", type=int, default=4,
                   help="skip frames with fewer valid body keypoints "
                        "(quality filter, ref tiktok_video_mm.py:127-139)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import numpy as np
    from PIL import Image

    from magicdance_tpu_torch.data.openpose_detect import OpenposeDetector
    from magicdance_tpu_torch.data.pose import draw_pose, keypoint_quality

    det = OpenposeDetector(args.body_weights, args.hand_weights,
                           args.face_weights, device=args.device)

    videos = sorted(
        d for d in os.listdir(args.input)
        if os.path.isdir(os.path.join(args.input, d))
    ) or ["."]
    total = skipped = 0
    for v in videos:
        in_dir = os.path.join(args.input, v)
        out_dir = os.path.join(args.output, v)
        os.makedirs(out_dir, exist_ok=True)
        for f in sorted(os.listdir(in_dir)):
            if not f.lower().endswith((".png", ".jpg", ".jpeg")):
                continue
            img = np.asarray(Image.open(os.path.join(in_dir, f)).convert("RGB"))
            pose = det(img, include_hands=args.hand_weights is not None,
                       include_faces=args.face_weights is not None)
            total += 1
            if keypoint_quality(pose) < args.min_keypoints:
                skipped += 1
                continue
            canvas = draw_pose(pose, img.shape[0], img.shape[1])
            Image.fromarray(canvas).save(os.path.join(out_dir, f))
            if args.save_keypoints:
                with open(os.path.join(out_dir, f + ".json"), "w") as jf:
                    json.dump(
                        {
                            "body": pose.body.tolist(),
                            "hands": None if pose.hands is None else pose.hands.tolist(),
                            "faces": None if pose.faces is None else pose.faces.tolist(),
                        },
                        jf,
                    )
        print(f"[detect_pose] {v} done")
    print(f"[detect_pose] rendered {total - skipped}/{total} frames "
          f"({skipped} below keypoint threshold)")


if __name__ == "__main__":
    main()
