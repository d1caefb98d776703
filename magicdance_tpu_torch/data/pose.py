"""OpenPose skeleton-map rendering (host-side, NumPy + cv2).

The PyTorch port's own copy of `magicdance_tpu.data.pose` (numpy, cv2 and,
for hands, matplotlib's HSV conversion); the port imports nothing of the
JAX package.

Reimplements the canvas renderer the reference uses both offline (pose-map
pre-rendering for TikTok-v4) and inside the video dataset
(ref: model_lib/ControlNet/annotator/openpose/__init__.py:24-41 draw_pose;
annotator/openpose/util.py draw_bodypose/draw_handpose/draw_facepose;
dataset/tiktok_video_mm.py:78-96 on-the-fly rendering). The drawing scheme
(18-keypoint body with 17 stick limbs, 21-keypoint hands, 70-keypoint face)
is the public OpenPose convention.

Keypoints are normalized to [0,1] x [0,1]; invalid points are < 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

# 17 limb segments over the 18 body keypoints (1-indexed pairs, OpenPose
# convention: neck-hips-knees-ankles-shoulders-elbows-wrists-face-ears)
BODY_LIMBS = [
    (2, 3), (2, 6), (3, 4), (4, 5), (6, 7), (7, 8), (2, 9), (9, 10),
    (10, 11), (2, 12), (12, 13), (13, 14), (2, 1), (1, 15), (15, 17),
    (1, 16), (16, 18),
]

LIMB_COLORS = [
    (255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0), (170, 255, 0),
    (85, 255, 0), (0, 255, 0), (0, 255, 85), (0, 255, 170), (0, 255, 255),
    (0, 170, 255), (0, 85, 255), (0, 0, 255), (85, 0, 255), (170, 0, 255),
    (255, 0, 255), (255, 0, 170), (255, 0, 85),
]

HAND_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 4), (0, 5), (5, 6), (6, 7), (7, 8),
    (0, 9), (9, 10), (10, 11), (11, 12), (0, 13), (13, 14), (14, 15),
    (15, 16), (0, 17), (17, 18), (18, 19), (19, 20),
]


@dataclass
class PoseResult:
    """Normalized keypoints for one frame."""

    body: np.ndarray  # (P, 18, 2) float, <0 marks missing
    hands: Optional[np.ndarray] = None  # (Nh, 21, 2)
    faces: Optional[np.ndarray] = None  # (Nf, 70, 2)


def draw_body(canvas: np.ndarray, body: np.ndarray, stickwidth: int = 4) -> np.ndarray:
    H, W = canvas.shape[:2]
    for person in body:
        pts = person.copy()
        pts[:, 0] *= W
        pts[:, 1] *= H
        for idx, (a, b) in enumerate(BODY_LIMBS):
            pa, pb = pts[a - 1], pts[b - 1]
            if (pa < 0).any() or (pb < 0).any():
                continue
            mx, my = (pa[0] + pb[0]) / 2, (pa[1] + pb[1]) / 2
            length = float(np.hypot(pa[0] - pb[0], pa[1] - pb[1]))
            angle = float(np.degrees(np.arctan2(pa[1] - pb[1], pa[0] - pb[0])))
            poly = cv2.ellipse2Poly(
                (int(mx), int(my)), (int(length / 2), stickwidth), int(angle),
                0, 360, 1,
            )
            cv2.fillConvexPoly(canvas, poly, LIMB_COLORS[idx])
        canvas = (canvas * 0.6).astype(np.uint8)
        for i in range(18):
            p = pts[i]
            if (p < 0).any():
                continue
            cv2.circle(canvas, (int(p[0]), int(p[1])), stickwidth,
                       LIMB_COLORS[i], thickness=-1)
    return canvas


def draw_hands(canvas: np.ndarray, hands: np.ndarray) -> np.ndarray:
    import matplotlib

    H, W = canvas.shape[:2]
    for hand in hands:
        pts = hand.copy()
        pts[:, 0] *= W
        pts[:, 1] *= H
        for ie, (a, b) in enumerate(HAND_EDGES):
            pa, pb = pts[a], pts[b]
            if (pa < 0).any() or (pb < 0).any():
                continue
            rgb = matplotlib.colors.hsv_to_rgb(
                [ie / len(HAND_EDGES), 1.0, 1.0]
            ) * 255
            cv2.line(canvas, (int(pa[0]), int(pa[1])), (int(pb[0]), int(pb[1])),
                     tuple(int(c) for c in rgb), thickness=2)
        for p in pts:
            if (p < 0).any():
                continue
            cv2.circle(canvas, (int(p[0]), int(p[1])), 4, (0, 0, 255),
                       thickness=-1)
    return canvas


def draw_faces(canvas: np.ndarray, faces: np.ndarray) -> np.ndarray:
    H, W = canvas.shape[:2]
    for face in faces:
        pts = face.copy()
        pts[:, 0] *= W
        pts[:, 1] *= H
        for p in pts:
            if (p < 0).any():
                continue
            cv2.circle(canvas, (int(p[0]), int(p[1])), 3, (255, 255, 255),
                       thickness=-1)
    return canvas


def draw_pose(pose: PoseResult, height: int, width: int,
              draw_body_flag: bool = True, draw_hand: bool = True,
              draw_face: bool = True) -> np.ndarray:
    """Render a (H, W, 3) uint8 skeleton map on black
    (ref annotator/openpose/__init__.py:24-41)."""
    if cv2 is None:
        raise ImportError("cv2 required for pose rendering")
    canvas = np.zeros((height, width, 3), dtype=np.uint8)
    if draw_body_flag and pose.body is not None and len(pose.body):
        canvas = draw_body(canvas, pose.body)
    if draw_hand and pose.hands is not None and len(pose.hands):
        canvas = draw_hands(canvas, pose.hands)
    if draw_face and pose.faces is not None and len(pose.faces):
        canvas = draw_faces(canvas, pose.faces)
    return canvas


def keypoint_quality(pose: PoseResult) -> int:
    """Count of valid body keypoints — dataset quality filter
    (ref tiktok_video_mm.py:127-139)."""
    if pose.body is None or len(pose.body) == 0:
        return 0
    return int(((pose.body >= 0).all(axis=-1)).sum())
