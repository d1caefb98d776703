"""OpenPose detection pipeline: images → PoseResult keypoints.

Counterpart of `magicdance_tpu.data.openpose_detect` (the reference detector,
ref: model_lib/ControlNet/annotator/openpose/__init__.py:44
OpenposeDetector, body.py [multi-scale CPM inference, peak finding, PAF
part-affinity matching, person assembly], hand.py, face.py, util.py
[handDetect/faceDetect ROI heuristics]). The CPM networks are the port's
`models.openpose` nets, run in fp32 on the detector's device (the GPU unless
the caller asks for the CPU) under `torch.inference_mode()`; the input is
NHWC on the host and NCHW at the nets' boundary. The peak/grouping logic is
NumPy + cv2 host-side (it is inherently small and dynamic), copied as the
JAX package has it.

The PAF grouping uses the public OpenPose 19-limb tables: `LIMB_SEQ` pairs
of body parts and `PAF_IDX` pairs of affinity-field channels.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

import torch

from magicdance_tpu_torch.data.pose import PoseResult
from magicdance_tpu_torch.device import resolve_device
from magicdance_tpu_torch.pipeline import full_fp32

LIMB_SEQ = [
    [2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9], [9, 10],
    [10, 11], [2, 12], [12, 13], [13, 14], [2, 1], [1, 15], [15, 17],
    [1, 16], [16, 18], [3, 17], [6, 18],
]
PAF_IDX = [
    [12, 13], [20, 21], [14, 15], [16, 17], [22, 23], [24, 25], [0, 1],
    [2, 3], [4, 5], [6, 7], [8, 9], [10, 11], [28, 29], [30, 31], [34, 35],
    [32, 33], [36, 37], [18, 19], [26, 27],
]

STRIDE = 8
BOXSIZE = 368


def _pad_to_stride(img: np.ndarray, stride: int = STRIDE) -> tuple[np.ndarray, tuple[int, int]]:
    h, w = img.shape[:2]
    ph = (stride - h % stride) % stride
    pw = (stride - w % stride) % stride
    out = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")
    return out, (h, w)


def _peaks(heatmap: np.ndarray, thresh: float) -> list[list[tuple]]:
    """Per-channel local maxima after gaussian smoothing."""
    all_peaks = []
    pid = 0
    for c in range(heatmap.shape[-1]):
        hm = cv2.GaussianBlur(heatmap[..., c], (0, 0), 3)
        up = np.zeros_like(hm); up[1:] = hm[:-1]
        down = np.zeros_like(hm); down[:-1] = hm[1:]
        left = np.zeros_like(hm); left[:, 1:] = hm[:, :-1]
        right = np.zeros_like(hm); right[:, :-1] = hm[:, 1:]
        mask = (hm >= up) & (hm >= down) & (hm >= left) & (hm >= right) & (hm > thresh)
        ys, xs = np.nonzero(mask)
        peaks = []
        for x, y in zip(xs, ys):
            peaks.append((x, y, heatmap[y, x, c], pid))
            pid += 1
        all_peaks.append(peaks)
    return all_peaks


class OpenposeDetector:
    def __init__(
        self,
        body_weights: Optional[str] = None,
        hand_weights: Optional[str] = None,
        face_weights: Optional[str] = None,
        device="cuda",
    ):
        from magicdance_tpu_torch.convert.torch_convert import load_torch_state
        from magicdance_tpu_torch.models.openpose import (
            BodyPoseNet,
            FacePoseNet,
            HandPoseNet,
            convert_body_pose,
            convert_face_pose,
            convert_hand_pose,
        )

        self.device = resolve_device(device)
        self.nets: dict = {}

        def load(path, converter, net):
            if path is None:
                return None
            net.load_state_dict(converter(load_torch_state(path)), strict=True)
            return net.to(self.device, torch.float32).eval()

        self.nets["body"] = load(body_weights, convert_body_pose, BodyPoseNet())
        self.nets["hand"] = load(hand_weights, convert_hand_pose, HandPoseNet())
        self.nets["face"] = load(face_weights, convert_face_pose, FacePoseNet())

    @torch.inference_mode()
    @full_fp32()
    def _apply(self, name: str, x: np.ndarray):
        """The net on an NHWC float batch, in full fp32 (no TF32); NHWC numpy
        outputs."""
        out = self.nets[name](torch.from_numpy(x).to(self.device).permute(0, 3, 1, 2))
        if isinstance(out, tuple):
            return tuple(o.permute(0, 2, 3, 1).float().cpu().numpy() for o in out)
        return out.permute(0, 2, 3, 1).float().cpu().numpy()

    # -- body --------------------------------------------------------------
    def detect_body(self, img: np.ndarray, thresh1=0.1, thresh2=0.05):
        """img: (H, W, 3) uint8 RGB. Returns (candidate (N,4), subset (P,20))
        in pixel coords — the classic OpenPose output layout."""
        assert self.nets["body"] is not None, "body weights not loaded"
        H, W = img.shape[:2]
        scale = BOXSIZE / H
        resized = cv2.resize(img, (int(W * scale), int(H * scale)))
        padded, (rh, rw) = _pad_to_stride(resized)
        x = padded[None].astype(np.float32) / 256.0 - 0.5
        paf, heat = self._apply("body", x)
        paf = np.asarray(paf[0], np.float32)
        heat = np.asarray(heat[0], np.float32)
        # upsample to image size (ref body.py resizes twice via stride then crop)
        heat = cv2.resize(heat, (padded.shape[1], padded.shape[0]))[:rh, :rw]
        heat = cv2.resize(heat, (W, H))
        paf = cv2.resize(paf, (padded.shape[1], padded.shape[0]))[:rh, :rw]
        paf = cv2.resize(paf, (W, H))

        all_peaks = _peaks(heat[..., :18], thresh1)
        candidate = np.array([p for ch in all_peaks for p in ch], dtype=np.float32)
        if candidate.size == 0:
            return candidate.reshape(0, 4), np.zeros((0, 20), np.float32)

        # PAF scoring per limb
        connections = []
        for k, (pa, pb) in enumerate(LIMB_SEQ):
            ca = all_peaks[pa - 1]
            cb = all_peaks[pb - 1]
            score_map = paf[..., PAF_IDX[k]]
            conns = []
            for i, a in enumerate(ca):
                for j, b in enumerate(cb):
                    vec = np.array([b[0] - a[0], b[1] - a[1]], np.float32)
                    norm = max(np.linalg.norm(vec), 1e-5)
                    u = vec / norm
                    xs = np.linspace(a[0], b[0], 10).astype(int)
                    ys = np.linspace(a[1], b[1], 10).astype(int)
                    vals = score_map[ys, xs]  # (10, 2)
                    scores = vals[:, 0] * u[0] + vals[:, 1] * u[1]
                    score_pen = scores.mean() + min(0.5 * H / norm - 1, 0)
                    if (scores > thresh2).sum() > 8 and score_pen > 0:
                        conns.append((i, j, score_pen, a[3], b[3]))
            conns.sort(key=lambda c: -c[2])
            used_a, used_b, chosen = set(), set(), []
            for i, j, s, ida, idb in conns:
                if i not in used_a and j not in used_b:
                    chosen.append((ida, idb, s))
                    used_a.add(i)
                    used_b.add(j)
            connections.append(chosen)

        # assemble people
        subset = -1 * np.ones((0, 20), np.float32)
        for k, (pa, pb) in enumerate(LIMB_SEQ):
            ia, ib = pa - 1, pb - 1
            for ida, idb, s in connections[k]:
                found = [si for si in range(len(subset))
                         if subset[si, ia] == ida or subset[si, ib] == idb]
                if len(found) == 1:
                    si = found[0]
                    if subset[si, ib] != idb:
                        subset[si, ib] = idb
                        subset[si, -1] += 1
                        subset[si, -2] += candidate[int(idb), 2] + s
                    elif subset[si, ia] != ida:
                        subset[si, ia] = ida
                        subset[si, -1] += 1
                        subset[si, -2] += candidate[int(ida), 2] + s
                elif len(found) >= 2:
                    s1, s2 = found[:2]
                    membership = ((subset[s1] >= 0).astype(int)
                                  + (subset[s2] >= 0).astype(int))[:-2]
                    if (membership == 2).sum() == 0:  # merge
                        subset[s1, :-2] += subset[s2, :-2] + 1
                        subset[s1, -2:] += subset[s2, -2:]
                        subset[s1, -2] += s
                        subset = np.delete(subset, s2, 0)
                else:
                    row = -1 * np.ones(20, np.float32)
                    row[ia], row[ib] = ida, idb
                    row[-1] = 2
                    row[-2] = candidate[int(ida), 2] + candidate[int(idb), 2] + s
                    subset = np.vstack([subset, row])
        keep = [si for si in range(len(subset))
                if subset[si, -1] >= 4 and subset[si, -2] / subset[si, -1] >= 0.4]
        return candidate, subset[keep]

    # -- ROIs --------------------------------------------------------------
    @staticmethod
    def hand_rois(candidate, subset, H, W):
        """Wrist/elbow/shoulder-based hand boxes (ref util.py handDetect)."""
        rois = []
        for person in subset:
            for (sh, el, wr, left) in ((5, 6, 7, True), (2, 3, 4, False)):
                ids = person[[sh, el, wr]]
                if (ids < 0).any():
                    continue
                p = candidate[ids.astype(int), :2]
                ratio = 0.33
                x = p[2, 0] + ratio * (p[2, 0] - p[1, 0])
                y = p[2, 1] + ratio * (p[2, 1] - p[1, 1])
                dist_we = np.linalg.norm(p[2] - p[1])
                dist_es = np.linalg.norm(p[1] - p[0])
                width = 1.5 * max(dist_we, 0.9 * dist_es)
                rois.append((int(x - width / 2), int(y - width / 2), int(width), left))
        return [
            (max(0, x), max(0, y), min(w, min(W - max(0, x), H - max(0, y))), l)
            for x, y, w, l in rois if w > 20
        ]

    @staticmethod
    def face_roi(candidate, person, H, W):
        """Nose/eyes/ears-based face box (ref util.py faceDetect)."""
        idxs = [0, 14, 15, 16, 17]  # nose, eyes, ears
        pts = [candidate[int(person[i]), :2] for i in idxs if person[i] >= 0]
        if len(pts) < 2:
            return None
        pts = np.array(pts)
        cx, cy = pts[:, 0].mean(), pts[:, 1].mean()
        # np.ptp: NumPy 2 removed ndarray.ptp, which the JAX copy calls
        width = 3.0 * max(np.ptp(pts[:, 0]), np.ptp(pts[:, 1]), 20)
        x, y = int(cx - width / 2), int(cy - width / 2)
        x, y = max(0, x), max(0, y)
        w = int(min(width, W - x, H - y))
        return (x, y, w) if w > 20 else None

    def _roi_peaks(self, name, crop, n_points, thresh=0.1):
        pad, (rh, rw) = _pad_to_stride(cv2.resize(crop, (BOXSIZE, BOXSIZE)))
        x = pad[None].astype(np.float32) / 256.0 - 0.5
        maps = np.asarray(self._apply(name, x)[0], np.float32)
        maps = cv2.resize(maps, (crop.shape[1], crop.shape[0]))
        pts = np.full((n_points, 2), -1.0, np.float32)
        for c in range(n_points):
            hm = cv2.GaussianBlur(maps[..., c], (0, 0), 3)
            y, xx = np.unravel_index(np.argmax(hm), hm.shape)
            if hm[y, xx] > thresh:
                pts[c] = (xx, y)
        return pts

    # -- full pipeline -----------------------------------------------------
    def __call__(self, img: np.ndarray, include_hands: bool = True,
                 include_faces: bool = True) -> PoseResult:
        H, W = img.shape[:2]
        candidate, subset = self.detect_body(img)

        body = np.full((len(subset), 18, 2), -1.0, np.float32)
        for pi, person in enumerate(subset):
            for j in range(18):
                if person[j] >= 0:
                    body[pi, j] = candidate[int(person[j]), :2] / (W, H)

        hands = []
        if include_hands and self.nets["hand"] is not None:
            for (x, y, w, _l) in self.hand_rois(candidate, subset, H, W):
                crop = img[y : y + w, x : x + w]
                if crop.size == 0:
                    continue
                pts = self._roi_peaks("hand", crop, 21)
                valid = pts[:, 0] >= 0
                pts[valid] = (pts[valid] + (x, y)) / (W, H)
                hands.append(pts)

        faces = []
        if include_faces and self.nets["face"] is not None:
            for person in subset:
                roi = self.face_roi(candidate, person, H, W)
                if roi is None:
                    continue
                x, y, w = roi
                crop = img[y : y + w, x : x + w]
                if crop.size == 0:
                    continue
                pts = self._roi_peaks("face", crop, 70)
                valid = pts[:, 0] >= 0
                pts[valid] = (pts[valid] + (x, y)) / (W, H)
                faces.append(pts)

        return PoseResult(
            body=body,
            hands=np.stack(hands) if hands else None,
            faces=np.stack(faces) if faces else None,
        )
