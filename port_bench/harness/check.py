"""The numbers that decide `correct`: the program's results against the
plain reference's, each held to a limit that the traffic file states.

Serving: over the requests of the check's sample, the widest relative gap
of a frame, ||x - reference|| / ||reference||, of the latents the sampler
handed to the VAE decode, and of the images against the reference's decode
of those latents, over the frames the reference recomputed (all, or the
traffic's `check_frames`). Training: the
widest relative gap of a step's loss; and, by the worst leaf, the gap
between the program's and the reference's norm of a leaf's first clipped
gradient and of its change after the first steps, each against the larger
of the reference's norm of that leaf and the median leaf's. Leaves whose
reference gradient is under a thousandth of the median leaf's (nought to
rounding, moved by round-off alone) are left out of the change.
"""

from __future__ import annotations

import statistics

import torch

QUIET_LEAF = 1e-3


def frame_gap(images: torch.Tensor, reference: torch.Tensor) -> float:
    diff = (images.double() - reference.double()).flatten(1).norm(dim=1)
    return float((diff / reference.double().flatten(1).norm(dim=1)).max())


def rows_of(x: torch.Tensor, rows) -> torch.Tensor:
    """The frames `rows` of x (None: all of them)."""
    return x if rows is None else x[rows]


def serve_numbers(items) -> dict:
    """Over the checked requests, each (program images, program latents,
    reference latents, the reference's decode of the program's latents,
    the frames the reference recomputed or None for all): the widest frame
    gap of the latents (the trajectory from the start) and of the images
    against the decode of the program's own latents (the last stage, from
    the program's state)."""
    if not items:
        return {"latent_gap": float("nan"), "decode_gap": float("nan")}
    return {"latent_gap": max(frame_gap(rows_of(lat, rows), ref_lat)
                              for _, lat, ref_lat, _, rows in items),
            "decode_gap": max(frame_gap(rows_of(img, rows), ref_img)
                              for img, _, _, ref_img, rows in items)}


def leaf_gap(got: dict, want: dict, keys) -> float:
    keys = list(keys)
    if not keys:
        return 0.0
    med = statistics.median(want[k] for k in keys)
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in keys)


def train_numbers(got: dict, want: dict) -> dict:
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"]))
    g_med = statistics.median(want["grad1"].values())
    moving = [k for k, v in want["grad1"].items() if v >= QUIET_LEAF * g_med]
    return {"loss_gap": loss,
            "grad_gap": leaf_gap(got["grad1"], want["grad1"], want["grad1"]),
            "change_gap": leaf_gap(got["delta"], want["delta"], moving)}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(all within their limits, {name: {value, limit}})."""
    out = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(v == v and v <= limits[k] for k, v in numbers.items())  # NaN fails
    return ok, out
