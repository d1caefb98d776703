"""Tiny cells for the CPU tests: the benchmark's configurations cut to a
few channels, every other setting as in the files."""

from __future__ import annotations

import copy

from port_bench.harness.spec import Cell, load_cell

TINY_UNET = dict(model_channels=32, channel_mult=[1, 2], num_res_blocks=1,
                 attention_resolutions=[1, 2], num_heads=2, context_dim=16)


def tiny_cell(name: str, frames: int = 2, steps: int = 2) -> Cell:
    """A training cell takes at most two samples a step: stage 2 two images,
    stage 3 its configuration's one clip, of `frames` frames."""
    cell = load_cell(name)
    config = copy.deepcopy(cell.config)
    m = config["model"]
    m["unet"].update(TINY_UNET, motion_num_heads=2)
    m["pose_control"].update(TINY_UNET)
    m["vae"].update(base_channels=32, channel_mult=[1, 1, 2, 2], num_res_blocks=1)
    m["clip"].update(hidden_size=16, num_layers=1, num_heads=2)
    m.update(latent_size=8, dtype="float32")
    traffic = dict(cell.traffic, frames=frames, steps=steps, warmup_steps=1, trace_steps=1)
    if "window" in traffic:
        traffic.update(window=frames, stride=max(1, frames - 1))
    if traffic["kind"] == "train":
        traffic["image_size"] = 64
        train = config["train"]
        train.update(batch_size_per_device=min(2, train["batch_size_per_device"]),
                     video_frames=frames)
        train["optim"]["warmup_steps"] = 1
    cell.config, cell.traffic = config, traffic
    return cell
