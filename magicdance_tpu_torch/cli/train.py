"""Training CLI: the MagicPose curriculum, on one GPU or data parallel.

Counterpart of `magicdance_tpu.cli.train` (ref train_tiktok.py:546 main;
scripts/appearance_control_pretraining.sh and
scripts/appearance_disentangle_pose_control.sh): stages 1 and 2 train on
(reference, target, pose) image pairs, stage 3 (the motion modules) on
clips of `video_frames` frames folded into the batch. Stage selection is
explicit (`--stage 1|2|3` or a JSON TrainConfig). Runs on the GPU unless
`--device cpu`.

Under `torchrun` every process joins the group (NCCL on the GPU, gloo with
`--device cpu`): the global batch is `--batch` (per device) times the
ranks, each rank trains on its rows of it (data parallel with ZeRO-1, see
`train.trainer`), and rank 0 alone prints, logs, writes the sample grids and
saves the checkpoints; every rank resumes from the newest one.

`--init_checkpoint` takes a full reference checkpoint (`model_state-*.th`,
`control_sd15_ini.ckpt`; it must hold the VAE and CLIP weights) through
`convert.torch_convert`; `--motion_module_checkpoint` overlays AnimateDiff
motion modules on the UNet (stage 3, ref train_tiktok.py:146-192). A resumed
run restores its own checkpoint over either. Without a checkpoint the
weights start where the JAX CLI's Flax `init` starts them
(`Trainer.init_flax`: lecun-normal kernels, zero output convs and zero
convs, so the UNet output and the ControlNet's residuals are zero at step 0),
drawn from `--seed`.

The data loader decodes through the native C++ batch loader
(`data/native.py`, built from `native/image_core.cpp` at first use) when it
builds, else through PIL, as the JAX package does; the first line of the run
says which. Under `frozen_dtype="int8"` the sample grid's pipeline gets the
dequantized (bf16) frozen weights.

Usage:
  python -m magicdance_tpu_torch.cli.train --stage 2 --data TikTok-v4 \\
      --output runs/stage2 [--steps 100000] [--device cuda]
  torchrun --nproc_per_node 8 -m magicdance_tpu_torch.cli.train --stage 2 \\
      --data TikTok-v4 --output runs/stage2 [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default=None, help="TrainConfig JSON")
    p.add_argument("--stage", type=int, default=2, choices=(1, 2, 3))
    p.add_argument("--data", required=True, help="TikTok-v4 root")
    p.add_argument("--output", required=True)
    p.add_argument("--init_checkpoint", default=None,
                   help="reference torch checkpoint (.th/.ckpt, with VAE and CLIP "
                        "weights) to initialize from")
    p.add_argument("--motion_module_checkpoint", default=None,
                   help="AnimateDiff motion-module checkpoint for stage 3, merged "
                        "onto the UNet")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--batch", type=int, default=None, help="per-device batch")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--resume", action="store_true", default=True)
    p.add_argument("--save_steps", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--init_method", default=None,
                   help="process-group rendezvous (e.g. file:///shared/rdzv) for ranks "
                        "given by RANK / WORLD_SIZE; default: torchrun's environment")
    return p


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from magicdance_tpu_torch import config as C
    from magicdance_tpu_torch.data.loader import PrefetchLoader
    from magicdance_tpu_torch.data.tiktok import TikTokPairDataset
    from magicdance_tpu_torch.data.tiktok_video import TikTokClipDataset
    from magicdance_tpu_torch.data.tokenizer import empty_prompt_ids
    from magicdance_tpu_torch.parallel.multihost import initialize_distributed, is_primary
    from magicdance_tpu_torch.train.checkpoint import CheckpointManager
    from magicdance_tpu_torch.train.trainer import Trainer
    from magicdance_tpu_torch.utils.logging import MetricLogger

    if args.config:
        cfg = C.load_json(args.config, C.TrainConfig)
    else:
        cfg = {1: C.stage1_appearance_pretrain, 2: C.stage2_pose_control,
               3: C.stage3_motion}[args.stage]()
    updates = {"output_dir": args.output, "seed": args.seed, "image_size": args.image_size}
    if args.steps:
        updates["num_train_steps"] = args.steps
    if args.batch:
        updates["batch_size_per_device"] = args.batch
    if args.save_steps:
        updates["save_steps"] = args.save_steps
    cfg = dataclasses.replace(cfg, **updates)
    if args.lr:
        cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim,
                                                                 learning_rate=args.lr))

    initialize_distributed(backend="gloo" if args.device == "cpu" else "nccl",
                           init_method=args.init_method)
    primary = is_primary()

    def say(msg: str) -> None:
        if primary:
            print(msg, flush=True)

    os.makedirs(args.output, exist_ok=True)
    if primary:
        C.save_json(cfg, os.path.join(args.output, "config.json"))

    trainer = Trainer(cfg, device=args.device)
    device = trainer.device
    global_batch = cfg.batch_size_per_device * trainer.data.size
    mesh = (dict(zip(trainer.mesh.mesh_dim_names, trainer.mesh.shape))
            if trainer.mesh is not None else None)
    say(f"[train] device={device} mesh={mesh} global_batch={global_batch}")
    # ---- parameter init ---------------------------------------------------
    from magicdance_tpu_torch.convert import torch_convert as TC

    states = None
    if args.init_checkpoint:
        states = TC.convert_magicpose_state(TC.load_torch_state(args.init_checkpoint), cfg.model)
        if "vae" not in states or "clip" not in states:
            raise ValueError("checkpoint lacks VAE/CLIP weights; supply a full "
                             "model_state/.ckpt file")
    else:
        say("[train] Flax-style init (no --init_checkpoint)")
        trainer.init_flax(seed=cfg.seed)
    if args.motion_module_checkpoint:
        # stage-3 surgery: AnimateDiff motion weights over the UNet's
        # (merge_state_dict_mm, ref train_tiktok.py:146-192)
        if states is None:
            states = {name: getattr(trainer, name).state_dict()
                      for name in ("model", "vae", "clip")}
        mm = TC.convert_motion_modules(TC.load_torch_state(args.motion_module_checkpoint),
                                       cfg.model.unet)
        states["model"] = TC.merge_motion_state(states["model"],
                                                {f"unet.{k}": v for k, v in mm.items()})
        say(f"[train] merged {len({k.split('.')[0] for k in mm})} motion modules from "
              f"{args.motion_module_checkpoint}")
    if states is not None:
        trainer.load_state_dicts(states["model"], states["vae"], states["clip"])

    ckpt = CheckpointManager(os.path.join(args.output, "checkpoints"), cfg.save_total_limit)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        trainer.load_state_dict(ckpt.restore(map_location=device))
        start_step = trainer.step
        say(f"[train] resumed from step {start_step}")

    # ---- data: (reference, target, pose) pairs, or F-frame clips folded
    # into the batch axis (ref train_tiktok.py:1189-1200); empty prompts ----
    F = trainer.num_frames
    ids = empty_prompt_ids(global_batch * F, cfg.model.clip.max_length)
    if not cfg.model.has_temporal:
        from magicdance_tpu_torch.data import native

        say(f"[train] image decode: {native.describe()}")

    def it_factory(worker: int):
        if cfg.model.has_temporal:
            ds = TikTokClipDataset(root=args.data, image_size=cfg.image_size,
                                   clip_len=cfg.video_frames, frame_stride=cfg.frame_stride,
                                   use_pose=cfg.model.has_pose,
                                   seed=cfg.seed * 1000 + worker)
        else:
            ds = TikTokPairDataset(root=args.data, image_size=cfg.image_size,
                                   img_bin_limit=cfg.img_bin_limit,
                                   use_pose=cfg.model.has_pose,
                                   seed=cfg.seed * 1000 + worker)
        for batch in ds.batches(global_batch):
            batch["input_ids"] = ids
            if not cfg.model.has_pose:
                batch.pop("pose", None)
            yield batch

    loader = PrefetchLoader(it_factory, workers=2, device=device, mesh=trainer.mesh)

    # ---- periodic visualization (ref train_tiktok.py:388-531,1258-1268:
    # every logging_gen_steps, sample a batch and write a
    # GT | pose | generated | reference comparison grid) --------------------
    pipe = None

    def visualize(it: int, batch: dict) -> None:
        nonlocal pipe
        from magicdance_tpu_torch.config import SampleConfig
        from magicdance_tpu_torch.data.transforms import from_model_range
        from magicdance_tpu_torch.pipeline import MagicPosePipeline
        from magicdance_tpu_torch.models.quant import dequantize_state_dict
        from magicdance_tpu_torch.utils.video import save_image_grid

        if pipe is None:
            pipe = MagicPosePipeline(cfg.model, device=device)
        for name in ("model", "vae", "clip"):
            # int8 frozen leaves go in as their bf16 values (models.quant)
            getattr(pipe, name).load_state_dict(
                dequantize_state_dict(getattr(trainer, name).state_dict()))
        n = min(2, batch["image"].shape[0])
        pose = batch["pose"][:n] if "pose" in batch else None
        ref = batch["reference"][:1]
        gen = pipe.sample_frames(pose, ref, SampleConfig(steps=cfg.vis_steps, cfg_scale=7.0),
                                 video=cfg.model.has_temporal,
                                 generator=torch.Generator(device=device).manual_seed(it))
        gen = gen.cpu().numpy()
        rows = []
        for i in range(n):
            row = [from_model_range(batch["image"][i].cpu().numpy())]
            if pose is not None:
                row.append((pose[i].cpu().numpy() * 255).astype(np.uint8))
            row.append(from_model_range(gen[i]))
            row.append(from_model_range(batch["reference"][0].cpu().numpy()))
            rows.append(row)
        out = os.path.join(args.output, "samples", f"step_{it:08d}.png")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        save_image_grid(rows, out)
        say(f"[train] wrote sample grid {out}")

    # ---- loop -----------------------------------------------------------
    logger = MetricLogger(os.path.join(args.output, "tb")) if primary else None
    try:
        batch = next(loader)
        t_last = time.time()
        for it in range(start_step, cfg.num_train_steps):
            vis_batch = batch if (it + 1) % cfg.logging_gen_steps == 0 else None
            metrics = trainer.train_step(batch)
            batch = next(loader)
            if (it + 1) % cfg.logging_steps == 0:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t_last
                t_last = time.time()
                ips = cfg.logging_steps * global_batch * F / dt
                if logger is not None:
                    logger.log(it + 1, {**m, "images_per_sec": ips})
                say(f"[train] step {it + 1} loss={m['loss']:.4f} {ips:.1f} img/s")
            if vis_batch is not None and primary:
                try:
                    visualize(it + 1, vis_batch)
                except Exception as e:  # visualization must never kill training
                    say(f"[train] visualize failed: {e!r}")
            if (it + 1) % cfg.save_steps == 0:
                ckpt.save(it + 1, trainer.state_dict())
                say(f"[train] saved step {it + 1}")
        ckpt.save(cfg.num_train_steps, trainer.state_dict())
    finally:
        loader.close()
        if logger is not None:
            logger.close()
        if dist.is_initialized():
            dist.destroy_process_group()
    say("[train] done")


if __name__ == "__main__":
    main()
