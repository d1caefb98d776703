"""The port's training CLI end to end on the CPU: the synthetic TikTok-v4
tree and tiny stage-2 config of tests/test_cli_train.py, 2 steps: a
checkpoint, a finite loss in metrics.jsonl, the sample grid, and no loader
thread left behind; then a resume to step 3. The two checkpoint flags on tiny
reference-layout files. Plus the prefetch loader's close() on its own."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from magicdance_tpu_torch.cli.train import main
from magicdance_tpu_torch.data.loader import PrefetchLoader
from test_cli_train import make_dataset, tiny_config_json
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)


def _args(tmp_path, out, steps):
    return ["--config", str(tmp_path / "cfg.json"), "--data", str(tmp_path),
            "--output", str(out), "--steps", str(steps), "--image_size", "32",
            "--device", "cpu"]


def test_cli_train_end_to_end_and_resume(tmp_path):
    make_dataset(tmp_path)
    tiny_config_json(tmp_path / "cfg.json", steps=2)
    out = tmp_path / "run"
    threads_before = threading.active_count()

    main(_args(tmp_path, out, 2))

    assert sorted(os.listdir(out / "checkpoints")) == ["step_00000002"]
    lines = [json.loads(line) for line in open(out / "tb" / "metrics.jsonl")]
    assert [rec["step"] for rec in lines] == [1, 2]
    assert all(np.isfinite(rec["loss"]) for rec in lines)
    assert os.listdir(out / "samples") == ["step_00000002.png"]
    deadline = time.time() + 5
    while threading.active_count() > threads_before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= threads_before, "loader threads left running"
    state = torch.load(out / "checkpoints" / "step_00000002" / "state.pt",
                       weights_only=False)
    assert state["step"] == 2

    main(_args(tmp_path, out, 3))  # resumes from step 2
    lines = [json.loads(line) for line in open(out / "tb" / "metrics.jsonl")]
    assert [rec["step"] for rec in lines] == [1, 2, 3]
    assert "step_00000003" in os.listdir(out / "checkpoints")


class _Stop(Exception):
    pass


def _first_step_weights(monkeypatch):
    """Stop the CLI at its first train step; the weights the trainer holds
    then, by network."""
    import magicdance_tpu_torch.train.trainer as trainer_mod

    seen = {}

    def first_step(self, batch, draws=None):
        for name in ("model", "vae", "clip"):
            seen[name] = {k: t.detach().clone() for k, t in
                          getattr(self, name).state_dict().items()}
        raise _Stop

    monkeypatch.setattr(trainer_mod.Trainer, "train_step", first_step)
    return seen


def _write_reference_ckpt(path, cfg, seed, vae_clip=True):
    from magicdance_tpu_torch.convert.torch_convert import reference_key_map
    from torch_port_util import reference_state

    pairs = reference_key_map(cfg, vae=vae_clip, clip=vae_clip)
    sd = {k: torch.from_numpy(v) for k, v in reference_state(cfg, pairs, seed).items()}
    torch.save(sd, path)
    return sd, pairs


@pytest.mark.parametrize("vae_clip", [True, False], ids=["full", "no_vae_clip"])
def test_cli_train_init_checkpoint(tmp_path, monkeypatch, vae_clip):
    """--init_checkpoint on a tiny reference-layout .th: the trainer starts
    from exactly those weights (trainable fp32, frozen cast to bf16); a file
    without VAE/CLIP weights raises ValueError."""
    from magicdance_tpu_torch import config as C

    make_dataset(tmp_path)
    tiny_config_json(tmp_path / "cfg.json", steps=2)
    cfg = C.load_json(str(tmp_path / "cfg.json"), C.TrainConfig).model
    sd, pairs = _write_reference_ckpt(tmp_path / "model_state-1.th", cfg, seed=11,
                                      vae_clip=vae_clip)
    seen = _first_step_weights(monkeypatch)
    argv = _args(tmp_path, tmp_path / "run", 2) + ["--init_checkpoint",
                                                   str(tmp_path / "model_state-1.th")]
    if not vae_clip:
        with pytest.raises(ValueError, match="lacks VAE/CLIP"):
            main(argv)
        return
    with pytest.raises(_Stop):
        main(argv)
    dtypes = set()
    for ref, port in pairs:
        net, key = port.split(".", 1)
        got = seen[net][key]
        dtypes.add(got.dtype)
        assert torch.equal(got, sd[ref].to(got.dtype)), port
    assert dtypes == {torch.float32, torch.bfloat16}  # trainable and frozen
    assert sum(len(v) for v in seen.values()) == len(pairs)


@pytest.mark.parametrize("with_init", [False, True], ids=["random_init", "init_checkpoint"])
def test_cli_train_motion_module_checkpoint(tmp_path, monkeypatch, with_init):
    """--motion_module_checkpoint on a tiny AnimateDiff-layout file (stage-3
    config): every motion module of the UNet holds the file's weights before
    the first step; with --init_checkpoint the rest holds the image
    checkpoint's."""
    from magicdance_tpu_torch import config as C
    from magicdance_tpu_torch.convert.torch_convert import convert_motion_modules
    from torch_ref import TorchMotionModule

    make_dataset(tmp_path)
    tiny_config_json(tmp_path / "cfg.json", steps=2)
    raw = json.load(open(tmp_path / "cfg.json"))
    raw["model"]["variant"] = "appearance_pose_temporal"
    raw["model"]["unet"].update(use_motion_modules=True, motion_num_heads=2)
    raw.update(freeze="motion_only", video_frames=4, frame_stride=2)
    json.dump(raw, open(tmp_path / "cfg.json", "w"))
    cfg = C.load_json(str(tmp_path / "cfg.json"), C.TrainConfig).model
    torch.manual_seed(12)
    sites = [("down_blocks.0.motion_modules.0", 32), ("down_blocks.1.motion_modules.0", 64),
             ("up_blocks.0.motion_modules.0", 64), ("up_blocks.0.motion_modules.1", 64),
             ("up_blocks.1.motion_modules.0", 32), ("up_blocks.1.motion_modules.1", 32)]
    mm = {f"{p}.{k}": v for p, ch in sites for k, v in TorchMotionModule(ch, 2).state_dict().items()}
    torch.save(mm, tmp_path / "mm_sd_v15.ckpt")
    argv = _args(tmp_path, tmp_path / "run", 2) + ["--motion_module_checkpoint",
                                                   str(tmp_path / "mm_sd_v15.ckpt")]
    if with_init:
        sd, pairs = _write_reference_ckpt(tmp_path / "model_state-1.th", cfg, seed=13)
        argv += ["--init_checkpoint", str(tmp_path / "model_state-1.th")]
    seen = _first_step_weights(monkeypatch)
    with pytest.raises(_Stop):
        main(argv)
    want = {f"unet.{k}": v for k, v in convert_motion_modules(mm, cfg.unet).items()}
    motion = {k for k in seen["model"] if "_motion_" in k}
    assert motion == set(want) and len({k.split(".")[1] for k in motion}) == 6
    for k, t in want.items():
        assert torch.equal(seen["model"][k], t), k
    if with_init:
        for ref, port in pairs:
            net, key = port.split(".", 1)
            got = seen[net][key]
            assert torch.equal(got, sd[ref].to(got.dtype)), port


def test_prefetch_loader_close_joins_threads():
    """close() terminates every worker and transfer thread, even with an
    infinite producer, and is safe to call twice."""
    def factory(worker):
        def gen():
            while True:
                yield {"x": np.zeros((2, 4), np.float32)}
        return gen()

    before = threading.active_count()
    loader = PrefetchLoader(factory, workers=2, host_depth=1, device_depth=1, device="cpu")
    batch = next(loader)
    assert isinstance(batch["x"], torch.Tensor) and batch["x"].shape == (2, 4)
    loader.close()
    for t in loader._threads:
        assert not t.is_alive(), "loader thread survived close()"
    loader.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
