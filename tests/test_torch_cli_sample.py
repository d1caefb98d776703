"""The port's sampling CLI (`magicdance_tpu_torch.cli.sample`) on the CPU, as
tests/test_cli_sample_eval.py drives the JAX CLI: the image and --video
smoke runs on a tiny config, the turbo flags against the JAX argparser's
SampleConfig, the flag set, the copied preprocessing bit-equal to JAX's, and
a --checkpoint run against `MagicPosePipeline.sample_frames` on the same
weights and seed."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import magicdance_tpu.config as jcfg
from magicdance_tpu.cli import sample as jsample
from magicdance_tpu.convert import torch_convert as J
from magicdance_tpu.data import transforms as jtr
from magicdance_tpu_torch import config as C
from magicdance_tpu_torch.cli import sample as tsample
from magicdance_tpu_torch.convert.torch_convert import reference_key_map
from magicdance_tpu_torch.data import transforms as ttr
from test_cli_sample_eval import tiny_model_json
from torch_port_util import reference_state, torch_single_thread  # noqa: F401


def make_inputs(tmp_path, frames=3):
    rs = np.random.RandomState(0)
    ref = tmp_path / "ref.png"
    Image.fromarray(rs.randint(0, 255, (40, 30, 3)).astype(np.uint8)).save(ref)
    pose_dir = tmp_path / "poses"
    pose_dir.mkdir()
    for i in range(frames):
        Image.fromarray(rs.randint(0, 255, (40, 30, 3)).astype(np.uint8)).save(
            pose_dir / f"{i:03d}.png")
    cfg = tmp_path / "model.json"
    tiny_model_json(cfg)
    return ["--model_config", str(cfg), "--reference", str(ref), "--pose_dir", str(pose_dir),
            "--size", "32", "--device", "cpu"]


def pngs(out):
    return sorted(f for f in os.listdir(out) if f.endswith(".png"))


def test_cli_sample_smoke(tmp_path):
    out = tmp_path / "out"
    tsample.main(make_inputs(tmp_path) + ["--output", str(out), "--steps", "2", "--gif",
                                          "--mp4", "--profile", str(tmp_path / "prof")])
    assert pngs(out) == ["000.png", "001.png", "002.png"]
    assert (out / "out.gif").exists() and (out / "out.mp4").stat().st_size > 0
    assert np.asarray(Image.open(out / "000.png")).shape == (32, 32, 3)
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0  # torch.profiler trace


def test_load_yaml_matches_jax(tmp_path):
    import yaml

    cfg = {"model": {"variant": "appearance_pose_temporal",
                     "unet": {"model_channels": 64, "channel_mult": [1, 2],
                              "use_motion_modules": True}},
           "freeze": "motion_only", "video_frames": 8, "optim": {"learning_rate": 3e-5}}
    path = tmp_path / "train.yaml"
    path.write_text(yaml.safe_dump(cfg))
    got = C.load_yaml(str(path))
    assert C.to_dict(got) == jcfg.to_dict(jcfg.load_yaml(str(path)))
    assert got.model.unet.channel_mult == (1, 2) and got.freeze is C.FreezeRegime.MOTION_ONLY


def test_cli_sample_video_mode(tmp_path):
    """--video routes through the temporal variant and overlap sampling."""
    import json

    argv = make_inputs(tmp_path, frames=6)
    cfg = json.load(open(tmp_path / "model.json"))
    cfg["variant"] = "appearance_pose_temporal"
    cfg["unet"].update(use_motion_modules=True, motion_num_heads=2)
    json.dump(cfg, open(tmp_path / "model.json", "w"))
    out = tmp_path / "out"
    tsample.main(argv + ["--output", str(out), "--steps", "2", "--video", "--window", "4",
                         "--stride", "3"])
    assert len(pngs(out)) == 6


def test_cli_sample_without_device_asks_for_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    argv = [a for a in make_inputs(tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="cuda"):
        tsample.main(argv + ["--output", str(tmp_path / "out")])


TURBO = ["--steps", "4", "--cfg_interval", "0.15", "0.85", "--uncond_every", "2",
         "--pose_every", "2", "--deepcache_every", "2", "--bank_every", "3",
         "--bank_downsample", "2", "--self_kv_downsample", "2", "--deepcache_level", "1",
         "--eta", "0.5", "--cfg", "5.0", "--window", "8", "--stride", "6"]


def test_cli_sample_turbo_flags_reach_sample_config(tmp_path, monkeypatch):
    """The JAX CLI's SampleConfig (caught at its pipeline) and the port's
    from the same flags are equal; the port samples frames with them."""
    import magicdance_tpu.pipeline as jpipe

    seen = []

    class StubPipeline:
        def __init__(self, cfg, tokenizer=None):
            pass

        def fast_init_params(self, *a, **k):
            pass

        def cast_model_params(self, *a, **k):
            pass

        def sample_frames(self, rng, poses, ref, scfg, **kw):
            seen.append(scfg)
            return np.zeros(poses.shape, np.float32)

    monkeypatch.setattr(jpipe, "MagicPosePipeline", StubPipeline)
    argv = make_inputs(tmp_path, frames=2)
    jax_argv = [a for a in argv if a not in ("--device", "cpu")] + TURBO
    jsample.main(jax_argv + ["--output", str(tmp_path / "jax_out")])
    (want,) = seen
    args = tsample.build_argparser().parse_args(argv + TURBO + ["--output", "x"])
    got = tsample.sample_config(args)
    assert C.to_dict(got) == jcfg.to_dict(want)
    assert got.cfg_interval == (0.15, 0.85) and got.deepcache_level == 1

    out = tmp_path / "out"
    tsample.main(argv + ["--output", str(out), "--steps", "4", "--cfg_interval", "0.15", "0.85",
                         "--uncond_every", "2", "--pose_every", "2", "--deepcache_every", "2"])
    assert len(pngs(out)) == 2


def test_cli_sample_flags_are_jax_flags_plus_device():
    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.type, a.required,
                         a.const, a.choices)
                for a in parser._actions if a.dest != "help"}

    got, want = flags(tsample.build_argparser()), flags(jsample.build_argparser())
    assert got.pop("device") == (("--device",), "cuda", None, None, False, None, None)
    assert got == want


@pytest.mark.parametrize("shape", [(40, 30, 3), (30, 41, 3), (64, 64, 3)])
def test_preprocessing_bit_equal_to_jax(shape):
    rs = np.random.RandomState(sum(shape))
    img = rs.randint(0, 255, shape).astype(np.uint8)
    # a white margin for remove_white_border to trim
    img[:3] = 255
    img[:, -2:] = 250
    for fn in ("remove_white_border", "center_crop_square"):
        np.testing.assert_array_equal(getattr(ttr, fn)(img), getattr(jtr, fn)(img))
    for size, crop in ((32, True), (48, False)):
        np.testing.assert_array_equal(ttr.prepare_image(img, size, crop),
                                      jtr.prepare_image(img, size, crop))
    white = np.full(shape, 255, np.uint8)
    assert ttr.remove_white_border(white) is white


@pytest.mark.parametrize("batch", [0, 2])
def test_cli_sample_checkpoint_matches_sample_frames(tmp_path, batch):
    """A tiny reference-layout .th through --checkpoint gives the frames of
    `MagicPosePipeline.sample_frames` called directly on the same weights
    (here through the JAX converter and `load_jax_params`) and seed; with
    --batch 2, three frames go as two chunks, the second padded."""
    from magicdance_tpu_torch.config import SampleConfig
    from magicdance_tpu_torch.pipeline import MagicPosePipeline

    argv = make_inputs(tmp_path)
    cfg = C.load_json(str(tmp_path / "model.json"), C.ModelConfig)
    sd = reference_state(cfg, reference_key_map(cfg), seed=21)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "model_state-7.th")
    out = tmp_path / "out"
    tsample.main(argv + ["--output", str(out), "--steps", "3", "--seed", "5", "--batch",
                         str(batch), "--checkpoint", str(tmp_path / "model_state-7.th")])
    got = np.stack([np.asarray(Image.open(out / f)) for f in pngs(out)])

    pipe = MagicPosePipeline(cfg, device="cpu")
    pipe.load_jax_params(J.convert_magicpose_state(
        sd, jcfg.load_json(str(tmp_path / "model.json"), jcfg.ModelConfig)))

    def read(path):
        return jtr.prepare_image(np.asarray(Image.open(path).convert("RGB")), 32)

    ref = torch.from_numpy(jtr.to_model_range(read(tmp_path / "ref.png"))[None])
    poses = np.stack([jtr.to_hint_range(read(tmp_path / "poses" / f"{i:03d}.png"))
                      for i in range(3)])
    chunks = [poses] if batch == 0 else [poses[:2], np.concatenate([poses[2:], poses[2:]])]
    want = []
    for chunk in chunks:
        imgs = pipe.sample_frames(torch.from_numpy(chunk), ref, SampleConfig(steps=3),
                                  generator=torch.Generator().manual_seed(5))
        want.extend(jtr.from_model_range(f) for f in imgs.numpy())
    np.testing.assert_array_equal(got, np.stack(want[:3]))
    assert got.std() > 0
