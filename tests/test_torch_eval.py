"""PyTorch port of the eval-set path against the JAX package, on the CPU:
`data.tiktok.TikTokEvalDataset` and `cli/eval.py` (a tiny model JSON,
2 DDIM steps at 32x32, --batch 3 over 4 target frames: one full chunk and
one padded)."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
from PIL import Image

from magicdance_tpu.cli import eval as jeval
from magicdance_tpu.data.tiktok import TikTokEvalDataset as JEvalDataset
from magicdance_tpu_torch.cli import eval as teval
from magicdance_tpu_torch.cli import sample as tsample
from magicdance_tpu_torch.data.tiktok import TikTokEvalDataset
from test_cli_sample_eval import tiny_model_json
from torch_port_util import torch_single_thread  # noqa: F401


def write_tiktok_tree(root, videos: int, frames: int, seed: int) -> None:
    """`{root}/disco_test_set|pose_map_disco_test_set/vid{i}/{j:04d}.png`,
    seeded uint8 frames of 40x30 (not square: the center crop matters)."""
    rs = np.random.RandomState(seed)
    for split in ("disco_test_set", "pose_map_disco_test_set"):
        for v in range(videos):
            d = root / split / f"vid{v}"
            d.mkdir(parents=True)
            for i in range(frames):
                Image.fromarray(rs.randint(0, 255, (40, 30, 3)).astype(np.uint8)).save(
                    d / f"{i:04d}.png")


@pytest.mark.parametrize("rank,world,every_nth", [(0, 1, 1), (1, 2, 2)])
def test_eval_dataset_bit_equal_to_jax(tmp_path, rank, world, every_nth):
    """Frame 0 the reference, every `every_nth` later frame a target, videos
    split rank::world: every array and name equal to JAX's, bit for bit."""
    write_tiktok_tree(tmp_path, videos=3, frames=6, seed=1)
    kw = dict(root=str(tmp_path), image_size=32, every_nth=every_nth, rank=rank,
              world_size=world)
    got, want = list(TikTokEvalDataset(**kw)), list(JEvalDataset(**kw))
    assert [s["video"] for s in got] == [s["video"] for s in want]
    assert len(got) == (3 if world == 1 else 1)
    for g, w in zip(got, want):
        assert g["frame_names"] == w["frame_names"]
        assert len(g["frame_names"]) == len(range(1, 6, every_nth))
        for key in ("reference", "gt", "pose"):
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key])


def _files(root) -> dict:
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(root) for f in fs}


@pytest.fixture(scope="module")
def eval_runs(tmp_path_factory):
    """Both CLIs on one seeded tree (one 5-frame video: 4 targets) with the
    same flags; the port's with --device cpu."""
    root = tmp_path_factory.mktemp("tiktok")
    write_tiktok_tree(root, videos=1, frames=5, seed=0)
    cfg = root / "model.json"
    tiny_model_json(cfg)
    flags = ["--model_config", str(cfg), "--data", str(root), "--steps", "2", "--size", "32",
             "--batch", "3"]
    jeval.main(flags + ["--output", str(root / "jax_out")])
    records = teval.main(flags + ["--output", str(root / "port_out"), "--device", "cpu"])
    return root, cfg, records


def test_eval_cli_writes_jax_trees(eval_runs):
    """The same file names as JAX; gt_images and pose_maps byte-equal."""
    root, _, records = eval_runs
    want, got = _files(root / "jax_out"), _files(root / "port_out")
    assert sorted(got) == sorted(want)
    assert sorted(os.listdir(root / "port_out" / "vid0")) == ["gen_images", "gt_images",
                                                              "pose_maps"]
    assert len(os.listdir(root / "port_out" / "vid0" / "gen_images")) == 4
    for name, data in want.items():
        if not name.startswith(os.path.join("vid0", "gen_images")):
            assert got[name] == data, name
    assert [(r["video"], r["frames"]) for r in records] == [("vid0", 4)]


def test_eval_cli_frames_are_the_sampling_cli_s(eval_runs):
    """gen_images are the frames of `cli.sample.generate` run as the
    sampling CLI parses the same flags (its defaults for the seed, CFG, eta
    and the rest), on the dataset's arrays."""
    root, cfg, _ = eval_runs
    args = tsample.build_argparser().parse_args(
        ["--model_config", str(cfg), "--reference", "(arrays)", "--pose_dir", "(arrays)",
         "--output", "(unused)", "--steps", "2", "--size", "32", "--batch", "3",
         "--device", "cpu"])
    seq = next(iter(TikTokEvalDataset(root=str(root), image_size=32)))
    frames = tsample.generate(args, tsample.build_pipeline(args), seq["reference"], seq["pose"])
    for name, frame in zip(seq["frame_names"], frames):
        got = np.asarray(Image.open(root / "port_out" / "vid0" / "gen_images" / name))
        np.testing.assert_array_equal(got, frame)


def test_eval_cli_shards_by_process_group(monkeypatch):
    """--rank/--world default to the initialized process group's."""
    import torch.distributed as dist

    args = teval.build_argparser().parse_args(["--data", "d", "--output", "o"])
    assert teval.shard(args) == (0, 1)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 2)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    assert teval.shard(args) == (2, 4)
    args = teval.build_argparser().parse_args(["--data", "d", "--output", "o", "--rank", "1",
                                               "--world", "3"])
    assert teval.shard(args) == (1, 3)


def test_eval_cli_asks_for_the_gpu(eval_runs, monkeypatch):
    """Without --device the CLI runs on the GPU: none here, so it raises."""
    root, cfg, _ = eval_runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        teval.main(["--model_config", str(cfg), "--data", str(root), "--output",
                    str(root / "never"), "--steps", "2", "--size", "32"])
    assert not (root / "never").exists()
