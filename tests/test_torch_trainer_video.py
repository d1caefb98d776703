"""Stage-3 (motion-module) training: the port's trainer against the JAX
package's `Trainer` on tests/test_video_training.py's tiny temporal config
(`MOTION_ONLY`, motion_num_heads 2) with clips of F = 4 frames folded into
the batch and one reference per clip. Setup, draws and tolerances as in
tests/test_torch_trainer.py: loss 1e-5 relative; gradients 2e-4 absolute and
relative; parameter updates to 2% of the learning rate. Also: per-clip
timesteps, the TrainState carried over leaf by leaf, the clip dataset and
the stage-3 CLI on the synthetic tree."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from magicdance_tpu import config as J
from magicdance_tpu_torch import config as T
from test_cli_train import make_dataset, tiny_config_json
from torch_port_util import (
    IMG,
    LAT,
    JaxReference,
    assert_tree_close,
    jax_draws,
    jax_train_cfg,
    port_trainer,
    to_port,
)
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

FRAMES, CLIPS = 4, 2


def temporal_train_cfg() -> J.TrainConfig:
    # adam_eps 1e-4 as in the stage-1 test: Adam normalizes each element, so
    # near-zero gradients would turn fp32 summation noise into O(lr) steps
    jc = jax_train_cfg(variant=J.ModelVariant.APPEARANCE_POSE_TEMPORAL,
                       freeze=J.FreezeRegime.MOTION_ONLY, video_frames=FRAMES,
                       optim=J.OptimConfig(learning_rate=1e-3, warmup_steps=1,
                                           adam_eps=1e-4, frozen_dtype="float32"))
    return dataclasses.replace(jc, model=dataclasses.replace(jc.model, unet=dataclasses.replace(
        jc.model.unet, use_motion_modules=True, motion_num_heads=2)))


def clip_batch(seed: int) -> dict:
    rs = np.random.RandomState(seed)
    n = CLIPS * FRAMES
    return {"image": rs.uniform(-1, 1, (n, IMG, IMG, 3)).astype(np.float32),
            "reference": rs.uniform(-1, 1, (CLIPS, IMG, IMG, 3)).astype(np.float32),
            "pose": rs.uniform(0, 1, (n, 8 * LAT, 8 * LAT, 3)).astype(np.float32),
            "input_ids": np.zeros((n, 5), np.int32)}


def draws(jc, rng):
    return jax_draws(jc, rng, n_image=CLIPS * FRAMES, n_ref=CLIPS, frames=FRAMES)


@pytest.fixture(scope="module")
def setup():
    jc = temporal_train_cfg()
    ref = JaxReference(jc, seed=11)
    return jc, ref, port_trainer(ref)


def test_stage3_loss_grads_and_steps_match_jax(setup):
    jc, ref, tr = setup
    assert tr.num_frames == FRAMES
    assert tr.train_params and all("motion" in k for k in tr.train_params)
    assert set(tr.train_params) == set(to_port(ref.state.train_params))
    batch, rng = clip_batch(1), jax.random.PRNGKey(2)
    (want_loss, _), want_g = ref.loss_and_grads(batch, rng)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _, grads = tr.loss_and_grads(tb, draws(jc, rng))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert_tree_close(grads, want_g)
    frozen = {k: p.detach().clone() for k, p in tr.model.named_parameters()
              if k not in tr.train_params}
    before = {k: p.detach().clone() for k, p in tr.train_params.items()}
    for i in range(2):
        batch, rng = clip_batch(3 + i), jax.random.PRNGKey(5 + i)
        metrics = tr.train_step({k: torch.from_numpy(v) for k, v in batch.items()},
                                draws(jc, rng))
        np.testing.assert_allclose(float(metrics["loss"]), ref.step(batch, rng), rtol=1e-5)
    want = to_port(ref.state.train_params)
    for k, p in tr.train_params.items():
        np.testing.assert_allclose((p.detach() - before[k]).numpy(),
                                   (want[k] - before[k]).numpy(), atol=0.02 * 1e-3, err_msg=k)
    assert any(not torch.equal(p.detach(), before[k]) for k, p in tr.train_params.items())
    assert all(torch.equal(p.detach(), frozen[k]) for k, p in tr.model.named_parameters()
               if k in frozen)


def test_stage3_draws_share_one_timestep_per_clip(setup):
    jc, _, tr = setup
    tb = {k: torch.from_numpy(v) for k, v in clip_batch(7).items()}
    d = tr.draw(tb)
    t = d.t.view(CLIPS, FRAMES)
    assert torch.equal(t, t[:, :1].expand(-1, FRAMES))
    assert d.noise.shape == d.vae_image.shape == (CLIPS * FRAMES, LAT, LAT, 4)
    assert d.vae_reference.shape == (CLIPS, LAT, LAT, 4)
    jd = draws(jc, jax.random.PRNGKey(8))
    assert torch.equal(jd.t.view(CLIPS, FRAMES), jd.t.view(CLIPS, FRAMES)[:, :1].expand(
        -1, FRAMES))


def test_motion_only_train_state_carries_every_leaf(setup):
    """`load_train_state` on a MOTION_ONLY TrainState: every trainable and
    frozen leaf (the motion modules' included) lands at its key, and exactly
    the motion modules require grad."""
    _, ref, tr = setup
    fresh = port_trainer(ref)
    sd = fresh.model.state_dict()
    carried = {**to_port(ref.state.train_params), **to_port(ref.state.frozen_params["model"])}
    assert set(carried) == set(sd)
    for k, v in carried.items():
        assert torch.equal(sd[k].float(), v), k
    for k, p in fresh.model.named_parameters():
        assert p.requires_grad == ("motion" in k), k
    assert any(k.startswith("unet.enc_motion_") for k in fresh.train_params)
    assert any(k.startswith("unet.dec_motion_") for k in fresh.train_params)


def test_clip_dataset_batches_and_loader(tmp_path):
    """tests/test_video_training.py's batch shapes, through the prefetch
    loader too."""
    from PIL import Image

    from magicdance_tpu_torch.data.loader import PrefetchLoader
    from magicdance_tpu_torch.data.tiktok_video import TikTokClipDataset

    for split in ("train_set", "pose_map_train_set"):
        vdir = tmp_path / split / "vid0"
        vdir.mkdir(parents=True)
        rs = np.random.RandomState(0)
        for i in range(20):
            Image.fromarray(rs.randint(0, 255, (32, 24, 3)).astype(np.uint8)).save(
                vdir / f"{i:04d}.png")
    ds = TikTokClipDataset(root=str(tmp_path), image_size=16, clip_len=4, frame_stride=2)
    batch = next(ds.batches(2))
    assert batch["image"].shape == (8, 16, 16, 3)
    assert batch["reference"].shape == (2, 16, 16, 3)
    assert batch["pose"].shape == (8, 16, 16, 3)
    assert batch["image"].min() >= -1 and batch["pose"].min() >= 0
    with PrefetchLoader(lambda w: ds.batches(2, seed=w), workers=1, device="cpu") as loader:
        got = next(loader)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        "image": (8, 16, 16, 3), "reference": (2, 16, 16, 3), "pose": (8, 16, 16, 3)}
    with pytest.raises(FileNotFoundError):
        TikTokClipDataset(root=str(tmp_path), clip_len=16, frame_stride=2)


def test_cli_stage3_trains_on_clips(tmp_path):
    """A stage-3 config (temporal variant, MOTION_ONLY, 4-frame clips) for 2
    steps on the synthetic tree: checkpoints, finite losses, a video sample
    grid."""
    from magicdance_tpu_torch.cli.train import main

    make_dataset(tmp_path)
    tiny_config_json(tmp_path / "cfg.json", steps=2)
    cfg = json.load(open(tmp_path / "cfg.json"))
    cfg["model"]["variant"] = "appearance_pose_temporal"
    cfg["model"]["unet"].update(use_motion_modules=True, motion_num_heads=2)
    cfg.update(freeze="motion_only", video_frames=FRAMES, frame_stride=2)
    json.dump(cfg, open(tmp_path / "cfg.json", "w"))
    out = tmp_path / "run"
    main(["--config", str(tmp_path / "cfg.json"), "--data", str(tmp_path), "--output",
          str(out), "--steps", "2", "--image_size", "32", "--device", "cpu"])
    assert sorted(os.listdir(out / "checkpoints")) == ["step_00000002"]
    lines = [json.loads(line) for line in open(out / "tb" / "metrics.jsonl")]
    assert [rec["step"] for rec in lines] == [1, 2]
    assert all(np.isfinite(rec["loss"]) for rec in lines)
    assert os.listdir(out / "samples") == ["step_00000002.png"]
    state = torch.load(out / "checkpoints" / "step_00000002" / "state.pt", weights_only=False)
    assert state["step"] == 2 and all("motion" in k for k in state["opt"]["mu"])


def test_cli_stage3_picks_the_motion_preset(tmp_path, monkeypatch):
    """`--stage 3` builds the trainer from `stage3_motion()` (16-frame clips,
    motion modules, MOTION_ONLY)."""
    import magicdance_tpu_torch.train.trainer as trainer_mod
    from magicdance_tpu_torch.cli.train import main

    seen = []

    class Stop(Exception):
        pass

    def fake_trainer(cfg, device):
        seen.append(cfg)
        raise Stop

    monkeypatch.setattr(trainer_mod, "Trainer", fake_trainer)
    with pytest.raises(Stop):
        main(["--stage", "3", "--data", str(tmp_path), "--output", str(tmp_path / "o"),
              "--device", "cpu"])
    (cfg,) = seen
    want = dataclasses.replace(T.stage3_motion(), output_dir=str(tmp_path / "o"), seed=42,
                               image_size=512)
    assert T.to_dict(cfg) == T.to_dict(want)
    assert cfg.model.has_temporal and cfg.freeze is T.FreezeRegime.MOTION_ONLY
