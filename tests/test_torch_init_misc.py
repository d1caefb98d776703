"""The Flax-style initialisation (`models/init.py`, `Trainer.init_flax`, the
training CLI's start without a checkpoint) against the JAX package's
`model.init` / `vae.init` / `clip.init`, and the small copies of this slice:
`utils/testing.py` (`randomize_zero_kernels`, `weight_deviation`),
`data/text_filters.py::TextFilter`, `MetricLogger.log_image`, and dropout
(served as the identity, refused in training as JAX refuses it).

The init is compared leaf by leaf on a small configuration (JAX's init
compiles in ~25 s here at the tiny widths of the other tests): the same
state-dict keys, the same all-zero and all-one leaves, and on every other
leaf of >= 4096 elements a standard deviation within 5% of JAX's (the draws
are torch's, so only the distributions can agree).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicdance_tpu import config as J
from magicdance_tpu_torch import config as C
from magicdance_tpu_torch.convert.from_jax import flax_to_state_dict
from magicdance_tpu_torch.train.trainer import Trainer
from torch_port_util import port_cfg
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)


def small_jax_cfg() -> J.ModelConfig:
    unet = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                attention_resolutions=(1,), num_heads=2, context_dim=64)
    return J.ModelConfig(
        variant=J.ModelVariant.APPEARANCE_POSE, unet=J.UNetConfig(**unet),
        pose_control=J.ControlNetConfig(**unet),
        vae=J.VAEConfig(base_channels=32, channel_mult=(1, 2), num_res_blocks=1),
        clip=J.CLIPTextConfig(vocab_size=300, hidden_size=64, num_layers=1, num_heads=2,
                              max_length=77),
        latent_size=8, dtype="float32")


def kind(t: torch.Tensor) -> str:
    t = t.float()
    return "zeros" if bool((t == 0).all()) else "ones" if bool((t == 1).all()) else "random"


def test_flax_init_matches_jax_init():
    from magicdance_tpu.models import AutoencoderKL, CLIPTextEncoder, MagicPoseModel

    jc = small_jax_cfg()
    x = jnp.zeros((1, 8, 8, 4))
    m, v, c = MagicPoseModel(jc), AutoencoderKL(jc.vae), CLIPTextEncoder(jc.clip)
    trees = {
        "model": jax.jit(lambda r: m.init(r, x, jnp.zeros((1,), jnp.int32),
                                          jnp.zeros((1, 77, 64)), reference_noisy=x,
                                          pose_hint=jnp.zeros((1, 64, 64, 3))))(
            jax.random.PRNGKey(0)),
        "vae": jax.jit(lambda r: v.init(r, jnp.zeros((1, 16, 16, 3)), r))(
            jax.random.PRNGKey(1)),
        "clip": jax.jit(lambda r: c.init(r, jnp.zeros((1, 77), jnp.int32)))(
            jax.random.PRNGKey(2)),
    }
    tr = Trainer(C.TrainConfig(model=port_cfg(jc), optim=C.OptimConfig(
        frozen_dtype="float32")), device="cpu")
    tr.init_flax(seed=4)
    n_zero = n_cmp = 0
    for name, tree in trees.items():
        want = flax_to_state_dict(jax.tree.map(np.asarray, tree))
        got = getattr(tr, name).state_dict()
        assert set(got) == set(want), name
        for k, w in want.items():
            g = got[k]
            assert kind(g) == kind(w), (k, kind(g), kind(w))
            n_zero += kind(w) == "zeros" and w.dim() >= 2
            if kind(w) == "random" and w.numel() >= 4096:
                n_cmp += 1
                ratio = float(g.float().std()) / float(w.std())
                assert abs(ratio - 1) < 0.05, (k, ratio)
                assert abs(float(g.float().mean())) < 0.1 * float(w.std()) + 1e-3, k
    # the zero convs, proj_outs and conv_outs of three networks
    assert n_zero >= 15 and n_cmp >= 30
    # lecun_normal is truncated at two standard units, in the Flax fan-in
    w = tr.model.unet.enc_res_0.conv_in.weight
    std = 1.0 / np.sqrt(9 * w.shape[1]) / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std + 1e-7


def test_flax_init_zero_leaves_make_a_zero_output():
    """At the Flax init the UNet's output and the ControlNet's residuals are
    exactly zero (zero conv_out, zero convs): a run without a checkpoint
    starts where JAX's does."""
    tr = Trainer(C.TrainConfig(model=port_cfg(small_jax_cfg()), optim=C.OptimConfig(
        frozen_dtype="float32")), device="cpu")
    tr.init_flax(seed=0)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 8, 4, generator=g)
    ctx = torch.randn(2, 77, 64, generator=g)
    t = torch.tensor([10, 900])
    pose = torch.rand(2, 64, 64, 3, generator=g)
    with torch.no_grad():
        res = tr.model.compute_control_residuals(x, pose, t, ctx)
        out = tr.model(x, t, ctx, reference_noisy=x[:1], pose_hint=pose)
    assert all(bool((r == 0).all()) for r in res)
    assert bool((out == 0).all())


def test_cli_without_checkpoint_starts_from_the_flax_init(tmp_path, monkeypatch):
    """The training CLI with no --init_checkpoint, frozen in int8: at its
    first step every zero-init kernel is exactly zero (int8 zeros for the
    frozen ones), every norm scale one, and the loader says which decode
    path it took."""
    from magicdance_tpu_torch.cli.train import main
    from test_cli_train import make_dataset, tiny_config_json
    from test_torch_cli_train import _first_step_weights, _Stop

    make_dataset(tmp_path)
    tiny_config_json(tmp_path / "cfg.json", steps=2)
    cfg = json.load(open(tmp_path / "cfg.json"))
    cfg["optim"]["frozen_dtype"] = "int8"
    json.dump(cfg, open(tmp_path / "cfg.json", "w"))
    seen = _first_step_weights(monkeypatch)
    with pytest.raises(_Stop):
        main(["--config", str(tmp_path / "cfg.json"), "--data", str(tmp_path),
              "--output", str(tmp_path / "run"), "--steps", "2", "--image_size", "32",
              "--device", "cpu", "--seed", "5"])
    tr = Trainer(C.load_json(str(tmp_path / "run" / "config.json")), device="cpu")
    zero = {f"{n}.weight" for n, mod in tr.model.named_modules() if getattr(mod, "zero_init", 0)}
    assert len(zero) >= 10
    model = seen["model"]
    assert any(t.dtype == torch.int8 for t in model.values())
    for k in zero:
        assert bool((model[k] == 0).all()), k
    norms = {f"{n}.weight" for n, mod in tr.model.named_modules()
             if isinstance(mod, (torch.nn.GroupNorm, torch.nn.LayerNorm))}
    assert norms and all(bool((model[k] == 1).all()) for k in norms)
    conv_in = model["unet.conv_in.weight"]
    assert conv_in.dtype == torch.float32 or conv_in.dtype == torch.int8
    assert kind(model["pose_control.enc_res_0.conv_in.weight"]) == "random"


# --------------------------------------------------------------------------
# utils/testing.py, TextFilter, log_image
# --------------------------------------------------------------------------


def test_randomize_zero_kernels():
    from magicdance_tpu_torch.models import MagicPoseModel
    from magicdance_tpu_torch.models.init import flax_init_
    from magicdance_tpu_torch.utils.testing import randomize_zero_kernels

    net = flax_init_(MagicPoseModel(port_cfg(small_jax_cfg())), torch.Generator().manual_seed(0))
    before = {k: t.clone() for k, t in net.state_dict().items()}
    randomize_zero_kernels(net, scale=0.05, seed=3)
    after = net.state_dict()
    changed = [k for k in before if not torch.equal(before[k], after[k])]
    assert changed and all(before[k].dim() >= 2 and kind(before[k]) == "zeros" for k in changed)
    assert all(kind(after[k]) == "random" for k in changed)
    assert all(kind(t) != "zeros" for k, t in after.items() if t.dim() >= 2)
    assert all(kind(after[k]) == "zeros" for k in before
               if before[k].dim() == 1 and kind(before[k]) == "zeros")  # biases stay
    std = np.mean([float(after[k].std()) for k in changed])
    assert 0.04 < std < 0.06


def test_weight_deviation_cases_of_the_jax_helper():
    """tests/test_misc_features.py::test_weight_deviation, on state dicts."""
    from magicdance_tpu.utils.testing import weight_deviation as jax_dev
    from magicdance_tpu_torch.utils.testing import weight_deviation

    a = {"unet.attn1.weight": torch.ones(2, 2), "unet.conv.weight": torch.zeros(2, 2)}
    b = {"unet.attn1.weight": torch.zeros(2, 2), "unet.conv.weight": torch.zeros(2, 2),
         "extra.weight": torch.ones(1)}
    assert weight_deviation(a, b) == 2.0
    assert weight_deviation(a, b, "attn1") == 4.0
    assert weight_deviation(a, b, "conv") == 0.0
    assert weight_deviation(a, a) == 0.0
    assert weight_deviation(a, b, "nope") == 0.0
    ja = {"unet": {"attn1": {"kernel": np.ones((2, 2), np.float32)},
                   "conv": {"kernel": np.zeros((2, 2), np.float32)}}}
    jb = {"unet": {"attn1": {"kernel": np.zeros((2, 2), np.float32)},
                   "conv": {"kernel": np.zeros((2, 2), np.float32)}},
          "extra": {"kernel": np.ones((1,), np.float32)}}
    for kw in ("", "attn1", "conv"):
        assert weight_deviation(a, b, kw) == jax_dev(ja, jb, kw)
    lin = torch.nn.Linear(3, 2)
    assert weight_deviation(lin, lin.state_dict()) == 0.0


def test_text_filter_cases():
    """tests/test_misc_features.py::test_text_filter on the port's copy, and
    the same verdicts as JAX's on more captions."""
    from magicdance_tpu.data.text_filters import TextFilter as JF
    from magicdance_tpu_torch.data.text_filters import TextFilter

    f = TextFilter()
    assert f("")
    assert f("a person dancing in a studio")
    assert not f("explicit content")
    assert not f("1234 5678 90 12 345")
    assert not f("これは日本語のキャプションです")
    g = TextFilter(extra_blocklist=["dancing"])
    assert not g("a person dancing")
    jf, jg = JF(min_words=3), JF(extra_blocklist=["studio"])
    tf, tg = TextFilter(min_words=3), TextFilter(extra_blocklist=["studio"])
    for text in ("", "two words", "a person dancing in a studio", "NSFW clip", "über café 1",
                 "v2 of 3 4 5 6 7", "a girl's dance"):
        assert tf(text) == jf(text) and tg(text) == jg(text), text


def test_log_image_matches_jax(tmp_path):
    from magicdance_tpu.utils.logging import MetricLogger as JLogger
    from magicdance_tpu_torch.utils.logging import MetricLogger

    class Board:
        def __init__(self):
            self.images = []

        def add_image(self, tag, arr, step):
            self.images.append((tag, np.array(arr), step))

        def close(self):
            pass

    img = np.random.RandomState(0).randint(0, 255, (8, 6, 3)).astype(np.uint8)
    boards = []
    for i, cls in enumerate((MetricLogger, JLogger)):
        log = cls(str(tmp_path / str(i)), enable_tb=False)
        log._tb = Board()
        log.log_image(3, "grid", img)
        log.log_image(4, "chw", img.transpose(2, 0, 1))
        boards.append(log._tb.images)
        log.close()
    got, want = boards
    assert [(t, s) for t, _, s in got] == [(t, s) for t, _, s in want] == [("grid", 3),
                                                                            ("chw", 4)]
    for (_, a, _), (_, b, _) in zip(got, want):
        assert a.shape == (3, 8, 6)
        np.testing.assert_array_equal(a, b)
    quiet = MetricLogger(str(tmp_path / "q"), enable_tb=False)
    quiet.log_image(1, "x", img)  # no TensorBoard: nothing to do
    quiet.close()


# --------------------------------------------------------------------------
# dropout
# --------------------------------------------------------------------------


def test_dropout_serves_as_the_identity():
    """UNetConfig.dropout > 0: the models and the pipeline build, and serve
    exactly what dropout 0 serves (JAX's dropout is deterministic there)."""
    from magicdance_tpu_torch.config import SampleConfig
    from magicdance_tpu_torch.pipeline import MagicPosePipeline

    cfg0 = port_cfg(small_jax_cfg())
    # the pipeline's tokenizer needs CLIP's whole vocabulary
    cfg0 = dataclasses.replace(cfg0, clip=dataclasses.replace(cfg0.clip, vocab_size=49408))
    cfg1 = dataclasses.replace(cfg0, unet=dataclasses.replace(cfg0.unet, dropout=0.1))
    p0 = MagicPosePipeline(cfg0, device="cpu")
    p0.init_params(seed=2, scale=0.1)
    p1 = MagicPosePipeline(cfg1, device="cpu")
    for name in ("model", "vae", "clip"):
        getattr(p1, name).load_state_dict(getattr(p0, name).state_dict())
    g = torch.Generator().manual_seed(0)
    pose = torch.rand(2, 64, 64, 3, generator=g)
    ref = torch.rand(1, 64, 64, 3, generator=g) * 2 - 1
    x_T = torch.randn(2, 8, 8, 4, generator=g)
    scfg = SampleConfig(steps=2)
    a = p0.sample_frames(pose, ref, scfg, x_T=x_T, decode=False)
    b = p1.sample_frames(pose, ref, scfg, x_T=x_T, decode=False)
    assert torch.equal(a, b)


def test_dropout_cannot_train_as_in_jax():
    from torch_port_util import jax_train_cfg, make_train_batch, port_batch, port_train_cfg

    cfg = port_train_cfg(jax_train_cfg())
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, unet=dataclasses.replace(cfg.model.unet, dropout=0.1)))
    tr = Trainer(cfg, device="cpu")
    tr.init_random(seed=0, scale=0.1)
    with pytest.raises(RuntimeError, match="InvalidRngError"):
        tr.train_step(port_batch(make_train_batch(1)))
