"""The SDXL MagicPose of the port (`magicpose-sdxl`) against its plain fp32
reference, `port_bench/reference/sdxl.py`, at the tiny cut of
`torch_port_util.tiny_sdxl_model` on seeded random weights: the two towers,
the added vector, every bank entry, the ControlNet's residuals, the cond and
uncond eps, a 2-step request and its decode, a whole tiny run of the cell
through the benchmark's harness; at the published widths on the meta device
the bank, the UNet's parameters and the state-dict layout; and the paths
that do not carry the added vector refuse the configuration."""

from __future__ import annotations

import copy
import json
import math

import pytest
import torch

from magicdance_tpu_torch import config as T
from magicdance_tpu_torch.data.tokenizer import empty_prompt_ids
from magicdance_tpu_torch.models.clip import DualCLIPTextEncoder, repad
from magicdance_tpu_torch.models.magicpose import MagicPoseModel
from magicdance_tpu_torch.models.unet import UNet, num_bank_entries
from magicdance_tpu_torch.models.vae import AutoencoderKL
from magicdance_tpu_torch.ops.schedules import make_ddim_schedule
from magicdance_tpu_torch.pipeline import MagicPosePipeline, added_vector
from magicdance_tpu_torch.sampling.ddim import ddim_sample
from magicdance_tpu_torch.sampling.overlap import ddim_sample_video
from magicdance_tpu_torch.train.trainer import Trainer
from port_bench import run
from port_bench.harness import weights as W
from port_bench.harness.serve import ServeCell
from port_bench.harness.spec import load_cell
from port_bench.harness.train import TrainCell
from port_bench.reference import sdxl
from port_bench.reference.model import Numerics
from torch_port_util import SDXL_CONFIG, tiny_sdxl_model, torch_single_thread  # noqa: F401

SEED = 2**31 + 2323
# fp32 on both sides: only the order of the sums differs
GAP = 1e-4


def gap(got, want) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm())


@pytest.fixture(scope="module")
def tiny():
    """(model dict, port pipeline, reference networks) with the same weights,
    every leaf N(0, 0.1^2)."""
    m = tiny_sdxl_model()
    nets = sdxl.networks(m)
    gen = torch.Generator().manual_seed(SEED % 2**32)
    states = {n: {k: torch.randn(p.shape, generator=gen) * 0.1
                  for k, p in nets[n].named_parameters()} for n in nets}
    ref = {n: W.materialize(nets[n], states[n], "cpu") for n in nets}
    pipe = MagicPosePipeline(T.from_dict(T.ModelConfig, m), device="cpu")
    pipe.load_state_dicts(states)
    return m, pipe, ref


@pytest.fixture(scope="module")
def inputs():
    g = torch.Generator().manual_seed(7)
    return dict(pose=torch.rand(2, 128, 128, 3, generator=g),
                image=torch.rand(1, 128, 128, 3, generator=g) * 2 - 1,
                x_T=torch.randn(1, 16, 16, 4, generator=g).expand(2, 16, 16, 4),
                x=torch.randn(2, 16, 16, 4, generator=g),
                ref_latent=torch.randn(1, 16, 16, 4, generator=g),
                prompt=torch.cat([torch.tensor([[49406]]), torch.randint(0, 49406, (1, 5),
                                                                         generator=g),
                                  torch.full((1, 71), 49407)], dim=1))


@pytest.fixture(scope="module")
def conditioning(tiny):
    _, pipe, ref = tiny
    ids = torch.from_numpy(empty_prompt_ids(1)).long()
    with torch.no_grad():
        ctx, pooled = pipe.clip(ids)
        rctx, rpooled = ref["clip"](ids)
    return (ctx, added_vector(pooled, 128, 128)), (rctx, sdxl.added_vector(rpooled, 128, 128))


@pytest.mark.parametrize("prompt", ["empty", "words"])
def test_two_towers_give_the_context_and_the_pooled_embedding(tiny, inputs, prompt):
    _, pipe, ref = tiny
    ids = (torch.from_numpy(empty_prompt_ids(1)).long() if prompt == "empty"
           else inputs["prompt"])
    with torch.no_grad():
        ctx, pooled = pipe.clip(ids)
        want_ctx, want_pooled = ref["clip"](ids)
    assert ctx.shape == (1, 77, 32) and pooled.shape == (1, 16)
    assert gap(ctx, want_ctx) < GAP and gap(pooled, want_pooled) < GAP
    # tower g reads its ids padded with 0 after EOT, tower l with EOS
    g = pipe.clip.tower_g
    zeros = repad(ids, g.cfg)
    assert int((zeros == 0).sum()) == 77 - int((ids != 49407).sum()) - 1
    with torch.no_grad():
        assert torch.equal(ctx[..., 16:], g(zeros))
        assert not torch.equal(ctx[..., 16:], g(ids))


def test_added_vector_is_the_pooled_embedding_and_the_size_sinusoids(conditioning):
    (_, y), (_, want) = conditioning
    assert y.shape == (1, 16 + 6 * 256)
    assert gap(y, want) < GAP
    pooled = y[:, :16]
    freqs = [math.exp(-math.log(10000) * i / 128) for i in range(128)]
    hand = [pooled[0].tolist()]
    for v in (128, 128, 0, 0, 128, 128):   # original size, crop top-left, target size
        hand.append([math.cos(v * f) for f in freqs] + [math.sin(v * f) for f in freqs])
    hand = torch.tensor([sum(hand, [])], dtype=torch.float64)
    assert float((y.double() - hand).abs().max()) < 1e-5


def test_every_bank_entry_matches(tiny, inputs, conditioning):
    _, pipe, ref = tiny
    (ctx, y), (rctx, ry) = conditioning
    t = torch.full((1,), 501)
    with torch.no_grad():
        bank = pipe.model.compute_bank(inputs["ref_latent"], t, ctx, y)
        want = ref["model"].bank(inputs["ref_latent"], t, rctx, ry)
    # encoder 2 x 2 + 2 x 3, middle 3, decoder 3 x 3 + 3 x 2
    assert len(bank) == len(want) == num_bank_entries(pipe.model.unet.cfg) == 28
    assert max(gap(a, b) for a, b in zip(bank, want)) < GAP


def test_controlnet_residuals_match(tiny, inputs, conditioning):
    _, pipe, ref = tiny
    (ctx, y), (rctx, ry) = conditioning
    t = torch.full((2,), 301)
    with torch.no_grad():
        res = pipe.model.compute_pose_residuals(inputs["x"], inputs["pose"], t,
                                                ctx.expand(2, -1, -1), y=y.expand(2, -1))
        want = ref["model"].pose_control(inputs["x"], inputs["pose"], t, rctx, ry)
    assert len(res) == len(want) == 10   # 9 skip residuals and the middle one
    assert max(gap(a, b) for a, b in zip(res, want)) < GAP


def test_cond_and_uncond_eps_match(tiny, inputs, conditioning):
    _, pipe, ref = tiny
    (ctx, y), (rctx, ry) = conditioning
    t = torch.full((2,), 701)
    x, pose = inputs["x"], inputs["pose"]
    with torch.no_grad():
        bank = pipe.model.compute_bank(inputs["ref_latent"], t[:1], ctx, y)
        cond = pipe.model(x, t, ctx.expand(2, -1, -1), y=y.expand(2, -1), bank=bank,
                          pose_hint=pose)
        uncond = pipe.model(x, t, ctx.expand(2, -1, -1), y=y.expand(2, -1), uc=True)
        rbank = ref["model"].bank(inputs["ref_latent"], t[:1], rctx, ry)
        want_c = ref["model"].cond(x, t, rctx, ry, rbank, pose)
        want_u = ref["model"].uncond(x, t, rctx, ry)
    assert gap(cond, want_c) < GAP and gap(uncond, want_u) < GAP
    assert gap(cond, uncond) > 1e-2   # the bank and the ControlNet show


def test_two_step_request_and_its_decode_match(tiny, inputs):
    m, pipe, ref = tiny
    pose, image, x_T = inputs["pose"], inputs["image"], inputs["x_T"]
    latents = pipe.sample_frames(pose, image, T.SampleConfig(steps=2), x_T=x_T, decode=False)
    want = sdxl.sample(ref, m, pose, image, x_T, 2, 7.0, Numerics())
    assert latents.shape == (2, 16, 16, 4)
    assert gap(latents, want) < GAP
    images = pipe.decode_latents(latents)
    assert gap(images, sdxl.decode(ref["vae"], latents, m, Numerics())) < GAP


def test_request_spans_name_the_towers_and_the_vector(tiny, inputs):
    """Under a profiler a request's `md.clip` spans (the prompt's and the
    empty prompt's) each hold `md.clip tower=l` and `md.clip tower=g`, and
    `md.cond.vector` builds both added vectors once, before the first step."""
    from torch.profiler import ProfilerActivity, profile

    _, pipe, _ = tiny
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.sample_frames(inputs["pose"], inputs["image"], T.SampleConfig(steps=1),
                           x_T=inputs["x_T"], decode=False)
    spans = sorted((e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("md."))
    names = [n for _, n in spans]
    clip = [n for n in names if n.startswith("md.clip")]
    assert clip == ["md.clip", "md.clip tower=l", "md.clip tower=g"] * 2
    assert names.count("md.cond.vector") == 1
    assert names.index("md.cond.vector") < names.index("md.ddim.step i=0")


def test_a_tiny_run_of_the_cell_is_correct(monkeypatch):
    """The cell's configuration file at the tiny cut, through the
    benchmark's harness on the CPU: set-up, a window, the check of one
    frame of a finished request against the family its file names. The
    FLOP count (the reference on the meta device, ~15 s here) is left out."""
    monkeypatch.setattr(ServeCell, "flops_per_request", lambda self: 0.0)
    cell = load_cell("sdxl-pose.serve-f4")
    assert cell.config["reference"] == "sdxl" and cell.traffic["check_frames"] == 1
    cell.config = dict(cell.config, model=tiny_sdxl_model())
    cell.traffic = dict(cell.traffic, frames=2, steps=2, warmup_steps=1, trace_steps=1)
    out = run.measure(cell, SEED, 0.1, trace=False, device="cpu")
    assert out["correct"], out["check"]
    assert out["attempted"] >= 1 and set(out["check"]) == {"latent_gap", "decode_gap"}


def test_published_widths_on_the_meta_device():
    with open(SDXL_CONFIG) as f:
        file = json.load(f)
    cfg = T.from_dict(T.ModelConfig, file["model"])
    with torch.device("meta"):
        model = MagicPoseModel(cfg)
        nets = {"model": model, "vae": AutoencoderKL(cfg.vae),
                "clip": DualCLIPTextEncoder(cfg.clip, cfg.clip_g)}
    assert num_bank_entries(cfg.unet) == 70
    params = sum(p.numel() for p in model.unet.parameters())
    assert params == file["params"] and f"{params / 1e9:.4g}" == "2.567"
    assert cfg.unet.heads_at(640) == (10, 64) and cfg.unet.heads_at(1280) == (20, 64)
    ref = sdxl.networks(file["model"])
    for name, net in nets.items():
        got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
        assert got == {k: tuple(p.shape) for k, p in ref[name].named_parameters()}, name
    assert W.layout(file)["model"] == [(k, tuple(p.shape))
                                       for k, p in ref["model"].named_parameters()]


def test_sd15_keeps_its_layout_and_takes_no_vector():
    """SD1.5 defaults: no label_emb, 1x1-conv projections, one depth, the
    port's own fields left out of its dict, and a vector refused."""
    cfg = T.ModelConfig()
    with torch.device("meta"):
        unet = UNet(cfg.unet)
    keys = unet.state_dict()
    assert not any(k.startswith("label_emb") for k in keys)
    assert keys["enc_attn_0.proj_in.weight"].shape == (320, 320, 1, 1)
    assert num_bank_entries(cfg.unet) == 16
    assert "adm_in_channels" not in T.to_dict(cfg)["unet"] and "clip_g" not in T.to_dict(cfg)
    tiny = T.UNetConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                        attention_resolutions=(1, 2), num_heads=2, context_dim=16)
    with pytest.raises(ValueError, match="takes no added vector"):
        UNet(tiny)(torch.zeros(1, 8, 8, 4), torch.zeros(1), torch.zeros(1, 77, 16),
                   y=torch.zeros(1, 8))


REFUSED = {"turbo": dict(uncond_every=2), "deepcache": dict(deepcache_every=3),
           "fused_cfg": dict(fused_cfg=True), "self_kv": dict(self_kv_downsample=2)}


@pytest.mark.parametrize("lever", sorted(REFUSED))
def test_samplers_that_do_not_carry_the_vector_refuse(tiny, inputs, conditioning, lever):
    _, pipe, _ = tiny
    (ctx, y), _ = conditioning
    scfg = T.SampleConfig(steps=2, **REFUSED[lever])
    with pytest.raises(NotImplementedError, match="added vector"):
        ddim_sample(pipe.model, pipe.sched, make_ddim_schedule(pipe.sched, 2), scfg,
                    inputs["x_T"], ctx, ctx, reference_latent=inputs["ref_latent"],
                    pose_hint=inputs["pose"], y=y, uncond_y=y)


def test_video_and_dual_control_refuse(tiny, inputs, conditioning):
    m, pipe, _ = tiny
    (ctx, _), _ = conditioning
    with pytest.raises(NotImplementedError, match="overlap-window"):
        ddim_sample_video(pipe.model, pipe.sched, make_ddim_schedule(pipe.sched, 2),
                          T.SampleConfig(steps=2), inputs["x_T"], ctx, ctx)
    dual = copy.deepcopy(m)
    dual["variant"] = "dual_control"
    with pytest.raises(NotImplementedError, match="DUAL_CONTROL"):
        MagicPoseModel(T.from_dict(T.ModelConfig, dual))


def test_training_refuses():
    cell = load_cell("sdxl-pose.serve-f4")
    config = dict(cell.config, model=tiny_sdxl_model(),
                  train={"batch_size_per_device": 1, "image_size": 128})
    traffic = {"kind": "train", "check_steps": 1, "image_size": 128}
    with pytest.raises(NotImplementedError, match="training"):
        Trainer(T.TrainConfig(model=T.from_dict(T.ModelConfig, config["model"])), device="cpu")
    drv = TrainCell(config, traffic, SEED, "cpu")
    with pytest.raises(NotImplementedError, match="training"):
        drv.setup()
    with pytest.raises(NotImplementedError, match="no training traffic"):
        drv.reference(Numerics())
