"""chip_smoke.py holds the card's requests and stage-3 train step to exact
kernel launch plans (`serving_launch_plan`, `request_launch_plan` for fused
CFG, the turbo stacks and the fused GroupNorm, `stage3_launch_plan`).
Here each plan meets the wrapper calls of one narrow run on the CPU, where
every kernel site calls the same wrappers and Functions as on the card (they
take their plain versions here): one overlap-sampler step over overlapping
windows, and one stage-3 train step. The narrow model at 128x128 reaches
kernels A and B at its first level (256 positions) and the grouped kernel
at its six motion modules. At SD1.5 width the plans give the numbers the
card is held to."""

import pytest
import torch

import chip_smoke
from magicdance_tpu_torch import config as T
from magicdance_tpu_torch.models import layers
from magicdance_tpu_torch.ops import attention as A
from magicdance_tpu_torch.ops.kernels import flash_vjp as V
from magicdance_tpu_torch.ops.schedules import make_ddim_schedule
from magicdance_tpu_torch.pipeline import MagicPosePipeline
from magicdance_tpu_torch.sampling.ddim import ddim_sample
from magicdance_tpu_torch.sampling.overlap import ddim_sample_video
from magicdance_tpu_torch.train.trainer import Trainer
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)


def count_calls(monkeypatch) -> dict:
    """Count every wrapper call that launches a kernel on the card, by the
    LAUNCHES mode it counts under there."""
    calls = {}

    def counting(module, name, mode_of, launches=1):
        real = getattr(module, name)

        def wrapped(*a, **kw):
            mode = mode_of(a, kw)
            calls[mode] = calls.get(mode, 0) + launches
            return real(*a, **kw)
        monkeypatch.setattr(module, name, wrapped)

    def dq_mode(a, kw):
        two = (a[7] if len(a) > 7 else kw.get("k_bank")) is not None
        return "attention_dq_two_source" if two else "attention_dq"

    for module, name in ((A, "self_attention"),
                         (V, "self_attention_lse"), (V, "two_source_attention_lse"),
                         (V, "attention_dkv"), (V, "grouped_attention_bwd")):
        mode = {"grouped_attention_bwd": "grouped_bwd"}.get(name, name)
        counting(module, name, lambda a, kw, mode=mode: mode)
    counting(A, "two_source_attention", lambda a, kw: "two_source_attention_gated"
             if kw.get("bank_mask") is not None else "two_source_attention")
    counting(A, "grouped_attention", lambda a, kw: "grouped")
    # K8, two kernels a call: reached on the CPU once "cpu" is a fused device
    monkeypatch.setattr(layers, "FUSED_GN_DEVICES", ("cuda", "cpu"))
    counting(layers, "groupnorm_act", lambda a, kw: "groupnorm_silu", launches=2)
    counting(V, "grouped_attention", lambda a, kw: "grouped")
    counting(V, "attention_dq", dq_mode)
    return calls


def test_full_width_plans():
    temporal = T.ModelConfig(variant=T.ModelVariant.APPEARANCE_POSE_TEMPORAL,
                             unet=T.UNetConfig(use_motion_modules=True))
    # a 16-frame window at 512x512: 20 motion modules x 2 units x 2 passes;
    # K8 at the image model's 210 GroupNorm calls and the 20 motion modules'
    # norms of the cond and uncond passes, 2 launches a call
    assert chip_smoke.serving_launch_plan(temporal, 64, 16, 16) == {
        "self_attention": 36, "two_source_attention": 15, "grouped": 80,
        "groupnorm_silu": 2 * (210 + 2 * 20)}
    assert chip_smoke.serving_launch_plan(T.ModelConfig(), 64, 2, 1) == {
        "self_attention": chip_smoke.SELF_PER_STEP,
        "two_source_attention": chip_smoke.TWO_SOURCE_PER_STEP,
        "groupnorm_silu": chip_smoke.K8_PER_STEP}
    assert chip_smoke.stage3_launch_plan(T.stage3_motion(), 512, 1) == {
        "self_attention": 21, "two_source_attention": 1, "two_source_attention_lse": 28,
        "attention_dq_two_source": 14, "attention_dkv": 14, "grouped": 80,
        "grouped_bwd": 40}


def test_video_serving_plan_matches_counted_calls(monkeypatch):
    """One step of the overlap sampler, F = 10 frames in windows of 4,
    stride 3: four windows, 16 frames per pass."""
    cfg = chip_smoke.narrow_temporal_config()
    pipe = MagicPosePipeline(cfg, device="cpu")
    pipe.init_params(seed=0, scale=0.1)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(10, 16, 16, 4, generator=g)
    hint = torch.rand(10, 128, 128, 3, generator=g)
    ref = torch.randn(1, 16, 16, 4, generator=g)
    ctx = torch.randn(1, 77, 16, generator=g)
    scfg = T.SampleConfig(steps=1, window=4, stride=3)
    calls = count_calls(monkeypatch)
    out = ddim_sample_video(pipe.model, pipe.sched, make_ddim_schedule(pipe.sched, 1), scfg,
                            x, ctx, ctx, reference_latent=ref, pose_hint=hint,
                            window_offsets=[5])
    assert torch.isfinite(out).all()
    plan = chip_smoke.serving_launch_plan(cfg, 16, 16, 4)
    assert calls == plan
    # write pass 3 + ControlNet 1 + uncond 3; 3 bank reads; 6 motion
    # modules x 2 units x (cond + uncond); K8 at every GroupNorm (both
    # levels have 64 positions or more): the write pass's 17 SiLU and 7
    # transformer norms, the ControlNet's 8 + 3, the cond and the uncond
    # pass's 17 + 7 and 6 motion-module norms, two launches a call
    assert plan == {"self_attention": 3 + 1 + 3, "two_source_attention": 3,
                    "grouped": 6 * 2 * 2, "groupnorm_silu": 2 * (24 + 11 + 2 * 30)}


def test_stage3_plan_matches_counted_calls(monkeypatch):
    """One narrow stage-3 step, one clip of 4 frames at 128x128."""
    cfg = chip_smoke.narrow_stage3_config()
    tr = Trainer(cfg, device="cpu")
    tr.init_random(seed=0, scale=0.1)
    g = torch.Generator().manual_seed(1)
    batch = {"image": torch.rand(4, 128, 128, 3, generator=g) * 2 - 1,
             "reference": torch.rand(1, 128, 128, 3, generator=g) * 2 - 1,
             "pose": torch.rand(4, 128, 128, 3, generator=g),
             "input_ids": torch.zeros(4, 77, dtype=torch.long)}
    calls = count_calls(monkeypatch)
    metrics = tr.train_step(batch)
    assert torch.isfinite(metrics["loss"])
    plan = chip_smoke.stage3_launch_plan(cfg, 128, 1)
    assert calls == plan
    assert plan["grouped"] == 2 * plan["grouped_bwd"] > 0
    assert plan["two_source_attention"] == 1 and plan["attention_dq_two_source"] >= 1


TURBO = dict(deepcache_every=3, pose_every=3, uncond_every=2, cfg_interval=(0.15, 0.85),
             bank_every=3, bank_downsample=2, self_kv_downsample=2)
TURBO_MAX = dict(deepcache_every=5, pose_every=5, uncond_every=4, cfg_interval=(0.15, 0.85),
                 bank_every=8, bank_downsample=4, self_kv_downsample=4,
                 reuse_exact_first=2, reuse_exact_last=2)
# the narrow model's 256-token first level stands for the 4096-token sites
NARROW_POOL = dict(bank_downsample_min_seq=256, self_kv_min_seq=256)


@pytest.mark.parametrize("case", ["fused_cfg", "turbo", "turbo_max", "fused_gn",
                                  "video_turbo", "plain_gn"])
def test_request_plans_match_counted_calls(monkeypatch, case):
    """One narrow request at 128x128 (two frames; the video case ten frames
    in windows of 4, stride 3) under each SampleConfig of chip_smoke.py's
    phases 15-17, K8 at its sites by default ("fused_gn": the exact recipe)
    and none under MAGICDANCE_FUSED_GN=0 ("plain_gn"): the plan derived
    from the sampler's host masks meets the wrapper calls."""
    video = case == "video_turbo"
    cfg = chip_smoke.narrow_temporal_config() if video else chip_smoke.narrow_model_config()
    pipe = MagicPosePipeline(cfg, device="cpu")
    pipe.init_params(seed=0, scale=0.1)
    g = torch.Generator().manual_seed(2)
    frames = 10 if video else 2
    x = torch.randn(frames, 16, 16, 4, generator=g)
    hint = torch.rand(frames, 128, 128, 3, generator=g)
    ref = torch.randn(1, 16, 16, 4, generator=g)
    ctx = torch.randn(1, 77, 16, generator=g)
    kw = {"fused_cfg": dict(steps=3, fused_cfg=True),
          "turbo": dict(steps=4, **TURBO, **NARROW_POOL),
          "turbo_max": dict(steps=6, **TURBO_MAX, **NARROW_POOL),
          "fused_gn": dict(steps=1),
          "video_turbo": dict(steps=4, window=4, stride=3, **TURBO, **NARROW_POOL),
          "plain_gn": dict(steps=1)}[case]
    scfg = T.SampleConfig(**kw)
    calls = count_calls(monkeypatch)
    if case == "plain_gn":
        monkeypatch.setenv("MAGICDANCE_FUSED_GN", "0")
    else:
        monkeypatch.delenv("MAGICDANCE_FUSED_GN", raising=False)
    sampler = ddim_sample_video if video else ddim_sample
    extra = dict(window_offsets=[1, 6, 0, 9]) if video else {}
    out = sampler(pipe.model, pipe.sched, make_ddim_schedule(pipe.sched, scfg.steps), scfg,
                  x, ctx, ctx, reference_latent=ref, pose_hint=hint, **extra)
    assert torch.isfinite(out).all()
    n_win = 4 if video else 1
    plan = chip_smoke.request_launch_plan(cfg, 16, n_win * 4 if video else frames, scfg,
                                          frames=4 if video else 1,
                                          fused_gn=case != "plain_gn", video=video)
    assert calls == plan
    mode = {"fused_cfg": "two_source_attention_gated", "fused_gn": "groupnorm_silu"}.get(case)
    assert mode is None or plan[mode] > 0
    assert ("groupnorm_silu" in plan) == (case != "plain_gn")


def test_full_width_dual_control_plan():
    """DUAL_CONTROL at SD1.5 width: no bank write and no bank read; per DDIM
    step two ControlNets (6 kernel sites each), the cond and the uncond pass
    (15 each), all self-attention; K8 at each ControlNet's 20 SiLU and 7
    transformer norms and each pass's 45 and 16, two launches a call."""
    assert chip_smoke.serving_launch_plan(chip_smoke.dual_model_config(), 64, 2, 1) == {
        "self_attention": 6 + 6 + 15 + 15, "groupnorm_silu": 2 * (27 + 27 + 61 + 61)}


@pytest.mark.parametrize("case", ["dual_exact", "dual_turbo", "dual_fused", "plms", "dpmpp_2m",
                                  "dpmpp_3m"])
def test_dual_control_and_sampler_plans_match_counted_calls(monkeypatch, case):
    """One narrow request at 128x128, two frames: DUAL_CONTROL (pose and image
    hints) exact, with the control residuals refreshed every second step,
    and under fused CFG; and the PLMS and DPM-Solver++ samplers on the image
    model, whose every step makes one evaluation of the exact recipe."""
    from magicdance_tpu_torch.sampling.dpm import dpmpp_2m_sample, dpmpp_3m_sample
    from magicdance_tpu_torch.sampling.plms import plms_sample

    dual = case.startswith("dual")
    cfg = chip_smoke.narrow_dual_config() if dual else chip_smoke.narrow_model_config()
    pipe = MagicPosePipeline(cfg, device="cpu")
    pipe.init_params(seed=0, scale=0.1)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 16, 16, 4, generator=g)
    hint = torch.rand(2, 128, 128, 3, generator=g)
    ctx = torch.randn(1, 77, 16, generator=g)
    kw = {"dual_turbo": dict(pose_every=2), "dual_fused": dict(fused_cfg=True)}.get(case, {})
    scfg = T.SampleConfig(steps=3, **kw)
    ddim = make_ddim_schedule(pipe.sched, scfg.steps)
    calls = count_calls(monkeypatch)
    if dual:
        out = ddim_sample(pipe.model, pipe.sched, ddim, scfg, x, ctx, ctx, pose_hint=hint,
                          image_hint=torch.rand(2, 128, 128, 3, generator=g))
    else:
        ref = dict(reference_latent=torch.randn(1, 16, 16, 4, generator=g), pose_hint=hint)
        sampler = {"plms": lambda: plms_sample(pipe.model, pipe.sched, ddim, scfg, x, ctx, ctx,
                                               **ref),
                   "dpmpp_2m": lambda: dpmpp_2m_sample(pipe.model, pipe.sched, 3, scfg, x, ctx,
                                                       ctx, **ref),
                   "dpmpp_3m": lambda: dpmpp_3m_sample(pipe.model, pipe.sched, 3, scfg, x, ctx,
                                                       ctx, sde_eta=1.0, generator=g, **ref)}
        out = sampler[case]()
    assert torch.isfinite(out).all()
    plan = chip_smoke.request_launch_plan(cfg, 16, 2, scfg)
    assert calls == plan
    if dual:
        assert set(plan) == {"self_attention", "groupnorm_silu"}
    else:
        assert plan == {m: 3 * n for m, n in chip_smoke.serving_launch_plan(cfg, 16, 2, 1).items()}


def sdxl_config(latent=None) -> T.ModelConfig:
    """`magicpose-sdxl` at its published widths, or cut to `tiny_sdxl_model`
    at `latent`."""
    import json

    from torch_port_util import SDXL_CONFIG, tiny_sdxl_model

    if latent is not None:
        return T.from_dict(T.ModelConfig, tiny_sdxl_model(latent))
    with open(SDXL_CONFIG) as f:
        return T.from_dict(T.ModelConfig, json.load(f)["model"])


def test_full_width_sdxl_plan():
    """One DDIM step of `sdxl-pose.serve-f4` (1024x1024, 4 frames): 70
    transformer blocks a UNet pass (64x64: 4 + 6, 32x32: 20 + 10 + 30), 34 in
    the ControlNet, all kernel sites; the write pass, the ControlNet and the
    uncond pass self-attention, the cond pass reads the bank. K8 at every
    GroupNorm (the smallest grid is 32x32): a UNet pass's 35 SiLU and 11
    transformer norms, the ControlNet's 16 and 5, two launches a call. SD1.5's
    plan (`test_full_width_plans`) is the same as before."""
    assert chip_smoke.serving_launch_plan(sdxl_config(), 128, 4, 1) == {
        "self_attention": 70 + 34 + 70, "two_source_attention": 70,
        "groupnorm_silu": 2 * (3 * (35 + 11) + 16 + 5)}


def test_sdxl_step_matches_counted_calls(monkeypatch):
    """One exact DDIM step of the narrow SDXL model at 512x512 (latents 64,
    attention at 32x32 and 16x16: kernel sites), two frames, the added
    vectors given to every pass."""
    cfg = sdxl_config(64)
    pipe = MagicPosePipeline(cfg, device="cpu")
    pipe.init_params(seed=0, scale=0.1)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 64, 64, 4, generator=g)
    ctx = torch.randn(1, 77, 32, generator=g)
    y = torch.randn(1, cfg.unet.adm_in_channels, generator=g)
    calls = count_calls(monkeypatch)
    out = ddim_sample(pipe.model, pipe.sched, make_ddim_schedule(pipe.sched, 1),
                      T.SampleConfig(steps=1), x, ctx, ctx,
                      reference_latent=torch.randn(1, 64, 64, 4, generator=g),
                      pose_hint=torch.rand(2, 512, 512, 3, generator=g), y=y, uncond_y=y)
    assert torch.isfinite(out).all()
    plan = chip_smoke.serving_launch_plan(cfg, 64, 2, 1)
    assert calls == plan
    # 28 blocks a UNet pass, 13 in the ControlNet
    assert plan == {"self_attention": 28 + 13 + 28, "two_source_attention": 28,
                    "groupnorm_silu": 2 * (3 * (35 + 11) + 16 + 5)}
