"""The port's slice as a whole against the JAX package: schedules, config and
tokenizer copies, the DDIM update, and a 4-step CFG-7 sample through
`MagicPosePipeline.sample_frames` against the JAX pieces composed by hand
(CLIP, VAE encode, `ddim_sample`, decode) from the same weights and the same
numpy x_T. Plus import hygiene and device selection."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magicdance_tpu.config as jcfg
import magicdance_tpu_torch.config as tcfg
from magicdance_tpu.data.tokenizer import empty_prompt_ids as j_empty_ids
from magicdance_tpu.models.vae import encode_to_latent, latent_to_decoder_input
from magicdance_tpu.ops import schedules as js
from magicdance_tpu.sampling.ddim import ddim_sample as j_ddim_sample
from magicdance_tpu.sampling.ddim import ddim_step as j_ddim_step
from magicdance_tpu_torch.data.tokenizer import empty_prompt_ids as t_empty_ids
from magicdance_tpu_torch.ops import schedules as ts
from magicdance_tpu_torch.pipeline import MagicPosePipeline as TPipeline
from magicdance_tpu_torch.sampling.ddim import ddim_step as t_ddim_step
from torch_port_util import (
    assert_close,
    make_pipelines,
    np_rand,
    port_cfg,
    tiny_model_cfg_jax,
    to_t,
)
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)


@pytest.mark.parametrize("schedule,param", [("linear", "eps"), ("cosine", "v"),
                                            ("sqrt_linear", "x0")])
def test_schedules_equal_jax_arrays(schedule, param):
    jd = jcfg.DiffusionConfig(beta_schedule=schedule,
                              parameterization=jcfg.Parameterization(param))
    td = port_cfg(jd)
    jsched, tsched = js.make_schedule(jd), ts.make_schedule(td)
    for name in jsched._fields:
        np.testing.assert_array_equal(getattr(tsched, name).numpy(),
                                      np.asarray(getattr(jsched, name)), err_msg=name)
    for steps, eta in ((50, 0.0), (20, 0.5)):
        jdd = js.make_ddim_schedule(jsched, steps, eta=eta)
        tdd = ts.make_ddim_schedule(tsched, steps, eta=eta)
        for name in jdd._fields:
            np.testing.assert_array_equal(getattr(tdd, name).numpy(),
                                          np.asarray(getattr(jdd, name)), err_msg=name)


def test_timestep_embedding_and_forward_process():
    t = np.array([0, 1, 250, 999])
    for dim in (32, 33, 320):
        want = js.timestep_embedding(jnp.asarray(t), dim)
        got = ts.timestep_embedding(torch.tensor(t), dim)
        # fp32 sin/cos of arguments up to 999 rad: XLA's and torch's range
        # reductions differ by up to ~6e-5 on the CPU
        assert_close(got, want, atol=1e-4, rtol=0)
        half = dim // 2  # [cos | sin]: at t = 0 every cos is 1 and every sin 0
        assert_close(got[0, :2 * half], np.repeat([1.0, 0.0], half), atol=0, rtol=0)
    jsched = js.make_schedule(jcfg.DiffusionConfig())
    tsched = ts.make_schedule(tcfg.DiffusionConfig())
    x, n = np_rand((4, 8, 8, 4), 0), np_rand((4, 8, 8, 4), 1)
    assert_close(ts.q_sample(tsched, to_t(x), torch.tensor(t), to_t(n)),
                 js.q_sample(jsched, jnp.asarray(x), jnp.asarray(t), jnp.asarray(n)),
                 atol=1e-6, rtol=1e-6)
    assert_close(ts.predict_eps_from_v(tsched, to_t(x), torch.tensor(t), to_t(n)),
                 js.predict_eps_from_v(jsched, jnp.asarray(x), jnp.asarray(t),
                                       jnp.asarray(n)), atol=1e-6, rtol=1e-6)


def test_ddim_step_matches_jax():
    x, eps, noise = (np_rand((2, 8, 8, 4), i) for i in range(3))
    tsched = ts.make_ddim_schedule(ts.make_schedule(tcfg.DiffusionConfig()), 50, eta=0.3)
    i = 17
    scal = [tsched.alphas[i], tsched.alphas_prev[i], tsched.sqrt_one_minus_alphas[i],
            tsched.sigmas[i]]
    want = j_ddim_step(jnp.asarray(x), jnp.asarray(eps), *(jnp.asarray(s.numpy()) for s in scal),
                       jnp.asarray(noise))
    got = t_ddim_step(to_t(x), to_t(eps), *scal, to_t(noise))
    for g, w in zip(got, want):
        assert_close(g, w, atol=1e-6, rtol=1e-6)


def test_config_and_tokenizer_copies_agree():
    train_cfgs = (jcfg.stage1_appearance_pretrain(), jcfg.stage2_pose_control(),
                  jcfg.stage3_motion(),
                  jcfg.TrainConfig(optim=jcfg.OptimConfig(grad_accum=2, ema_rate=0.5),
                                   freeze=jcfg.FreezeRegime.POSE_ONLY, sd_locked=False))
    for cfg in (jcfg.ModelConfig(), tiny_model_cfg_jax(), jcfg.SampleConfig(steps=20),
                *train_cfgs):
        assert tcfg.to_dict(port_cfg(cfg)) == jcfg.to_dict(cfg)
    for make in ("stage1_appearance_pretrain", "stage2_pose_control", "stage3_motion"):
        assert tcfg.to_dict(getattr(tcfg, make)()) == jcfg.to_dict(getattr(jcfg, make)())
    for name in ("SampleConfig", "OptimConfig", "TrainConfig"):
        assert [f.name for f in dataclasses.fields(getattr(tcfg, name))] == \
            [f.name for f in dataclasses.fields(getattr(jcfg, name))]
    assert [r.value for r in tcfg.FreezeRegime] == [r.value for r in jcfg.FreezeRegime]
    np.testing.assert_array_equal(t_empty_ids(3), j_empty_ids(3))


@pytest.fixture(scope="module")
def pipelines():
    return make_pipelines(tiny_model_cfg_jax())


def test_sample_frames_matches_composed_jax_path(pipelines):
    """4-step DDIM, CFG 7, controlnet_important, wonoise, shared x_T, F = 2.
    Tolerance 2e-3 abs/rel on latents and frames: each step forms
    eps_u + 7 (eps_c - eps_u), so the ~1e-6 per-pass fp32 differences of the
    module tests are amplified about 13x per step and carried through the
    trajectory (measured 6.5e-5 on latents of magnitude 47 and 5.4e-6 on
    frames, CPU)."""
    jp, tp = pipelines
    scfg_j, scfg_t = jcfg.SampleConfig(steps=4), tcfg.SampleConfig(steps=4)
    pose = np_rand((2, 64, 64, 3), 70, 0.0, 1.0)
    ref = np_rand((1, 64, 64, 3), 71, -1.0, 1.0)
    x_T = np.broadcast_to(np_rand((1, 8, 8, 4), 72), (2, 8, 8, 4)).copy()
    sf = jp.cfg.vae.scale_factor

    ids = jnp.asarray(j_empty_ids(1))

    @jax.jit
    def encode(params, ids_, ref_):  # one compile, not op-by-op dispatch
        post = jp.vae.apply(params["vae"], ref_, method=jp.vae.encode)
        return jp.clip.apply(params["clip"], ids_), encode_to_latent(post.mode(), sf)

    ctx, ref_lat = encode(jp.params, ids, jnp.asarray(ref))
    ddim = js.make_ddim_schedule(jp.sched, 4)
    want_lat = j_ddim_sample(jp.model, jp.params["model"], jp.sched, ddim, scfg_j,
                             jax.random.PRNGKey(0), jnp.asarray(x_T), ctx, ctx,
                             reference_latent=ref_lat, pose_hint=jnp.asarray(pose))
    want_img = jax.jit(lambda p, lat: jp.vae.apply(p, latent_to_decoder_input(lat, sf),
                                                   method=jp.vae.decode))(
        jp.params["vae"], want_lat)

    got_lat = tp.sample_frames(to_t(pose), to_t(ref), scfg_t, decode=False, x_T=to_t(x_T))
    got_img = tp.decode_latents(got_lat)
    assert got_lat.shape == (2, 8, 8, 4) and got_img.shape == (2, 64, 64, 3)
    assert_close(got_lat, want_lat, atol=2e-3, rtol=2e-3)
    assert_close(got_img, want_img, atol=2e-3, rtol=2e-3)
    # the whole call (encode, sample, decode) gives the same frames
    assert_close(tp.sample_frames(to_t(pose), to_t(ref), scfg_t, x_T=to_t(x_T)),
                 got_img.numpy(), atol=1e-6, rtol=1e-6)


def test_sample_frames_draws_noise_from_the_generator(pipelines):
    _, tp = pipelines
    pose = to_t(np_rand((2, 64, 64, 3), 80, 0.0, 1.0))
    ref = to_t(np_rand((1, 64, 64, 3), 81, -1.0, 1.0))
    scfg = tcfg.SampleConfig(steps=2, eta=0.5)

    def run(seed):
        return tp.sample_frames(pose, ref, scfg, decode=False,
                                generator=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # refused as in JAX (sampling/ddim.py:228-231): the gated bank read has
    # no pooled variant
    with pytest.raises(ValueError, match="self_kv_downsample"):
        tp.sample_frames(pose, ref, tcfg.SampleConfig(steps=2, fused_cfg=True,
                                                      self_kv_downsample=2))


def test_pipeline_runs_fp32_without_tf32(pipelines, monkeypatch):
    """The pipeline, not the caller's process-wide flags, decides precision:
    inside each public call TF32 is off in cuBLAS and cuDNN, and the caller's
    flags are back afterwards, also when the call raises."""
    _, tp = pipelines
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    seen = []
    real_decode = tp.vae.decode

    def spy(z):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return real_decode(z)

    monkeypatch.setattr(tp.vae, "decode", spy)
    tp.decode_latents(to_t(np_rand((1, 8, 8, 4), 90)))
    assert seen == [(False, False)]
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    with pytest.raises(ValueError, match="self_kv_downsample"):
        tp.sample_frames(None, None, tcfg.SampleConfig(steps=2, fused_cfg=True,
                                                       self_kv_downsample=2))
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


def test_video_flag_on_an_image_variant_samples_images(pipelines):
    """As in JAX (`video = video and cfg.has_temporal`): without motion
    modules `video=True` is the image path."""
    _, tp = pipelines
    pose = to_t(np_rand((2, 64, 64, 3), 95, 0.0, 1.0))
    ref = to_t(np_rand((1, 64, 64, 3), 96, -1.0, 1.0))
    x_T = to_t(np_rand((2, 8, 8, 4), 97))
    scfg = tcfg.SampleConfig(steps=2)
    assert torch.equal(tp.sample_frames(pose, ref, scfg, decode=False, video=True, x_T=x_T),
                       tp.sample_frames(pose, ref, scfg, decode=False, x_T=x_T))


def test_cuda_device_raises_without_gpu(monkeypatch):
    from magicdance_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        TPipeline(port_cfg(tiny_model_cfg_jax()))  # default device is the GPU
    assert resolve_device("cpu").type == "cpu"


def test_port_never_imports_jax():
    """Importing every module of the port leaves jax, flax and the JAX package
    out of sys.modules (exact names: the port's own name starts with the JAX
    package's)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import magicdance_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'magicdance_tpu'))\n"
        "assert not bad, bad\n"
        "print(' '.join(n for n in sys.modules if n.startswith('magicdance_tpu_torch')))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    walked = set(out.stdout.split())
    assert len(walked) >= 15
    assert {f"magicdance_tpu_torch.{m}" for m in (
        "cli.sample", "cli.detect_pose", "convert.torch_convert", "models.openpose",
        "data.openpose_detect", "data.pose", "metrics.core", "metrics.lpips",
        "metrics.inception", "metrics.center", "metrics.fid", "metrics.fvd", "metrics.i3d",
        "metrics.resnet3d", "metrics.clip_score", "cli.eval", "parallel", "parallel.mesh",
        "parallel.multihost")} <= walked
