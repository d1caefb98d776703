"""Model extras of the port against the JAX package, on the same numpy
inputs and weights (carried by `convert.from_jax`):

  * `concat_cond`: a UNet with in_channels = 9 (latent + mask + masked
    latent) whose 9-channel conv_in, and the ControlNet's, cross by the tree
    walk (tests/test_misc_features.py:68);
  * `clip.encode_long_prompt` (tests/test_misc_features.py:13) and the VAE
    posterior's `kl` (tests/test_models.py:175), within 2e-4;
  * the numpy copy `data/mask.py`: the same masks from the same seeds;
  * a DUAL_CONTROL model with motion modules through the overlap-window
    sampler with image hints per window (JAX's offsets replayed), 2e-3."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magicdance_tpu.config as jcfg
import magicdance_tpu_torch.config as tcfg
from magicdance_tpu.models import CLIPTextEncoder as JCLIP
from magicdance_tpu.models import MagicPoseModel as JModel
from magicdance_tpu_torch.convert.from_jax import load_flax_params
from magicdance_tpu_torch.models import MagicPoseModel
from magicdance_tpu_torch.models.clip import CLIPTextEncoder, encode_long_prompt
from magicdance_tpu_torch.models.vae import GaussianPosterior
from magicdance_tpu_torch.ops import schedules as ts
from magicdance_tpu_torch.sampling.overlap import ddim_sample_video
from torch_port_util import (
    assert_close,
    jit_apply,
    make_models,
    micro_model_cfg_jax,
    np_rand,
    port_cfg,
    shaped_random,
    to_t,
)
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)


def test_concat_cond_matches_jax():
    base = micro_model_cfg_jax()
    jc = dataclasses.replace(base, unet=dataclasses.replace(base.unet, in_channels=9))
    jm = JModel(jc)
    x, cc = np_rand((2, 8, 8, 4), 1), np_rand((2, 8, 8, 5), 2)
    ref, hint = np_rand((1, 8, 8, 4), 3), np_rand((2, 64, 64, 3), 4, 0.0, 1.0)
    t, ctx = np.array([10, 600]), np_rand((2, 77, 16), 5)
    args = [jnp.asarray(a) for a in (x, t, ctx)]
    params = {"params": shaped_random(lambda: jm.init(
        jax.random.PRNGKey(0), *args, reference_noisy=jnp.asarray(ref),
        pose_hint=jnp.asarray(hint), concat_cond=jnp.asarray(cc)), 0)["params"]}
    tm = MagicPoseModel(port_cfg(jc)).eval()
    load_flax_params(tm, params)
    assert tuple(tm.unet.conv_in.weight.shape[:2]) == (32, 9)
    assert tuple(tm.pose_control.conv_in.weight.shape[:2]) == (32, 9)
    assert tuple(tm.appearance_unet.conv_in.weight.shape[:2]) == (32, 4)
    apply = jit_apply(jm)
    jparams = jax.tree.map(jnp.asarray, params)
    targs = [to_t(x), torch.tensor(t), to_t(ctx)]
    with torch.no_grad():
        got = tm(*targs, reference_noisy=to_t(ref), pose_hint=to_t(hint), concat_cond=to_t(cc))
        got_uc = tm(*targs, uc=True, concat_cond=to_t(cc))
    want = apply(jparams, *args, reference_noisy=jnp.asarray(ref), pose_hint=jnp.asarray(hint),
                 concat_cond=jnp.asarray(cc))
    assert got.shape == got_uc.shape == (2, 8, 8, 4) and torch.isfinite(got_uc).all()
    assert_close(got, np.asarray(want), 2e-4, 2e-4)


@pytest.mark.parametrize("n", [12, 30])
def test_encode_long_prompt_matches_jax(n):
    """12 raw tokens padded with EOS, and 30 cut to the 3 x 5 window bodies."""
    from magicdance_tpu.models.clip import encode_long_prompt as j_long

    jc = jcfg.CLIPTextConfig(vocab_size=100, hidden_size=16, num_layers=1, num_heads=2,
                             max_length=7, bos_token_id=0, eos_token_id=1)
    enc = JCLIP(jc)
    params = {"params": shaped_random(
        lambda: enc.init(jax.random.PRNGKey(0), jnp.zeros((1, 7), jnp.int32)), 0)["params"]}
    tenc = CLIPTextEncoder(port_cfg(jc)).eval()
    load_flax_params(tenc, params)
    ids = np.arange(2, 2 + n, dtype=np.int32)[None] % 100
    want = j_long(enc, jax.tree.map(jnp.asarray, params), jnp.asarray(ids), windows=3)
    with torch.no_grad():
        got = encode_long_prompt(tenc, torch.from_numpy(ids), windows=3)
    assert got.shape == (1, 3 * 7, 16)
    assert_close(got, np.asarray(want), 2e-4, 2e-4)


def test_posterior_kl_matches_jax():
    from magicdance_tpu.models.vae import GaussianPosterior as JPost

    mean, logvar = np_rand((2, 4, 4, 4), 1), np_rand((2, 4, 4, 4), 2)
    want = JPost(jnp.asarray(mean), jnp.asarray(logvar)).kl()
    got = GaussianPosterior(to_t(mean), to_t(logvar)).kl()
    assert got.shape == (2,)
    assert_close(got, np.asarray(want), 2e-4, 2e-4)


@pytest.mark.parametrize("kind", ["bbox", "brush", "irregular", "random"])
def test_mask_copy_matches_jax(kind):
    from magicdance_tpu.data import mask as jmask
    from magicdance_tpu_torch.data import mask as tmask

    for seed in range(3):
        want = jmask.get_mask(96, 80, np.random.RandomState(seed), kind=kind)
        got = tmask.get_mask(96, 80, np.random.RandomState(seed), kind=kind)
        assert got.shape == (96, 80, 1) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_video_image_hints_match_jax():
    """A DUAL_CONTROL model with motion modules, F = 6 frames in windows of
    4, stride 2, 2 steps of CFG 7, pose and image hints gathered per window."""
    from magicdance_tpu.ops import schedules as js
    from magicdance_tpu.sampling.overlap import ddim_sample_video as j_video

    base = micro_model_cfg_jax()
    jc = dataclasses.replace(
        base, variant=jcfg.ModelVariant.DUAL_CONTROL,
        unet=dataclasses.replace(base.unet, use_motion_modules=True, motion_num_heads=2))
    jm, params, tm = make_models(jc)
    F, steps = 6, 2
    inp = dict(x=np_rand((F, 8, 8, 4), 1), ctx=np_rand((1, 77, 16), 2),
               uctx=np_rand((1, 77, 16), 3), hint=np_rand((F, 64, 64, 3), 4, 0.0, 1.0),
               img=np_rand((F, 64, 64, 3), 5, 0.0, 1.0))
    jsched = js.make_schedule(jc.diffusion)
    jddim = js.make_ddim_schedule(jsched, steps)
    rng = jax.random.PRNGKey(6)
    want = jax.jit(lambda p, x, c, u, h, i: j_video(
        jm, p, jsched, jddim, jcfg.SampleConfig(steps=steps, window=4, stride=2), rng, x, c, u,
        pose_hint=h, image_hint=i))(params, *(jnp.asarray(inp[k]) for k in inp))
    offsets, r = [], rng
    for _ in range(steps):  # the offsets JAX draws from `rng`
        r, r_off, _, _ = jax.random.split(r, 4)
        offsets.append(int(jax.random.randint(r_off, (), 0, F)))
    tsched = ts.make_schedule(tcfg.DiffusionConfig())
    x, ctx, uctx, hint, img = (to_t(inp[k]) for k in inp)
    got = ddim_sample_video(tm, tsched, ts.make_ddim_schedule(tsched, steps),
                            tcfg.SampleConfig(steps=steps, window=4, stride=2), x, ctx, uctx,
                            pose_hint=hint, image_hint=img, window_offsets=offsets)
    assert np.isfinite(np.asarray(want)).all()
    assert_close(got, np.asarray(want), 2e-3, 2e-3)
    pose_only = ddim_sample_video(tm, tsched, ts.make_ddim_schedule(tsched, steps),
                                  tcfg.SampleConfig(steps=steps, window=4, stride=2), x, ctx,
                                  uctx, pose_hint=hint, window_offsets=offsets)
    assert not torch.allclose(got, pose_only, atol=1e-4)
