"""Serving across two processes (gloo on the CPU), as
tests/test_sharded_inference.py and test_tensor_parallel.py serve across
the JAX package's devices.

Frame-parallel images: `MagicPosePipeline.sample_frames(mesh=)` on two ranks
(F = 8, four frames a rank; F = 3, two and one) against JAX's single-device
`ddim_sample` of the same request (the pipeline's CLIP and VAE encode
composed by hand, 3 DDIM steps, CFG 7, a shared x_T given to rank 0 only)
within 1e-4, and against the port's own one-process request within 1e-4
(the batch of four or two frames rounds unlike the batch of eight, and CFG 7
amplifies that over the steps); with decoding, both ranks return the whole (F, H, W, 3) array. Tensor
parallelism: the tiny UNet's forward under `tensor_parallel_plan` on a
(1, 2) ("data", "model") mesh against JAX's replicated forward within 1e-4.
The window-parallel video sampler: tests/test_torch_sharded_video.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magicdance_tpu.config as jcfg
import magicdance_tpu_torch.config as tcfg
from magicdance_tpu.data.tokenizer import empty_prompt_ids as j_empty_ids
from magicdance_tpu.models.unet import UNet as JUNet
from magicdance_tpu.models.vae import encode_to_latent
from magicdance_tpu.ops import schedules as js
from magicdance_tpu.sampling.ddim import ddim_sample as j_ddim_sample
from magicdance_tpu_torch.convert.from_jax import flax_to_state_dict
from torch_port_util import (
    TINY_UNET,
    Ranks,
    jit_apply,
    make_pipelines,
    micro_model_cfg_jax,
    np_rand,
    port_cfg,
    shaped_random,
    to_t,
)
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

STEPS = 3
TOL = dict(atol=1e-4, rtol=1e-4)


def image_job(name, tp, frames: int, decode: bool = False) -> dict:
    return dict(kind="image", name=name, cfg=tcfg.to_dict(tp.cfg),
                weights={n: getattr(tp, n).state_dict() for n in ("model", "vae", "clip")},
                pose=to_t(POSE[:frames]), ref=to_t(REF), x_T=to_t(X_T[:frames]),
                scfg=tcfg.to_dict(tcfg.SampleConfig(steps=STEPS)), decode=decode)


POSE = np_rand((8, 64, 64, 3), 70, 0.0, 1.0)
REF = np_rand((1, 64, 64, 3), 71, -1.0, 1.0)
X_T = np.broadcast_to(np_rand((1, 8, 8, 4), 72), (8, 8, 8, 4)).copy()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    jp, tp = make_pipelines(micro_model_cfg_jax())
    # the UNet of tests/test_tensor_parallel.py, every leaf drawn
    ucfg = jcfg.UNetConfig(**TINY_UNET)
    unet = JUNet(ucfg)
    x, t = np_rand((4, 8, 8, 4), 80), np.full((4,), 17, np.int32)
    ctx = np_rand((4, 5, 16), 81)
    uparams = {"params": jax.tree.map(jnp.asarray, shaped_random(
        lambda: unet.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
                          jnp.zeros((1,), jnp.int32), jnp.zeros((1, 5, 16))), 5)["params"])}
    jobs = [image_job("f8", tp, 8), image_job("f3", tp, 3),
            image_job("f3_images", tp, 3, decode=True),
            dict(kind="tp", name="tp", cfg=tcfg.to_dict(port_cfg(ucfg)),
                 weights=flax_to_state_dict(jax.tree.map(np.asarray, uparams)),
                 x=to_t(x), t=torch.from_numpy(t).long(), ctx=to_t(ctx))]
    ranks = Ranks(tmp_path_factory.mktemp("serving"), jobs)

    # JAX, one device: CLIP and the VAE encode, then ddim_sample (F = 8 and 3)
    sf = jp.cfg.vae.scale_factor

    @jax.jit
    def encode(params, ids_, ref_):
        post = jp.vae.apply(params["vae"], ref_, method=jp.vae.encode)
        return jp.clip.apply(params["clip"], ids_), encode_to_latent(post.mode(), sf)

    jctx, ref_lat = encode(jp.params, jnp.asarray(j_empty_ids(1)), jnp.asarray(REF))
    ddim = js.make_ddim_schedule(jp.sched, STEPS)
    want = {f"f{f}": np.asarray(j_ddim_sample(
        jp.model, jp.params["model"], jp.sched, ddim, jcfg.SampleConfig(steps=STEPS),
        jax.random.PRNGKey(0), jnp.asarray(X_T[:f]), jctx, jctx, reference_latent=ref_lat,
        pose_hint=jnp.asarray(POSE[:f]))) for f in (8, 3)}
    want["tp"] = np.asarray(jit_apply(unet, dtype=jnp.float32)(
        uparams, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))[0])
    # the port in one process
    scfg = tcfg.SampleConfig(steps=STEPS)
    one = {"f8": tp.sample_frames(to_t(POSE), to_t(REF), scfg, decode=False, x_T=to_t(X_T)),
           "f3_images": tp.sample_frames(to_t(POSE[:3]), to_t(REF), scfg, x_T=to_t(X_T[:3]))}
    return ranks.join(), want, one


@pytest.mark.parametrize("frames", [8, 3])
def test_frame_parallel_images_match_jax_single_device(served, frames):
    out, want, _ = served
    for r in range(2):
        got = out[r][f"f{frames}"]["out"]
        assert got.shape == (frames, 8, 8, 4)
        np.testing.assert_allclose(got.numpy(), want[f"f{frames}"], **TOL)


def test_frame_parallel_images_match_one_process(served):
    out, _, one = served
    for r in range(2):
        np.testing.assert_allclose(out[r]["f8"]["out"].numpy(), one["f8"].numpy(), **TOL)


def test_sample_frames_returns_the_whole_array_on_every_rank(served):
    out, _, one = served
    a, b = out[0]["f3_images"]["out"], out[1]["f3_images"]["out"]
    assert a.shape == b.shape == (3, 64, 64, 3)
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.numpy(), one["f3_images"].numpy(), **TOL)


def test_tensor_parallel_unet_matches_jax_replicated(served):
    out, want, _ = served
    for r in range(2):
        got = out[r]["tp"]
        np.testing.assert_allclose(got["out"].numpy(), want["tp"], **TOL)
    plan = out[0]["tp"]["plan"]
    assert any(k.endswith("attn1.to_q") for k in plan)
    assert any(k.endswith("attn2.to_out") for k in plan)
    assert any(k.endswith("ff.proj_in") for k in plan) and any(
        k.endswith("ff.proj_out") for k in plan)
    shapes = out[0]["tp"]["local_shapes"]
    q = next(k for k in shapes if k.endswith("attn1.to_q.weight"))
    o = next(k for k in shapes if k.endswith("attn1.to_out.weight"))
    assert shapes[q][0] * 2 == shapes[q][1] and shapes[o][1] * 2 == shapes[o][0]
