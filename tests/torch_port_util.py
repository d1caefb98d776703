"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Both sides get the same inputs and the same weights: inputs are drawn with
numpy from a seed, weights are a JAX parameter tree with EVERY leaf drawn at
random (the zero-initialised output convs included -- otherwise the UNet
output is exactly 0 and the bank and pose branches have no effect), carried
into the port by `magicdance_tpu_torch.convert.from_jax`.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

import magicdance_tpu.config as jcfg
import magicdance_tpu_torch.config as tcfg
from magicdance_tpu.models import AutoencoderKL as JVAE
from magicdance_tpu.models import CLIPTextEncoder as JCLIP
from magicdance_tpu.models import MagicPoseModel as JModel
from magicdance_tpu.train.trainer import Trainer as JTrainer
from magicdance_tpu_torch.convert.from_jax import convert_leaf, load_train_state
from magicdance_tpu_torch.train.trainer import Draws, Trainer

@pytest.fixture(scope="module", autouse=True)
def torch_single_thread():
    """The tiny configs gain nothing from intra-op threads; one thread keeps
    these modules from crowding the other test processes that share the
    machine. Restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TINY_UNET = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                 attention_resolutions=(1, 2), num_heads=2, context_dim=16)


def tiny_model_cfg_jax() -> jcfg.ModelConfig:
    """The verify recipe's tiny config: 8x8 latent (64x64 image), fp32."""
    return jcfg.ModelConfig(
        variant=jcfg.ModelVariant.APPEARANCE_POSE,
        unet=jcfg.UNetConfig(**TINY_UNET),
        pose_control=jcfg.ControlNetConfig(**TINY_UNET),
        vae=jcfg.VAEConfig(base_channels=32, channel_mult=(1, 1, 2, 2),
                           num_res_blocks=1),
        clip=jcfg.CLIPTextConfig(hidden_size=16, num_layers=1, num_heads=2),
        latent_size=8,
        dtype="float32",
    )


def micro_model_cfg_jax() -> jcfg.ModelConfig:
    """The tiny config with attention at the first level only (and the middle
    block): the sampler tests trace the JAX sampler once per SampleConfig,
    and tracing time grows with the number of transformer blocks."""
    cfg = tiny_model_cfg_jax()
    return dataclasses.replace(
        cfg, unet=dataclasses.replace(cfg.unet, attention_resolutions=(1,)),
        pose_control=dataclasses.replace(cfg.pose_control, attention_resolutions=(1,)))


def tiny_temporal_cfg_jax() -> jcfg.ModelConfig:
    """The tiny config with motion modules (tests/test_sampling.py's
    `tiny_cfg(motion=True)`: motion_num_heads 2) on the video variant."""
    cfg = tiny_model_cfg_jax()
    return dataclasses.replace(
        cfg, variant=jcfg.ModelVariant.APPEARANCE_POSE_TEMPORAL,
        unet=dataclasses.replace(cfg.unet, use_motion_modules=True, motion_num_heads=2))


def port_cfg(cfg):
    """The same configuration as the port's dataclass (via to_dict/from_dict)."""
    return tcfg.from_dict(getattr(tcfg, type(cfg).__name__), jcfg.to_dict(cfg))


def make_pipelines(jc: jcfg.ModelConfig, image_size: int = 64):
    """The JAX pipeline and the port's (on the CPU) with the same weights:
    every leaf drawn with numpy on `fast_init_params`' shapes."""
    from magicdance_tpu.pipeline import MagicPosePipeline as JPipeline
    from magicdance_tpu_torch.pipeline import MagicPosePipeline as TPipeline

    jp = JPipeline(jc)
    shapes = jp.fast_init_params(jax.random.PRNGKey(0), image_size=image_size)
    params = {k: randomize(jax.tree.map(np.asarray, dict(v)), i)
              for i, (k, v) in enumerate(sorted(shapes.items()))}
    jp.params = jax.tree.map(jnp.asarray, params)
    tp = TPipeline(port_cfg(jc), device="cpu")
    tp.load_jax_params(params)
    return jp, tp


def make_models(jc: jcfg.ModelConfig, image_size: int = 64):
    """The JAX denoiser (module, params) and the port's on the CPU with the
    same weights, without the VAE and CLIP: every leaf drawn with numpy on
    the shapes of `jax.eval_shape` of the init (the hints and the reference
    the config's branches take)."""
    from magicdance_tpu_torch.models import MagicPoseModel as TModel

    lat = image_size // 8
    x = jnp.zeros((1, lat, lat, 4))
    kw = {}
    if jc.has_appearance:
        kw["reference_noisy"] = x
    for name, on in (("pose_hint", jc.has_pose), ("image_hint", jc.has_image_control)):
        if on:
            kw[name] = jnp.zeros((1, image_size, image_size, 3))
    jm = JModel(jc)
    params = {"params": jax.tree.map(jnp.asarray, shaped_random(
        lambda: jm.init(jax.random.PRNGKey(0), x, jnp.zeros((1,), jnp.int32),
                        jnp.zeros((1, jc.clip.max_length, jc.unet.context_dim)), **kw),
        0)["params"])}
    tm = TModel(port_cfg(jc)).eval().requires_grad_(False)
    from magicdance_tpu_torch.convert.from_jax import load_flax_params

    load_flax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def sample_both(jp, tp, steps: int, inputs: dict, video: bool = False, **scfg_kw):
    """The JAX sampler (`ddim_sample`, or `ddim_sample_video` with
    `video=True`) and the port's on the same numpy inputs {x_T, ctx, uctx,
    ref, hint} and SampleConfig fields. The video sampler's per-step window
    offsets are JAX's, replayed from the key it receives. Returns (port
    latents, JAX latents)."""
    from magicdance_tpu.ops import schedules as js
    from magicdance_tpu.sampling.ddim import ddim_sample as j_ddim
    from magicdance_tpu.sampling.overlap import ddim_sample_video as j_video
    from magicdance_tpu_torch.ops import schedules as ts
    from magicdance_tpu_torch.sampling.ddim import ddim_sample
    from magicdance_tpu_torch.sampling.overlap import ddim_sample_video

    rng = jax.random.PRNGKey(6)
    j_args = [jnp.asarray(inputs[k]) if inputs.get(k) is not None else None
              for k in ("x_T", "ctx", "uctx")]
    t_args = [to_t(inputs[k]) if inputs.get(k) is not None else None
              for k in ("x_T", "ctx", "uctx")]
    j_kw = dict(reference_latent=jnp.asarray(inputs["ref"]), pose_hint=jnp.asarray(inputs["hint"]))
    t_kw = dict(reference_latent=to_t(inputs["ref"]), pose_hint=to_t(inputs["hint"]))
    scfg_j, scfg_t = jcfg.SampleConfig(steps=steps, **scfg_kw), tcfg.SampleConfig(steps=steps, **scfg_kw)
    j_fn, t_fn = (j_video, ddim_sample_video) if video else (j_ddim, ddim_sample)
    want = j_fn(jp.model, jp.params["model"], jp.sched, js.make_ddim_schedule(jp.sched, steps),
                scfg_j, rng, *j_args, **j_kw)
    if video:
        offsets = []
        for _ in range(steps):
            rng, rng_off, _, _ = jax.random.split(rng, 4)
            offsets.append(int(jax.random.randint(rng_off, (), 0, inputs["x_T"].shape[0])))
        t_kw["window_offsets"] = offsets
    got = t_fn(tp.model, tp.sched, ts.make_ddim_schedule(tp.sched, steps), scfg_t, *t_args,
               **t_kw)
    return got, np.asarray(want)


def reference_state(cfg: tcfg.ModelConfig, pairs, seed: int) -> dict:
    """A reference-layout checkpoint for the port's `cfg`: one seeded draw
    per reference key of `pairs` (from `convert.torch_convert`'s tables) at
    its reference shape, N(0, 0.1^2), numpy float32."""
    from magicdance_tpu_torch.convert.torch_convert import reference_shapes

    rs = np.random.RandomState(seed)
    return {ref: (0.1 * rs.standard_normal(shape)).astype(np.float32)
            for ref, shape in reference_shapes(cfg, pairs).items()}


def randomize(tree, seed: int):
    """Every leaf of a (nested dict) parameter tree drawn from numpy: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), biases and embeddings
    N(0, 0.1^2). Returns a tree of numpy float32 arrays."""
    rs = np.random.RandomState(seed)

    def walk(t):
        out = {}
        for k, v in t.items():
            if hasattr(v, "items"):
                out[k] = walk(v)
                continue
            shape = tuple(v.shape)
            if k == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                a = rs.standard_normal(shape) / np.sqrt(fan_in)
            elif k == "scale":
                a = 1.0 + 0.1 * rs.standard_normal(shape)
            else:
                a = 0.1 * rs.standard_normal(shape)
            out[k] = a.astype(np.float32)
        return out

    return walk(tree)


def shaped_random(init, seed: int) -> dict:
    """Every leaf of the variables `init()` would return, drawn with numpy
    (`randomize`) on the shapes of `jax.eval_shape(init)`: no Flax init runs
    (an eager init executes the whole forward op by op)."""
    shapes = jax.eval_shape(init)
    return randomize(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), dict(shapes)), seed)


def jit_apply(module, **static):
    """`module.apply` compiled once (jax.jit) with keyword arguments such as
    `method=`, `dtype=`, `num_frames=` bound; call it with the params and the
    array arguments. One compile replaces the op-by-op dispatch (and its
    thousands of tiny compiles) of an eager apply."""
    return jax.jit(functools.partial(module.apply, **static))


def np_rand(shape, seed: int, lo: float = None, hi: float = None) -> np.ndarray:
    rs = np.random.RandomState(seed)
    if lo is None:
        return rs.standard_normal(shape).astype(np.float32)
    return (lo + (hi - lo) * rs.random_sample(shape)).astype(np.float32)


def to_t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def assert_close(got, want, atol: float, rtol: float) -> None:
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


# --------------------------------------------------------------------------
# training: the JAX trainer as the reference (tests/test_torch_trainer*.py).
# Weights: every leaf drawn with numpy (`randomize`) on shapes from
# jax.eval_shape of the inits. The JAX reference of a step is the JAX
# trainer's own `_loss` under jax.value_and_grad (jitted) and its own optax
# chain `tx`, applied to the parameters raveled into one vector: every
# transformation in the chain is elementwise except the global norm, which is
# the same over one vector, and one leaf compiles in a fraction of the time
# of ~400. The JAX side runs without remat, the port with it: remat
# recomputes the same function.
# --------------------------------------------------------------------------

B, IMG, LAT = 2, 16, 8


def jax_train_cfg(variant=jcfg.ModelVariant.APPEARANCE_POSE, **kw) -> jcfg.TrainConfig:
    """tests/test_trainer.py's tiny config, remat off (see the docstring)."""
    model = jcfg.ModelConfig(
        variant=variant,
        unet=jcfg.UNetConfig(**TINY_UNET, remat=False),
        pose_control=jcfg.ControlNetConfig(**TINY_UNET, remat=False),
        vae=jcfg.VAEConfig(base_channels=32, channel_mult=(1, 2), num_res_blocks=1),
        clip=jcfg.CLIPTextConfig(vocab_size=100, hidden_size=16, num_layers=1,
                                 num_heads=2, max_length=5),
        latent_size=LAT, dtype="float32")
    base = dict(model=model, batch_size_per_device=1,
                optim=jcfg.OptimConfig(learning_rate=1e-3, warmup_steps=1,
                                       frozen_dtype="float32"))
    base.update(kw)
    return jcfg.TrainConfig(**base)


def port_train_cfg(jc: jcfg.TrainConfig) -> tcfg.TrainConfig:
    """The same configuration for the port, with remat on."""
    tc = tcfg.from_dict(tcfg.TrainConfig, jcfg.to_dict(jc))
    m = tc.model
    return dataclasses.replace(tc, model=dataclasses.replace(
        m, unet=dataclasses.replace(m.unet, remat=True),
        pose_control=dataclasses.replace(m.pose_control, remat=True)))


def jax_params(jc: jcfg.TrainConfig, seed: int = 0):
    """Every leaf drawn with numpy; shapes from jax.eval_shape of the inits."""
    m, v, c = JModel(jc.model), JVAE(jc.model.vae), JCLIP(jc.model.clip)
    x = jnp.zeros((1, LAT, LAT, 4))
    kw = {"reference_noisy": x}
    if jc.model.has_pose:
        kw["pose_hint"] = jnp.zeros((1, 8 * LAT, 8 * LAT, 3))
    shapes = (
        jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), x, jnp.zeros((1,), jnp.int32),
                                      jnp.zeros((1, 5, 16)), **kw)),
        jax.eval_shape(lambda: v.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)),
                                      jax.random.PRNGKey(1))),
        jax.eval_shape(lambda: c.init(jax.random.PRNGKey(0), jnp.zeros((1, 5), jnp.int32))),
    )
    trees = [{"params": jax.tree.map(jnp.asarray, randomize(dict(s["params"]), seed + i))}
             for i, s in enumerate(shapes)]
    return (m, v, c), trees


def make_train_batch(seed: int = 0, pose: bool = True) -> dict:
    rs = np.random.RandomState(seed)
    batch = {"image": rs.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32),
             "reference": rs.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32),
             "input_ids": np.zeros((B, 5), np.int32)}
    if pose:
        batch["pose"] = rs.uniform(0, 1, (B, 8 * LAT, 8 * LAT, 3)).astype(np.float32)
    return batch


def jax_draws(jc: jcfg.TrainConfig, rng, n_image: int = B, n_ref: int = B,
              frames: int = 1) -> Draws:
    """The JAX trainer's draws for `rng`, reproduced from its splits, for
    `n_image` images (clips x `frames` in a temporal batch, one timestep per
    clip) and `n_ref` references."""
    rng_vae, rng_ref, rng_loss = jax.random.split(rng, 3)

    def vae_noise(r, n):  # Trainer._loss.vae_encode: one key per chunk
        chunk = jc.vae_encode_chunk
        if chunk and n > chunk and n % chunk == 0:
            keys = jax.random.split(r, n // chunk)
            return np.concatenate([np.asarray(jax.random.normal(k, (chunk, LAT, LAT, 4)))
                                   for k in keys])
        return np.asarray(jax.random.normal(r, (n, LAT, LAT, 4)))

    rng_t, rng_noise, _ = jax.random.split(rng_loss, 3)
    t = jnp.repeat(jax.random.randint(rng_t, (n_image // frames,), 0,
                                      jc.model.diffusion.timesteps, dtype=jnp.int32), frames)
    return Draws(t=to_t(t).long(),
                 noise=to_t(jax.random.normal(rng_noise, (n_image, LAT, LAT, 4))),
                 vae_image=to_t(vae_noise(rng_vae, n_image)),
                 vae_reference=(to_t(vae_noise(rng_ref, n_ref)) if jc.model.has_appearance
                                else None))


class JaxReference:
    """The JAX trainer's state and step (see the module docstring)."""

    def __init__(self, jc: jcfg.TrainConfig, seed: int = 0, loss_from=None):
        """`loss_from`: a reference whose compiled loss this one reuses (its
        config must differ from `jc` in `optim` other than frozen_dtype)."""
        (m, v, c), (mp, vp, cp) = jax_params(jc, seed)
        self.cfg = jc
        self.trainer = JTrainer(jc, m, v, c)
        self.state = self.trainer.create_state(mp, vp, cp)
        self.value_and_grad = (loss_from.value_and_grad if loss_from is not None else
                               jax.jit(jax.value_and_grad(self.trainer._loss, has_aux=True)))
        flat, unravel = ravel_pytree(self.state.train_params)
        self.opt_state = self.trainer.tx.init(flat)
        self.update = jax.jit(self._update)
        # one compile each instead of an eager op per leaf (hundreds of
        # shapes, each compiled on its own)
        self.ravel = jax.jit(lambda tree: ravel_pytree(tree)[0])
        self.unravel = jax.jit(unravel)
        rate = jc.optim.ema_rate
        self.ema_update = jax.jit(lambda e, q: jax.tree.map(
            lambda a, b: a * rate + b * (1.0 - rate), e, q))

    def _update(self, g, opt_state, p):
        updates, opt_state = self.trainer.tx.update(g, opt_state, p)
        return optax.apply_updates(p, updates), opt_state

    def loss_and_grads(self, batch, rng):
        return self.value_and_grad(self.state.train_params, self.state.frozen_params,
                                   jax.tree.map(jnp.asarray, batch), rng)

    def step(self, batch, rng):
        (loss, _), grads = self.loss_and_grads(batch, rng)
        p, self.opt_state = self.update(self.ravel(grads), self.opt_state,
                                        self.ravel(self.state.train_params))
        new_train = self.unravel(p)
        ema = self.state.ema_params
        if ema is not None:
            ema = self.ema_update(ema, new_train)
        self.state = self.state.replace(step=self.state.step + 1, train_params=new_train,
                                        ema_params=ema)
        return float(loss)


def port_trainer(ref: JaxReference) -> Trainer:
    tr = Trainer(port_train_cfg(ref.cfg), device="cpu")
    load_train_state(tr, ref.state)
    return tr


def to_port(flat: dict) -> dict:
    return dict(convert_leaf(path, leaf) for path, leaf in flat.items())


def assert_tree_close(got: dict, want_flat: dict, atol=2e-4, rtol=2e-4):
    want = to_port(want_flat)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().float().numpy(), w.numpy(),
                                   atol=atol, rtol=rtol, err_msg=k)


def port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}




# --------------------------------------------------------------------------
# metrics (tests/test_torch_metrics.py, test_torch_video_metrics.py):
# reference-layout state dicts drawn with numpy -- conv and linear weights
# He-scaled (std sqrt(2 / fan_in)), so activations keep their scale through
# deep ReLU nets and the features differ from image to image; BatchNorm
# running stats away from the identity -- and seeded frame trees.
# --------------------------------------------------------------------------


def assert_net_close(got, want) -> None:
    """A metric net in fp32: max|got - want| <= 2e-4 x max(1, max|want|)."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = 2e-4 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"max abs err {err:.3e} > tol {tol:.3e}"


def he_normal(rs, shape) -> np.ndarray:
    fan_in = int(np.prod(shape[1:]))
    return (rs.standard_normal(shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)


def bn_state(rs, prefix: str, c: int) -> dict:
    return {f"{prefix}.weight": (1 + 0.1 * rs.standard_normal(c)).astype(np.float32),
            f"{prefix}.bias": (0.1 * rs.standard_normal(c)).astype(np.float32),
            f"{prefix}.running_mean": (0.1 * rs.standard_normal(c)).astype(np.float32),
            f"{prefix}.running_var": rs.uniform(0.5, 1.5, c).astype(np.float32)}


def lpips_state(seed: int) -> dict:
    """An `lpips.LPIPS(net='vgg')` state dict: torchvision VGG16 conv indices
    under `net.slice{1..5}`, non-negative `lin{i}.model.1.weight`."""
    from magicdance_tpu_torch.metrics.lpips import LPIPS

    tv_idx = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    slice_of = [1, 1, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5]
    rs = np.random.RandomState(seed)
    sd = {}
    for k, v in LPIPS().state_dict().items():
        if k.startswith("vgg."):
            ci, leaf = int(k.split(".")[1][len("conv_"):]), k.rsplit(".", 1)[1]
            ref = f"net.slice{slice_of[ci]}.{tv_idx[ci]}.{leaf}"
            sd[ref] = (he_normal(rs, tuple(v.shape)) if leaf == "weight"
                       else (0.1 * rs.standard_normal(tuple(v.shape))).astype(np.float32))
        else:
            i = int(k.split(".")[0][len("lin_"):])
            sd[f"lin{i}.model.1.weight"] = np.abs(he_normal(rs, tuple(v.shape)))
    return sd


def inception_state(seed: int) -> dict:
    """A torchvision `inception_v3` state dict (conv + BN per conv, fc), with
    two AuxLogits entries the converter must skip."""
    from magicdance_tpu_torch.metrics.inception import InceptionV3

    rs = np.random.RandomState(seed)
    sd = {}
    for k, v in InceptionV3().state_dict().items():
        prefix, leaf = k.rsplit(".", 1)
        if prefix == "fc":
            sd[k] = (he_normal(rs, tuple(v.shape)) if leaf == "weight"
                     else (0.1 * rs.standard_normal(tuple(v.shape))).astype(np.float32))
        elif leaf == "weight":
            sd[f"{prefix}.conv.weight"] = he_normal(rs, tuple(v.shape))
            sd.update(bn_state(rs, f"{prefix}.bn", v.shape[0]))
    sd["AuxLogits.conv0.conv.weight"] = he_normal(rs, (128, 768, 1, 1))
    sd["AuxLogits.fc.weight"] = he_normal(rs, (1000, 768))
    return sd


def clip_vision_state(seed: int, hidden: int, layers: int, patch: int, proj: int,
                      image_size: int) -> dict:
    """The vision keys of an HF `CLIPModel` state dict (with the
    `pre_layrnorm` spelling) for a ViT of these sizes."""
    rs = np.random.RandomState(seed)
    p = "vision_model"

    def w(*shape):
        return he_normal(rs, shape)

    def small(*shape):
        return (0.1 * rs.standard_normal(shape)).astype(np.float32)

    def ln(key):
        return {f"{key}.weight": 1 + small(hidden), f"{key}.bias": small(hidden)}

    sd = {f"{p}.embeddings.patch_embedding.weight": w(hidden, 3, patch, patch),
          f"{p}.embeddings.class_embedding": small(hidden),
          f"{p}.embeddings.position_embedding.weight":
              small((image_size // patch) ** 2 + 1, hidden),
          **ln(f"{p}.pre_layrnorm"), **ln(f"{p}.post_layernorm"),
          "visual_projection.weight": w(proj, hidden)}
    for i in range(layers):
        lp = f"{p}.encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{lp}.self_attn.{name}.weight"] = w(hidden, hidden)
            sd[f"{lp}.self_attn.{name}.bias"] = small(hidden)
        sd.update(ln(f"{lp}.layer_norm1"))
        sd.update(ln(f"{lp}.layer_norm2"))
        sd.update({f"{lp}.mlp.fc1.weight": w(4 * hidden, hidden),
                   f"{lp}.mlp.fc1.bias": small(4 * hidden),
                   f"{lp}.mlp.fc2.weight": w(hidden, 4 * hidden),
                   f"{lp}.mlp.fc2.bias": small(hidden)})
    return sd


def save_state(sd: dict, path) -> str:
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, str(path))
    return str(path)


def write_frame_tree(root, seqs: int, frames: int, size: int, seed: int,
                     shift_from: int = None) -> None:
    """`{root}/seq{i}/gen_images|gt_images/{j:03d}.png`: a seeded uint8 base
    frame in [0, 128) per j; the ground truth is the base plus noise (std
    12), the generated frame the base itself, +120 for j >= shift_from (a
    second distribution, so scores over the first frames and over all
    differ)."""
    from PIL import Image

    rs = np.random.RandomState(seed)
    for s in range(seqs):
        gen_dir, gt_dir = root / f"seq{s}" / "gen_images", root / f"seq{s}" / "gt_images"
        gen_dir.mkdir(parents=True)
        gt_dir.mkdir(parents=True)
        for j in range(frames):
            base = rs.randint(0, 128, (size, size, 3))
            gt = base + np.round(rs.standard_normal(base.shape) * 12)
            gen = base + (120 if shift_from is not None and j >= shift_from else 0)
            for d, img in ((gen_dir, gen), (gt_dir, gt)):
                Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(d / f"{j:03d}.png")
