"""Port networks (UNet, pose ControlNet, composite denoiser, CLIP, VAE)
against the JAX package's Flax modules at the tiny config: same numpy
inputs, same randomised weights (every leaf) via convert.from_jax. fp32;
tolerance 5e-4 abs/rel, the converter oracle's (tests/test_convert.py) --
deeper networks than the single layers, so summation-order differences
accumulate more."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicdance_tpu.models.clip import CLIPTextEncoder as JCLIP
from magicdance_tpu.models.controlnet import PoseControlNet as JCN
from magicdance_tpu.models.magicpose import MagicPoseModel as JModel
from magicdance_tpu.models.unet import UNet as JUNet
from magicdance_tpu.models.unet import num_bank_entries as j_num_bank
from magicdance_tpu.models.vae import AutoencoderKL as JVAE
from magicdance_tpu_torch.convert.from_jax import flax_to_state_dict, load_flax_params
from magicdance_tpu_torch.models.clip import CLIPTextEncoder
from magicdance_tpu_torch.models.controlnet import PoseControlNet
from magicdance_tpu_torch.models.magicpose import MagicPoseModel
from magicdance_tpu_torch.models.unet import UNet, num_bank_entries
from magicdance_tpu_torch.models.vae import AutoencoderKL
from torch_port_util import (
    assert_close,
    np_rand,
    port_cfg,
    randomize,
    tiny_model_cfg_jax,
    to_t,
)
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

TOL = dict(atol=5e-4, rtol=5e-4)
F32 = jnp.float32  # the Flax UNet / ControlNet compute in bf16 unless told
JCFG = tiny_model_cfg_jax()
TCFG = port_cfg(JCFG)
B = 2
X = np_rand((B, 8, 8, 4), 0)
T = np.array([3, 711])
CTX = np_rand((B, 77, 16), 1)
REF = np_rand((1, 8, 8, 4), 2)
HINT = np_rand((B, 64, 64, 3), 3, 0.0, 1.0)


def init_random(module, args, seed, **kw):
    variables = module.init(jax.random.PRNGKey(0), *args, **kw)
    return randomize(jax.tree.map(np.asarray, dict(variables)), seed)


def jx(a):
    return jnp.asarray(a)


@pytest.fixture(scope="module")
def unets():
    jm = JUNet(JCFG.unet)
    params = init_random(jm, (jx(X), jx(T), jx(CTX)), 10, dtype=F32)
    tm = UNet(TCFG.unet).eval()
    load_flax_params(tm, params)
    return jm, jax.tree.map(jnp.asarray, params), tm


def test_state_dict_keys_match_flax_tree(unets):
    jm, params, tm = unets
    assert set(flax_to_state_dict(params)) == set(tm.state_dict())
    assert num_bank_entries(TCFG.unet) == j_num_bank(JCFG.unet) == 7


@pytest.mark.parametrize("mode", ["plain", "write", "read_bank1", "read_bankB",
                                  "pose_residuals"])
def test_unet_modes(unets, mode):
    jm, params, tm = unets
    n = num_bank_entries(TCFG.unet)
    jkw, tkw = {}, {}
    if mode == "write":
        jkw["collect_bank"] = tkw["collect_bank"] = True
    elif mode.startswith("read"):
        bb = 1 if mode == "read_bank1" else B
        rs = np.random.RandomState(20)
        # bank entries have the traversal's (S, C): take them from a write pass
        _, shapes = jm.apply(params, jx(X[:1]), jx(T[:1]), jx(CTX[:1]),
                             collect_bank=True, dtype=F32)
        bank = [rs.standard_normal((bb,) + tuple(e.shape[1:])).astype(np.float32)
                for e in shapes]
        assert len(bank) == n
        jkw["bank"] = tuple(jx(e) for e in bank)
        tkw["bank"] = tuple(to_t(e) for e in bank)
    elif mode == "pose_residuals":
        rs = np.random.RandomState(21)
        res = [rs.standard_normal((B, 8 // s, 8 // s, c)).astype(np.float32)
               for s, c in ((1, 32), (1, 32), (2, 32), (2, 64), (2, 64))]
        jkw["pose_residuals"] = tuple(jx(r) for r in res)
        tkw["pose_residuals"] = tuple(to_t(r) for r in res)
    want, want_bank = jm.apply(params, jx(X), jx(T), jx(CTX), dtype=F32, **jkw)
    with torch.no_grad():
        got, got_bank = tm(to_t(X), torch.tensor(T), to_t(CTX), **tkw)
    assert_close(got, want, **TOL)
    assert len(got_bank) == len(want_bank) == (n if mode == "write" else 0)
    for g, w in zip(got_bank, want_bank):
        assert_close(g, w, **TOL)
    assert float(np.abs(np.asarray(want)).max()) > 1e-2  # not the zero-init output


def test_unet_rejects_bad_bank(unets):
    _, _, tm = unets
    with torch.no_grad(), pytest.raises(ValueError):
        tm(to_t(X), torch.tensor(T), to_t(CTX), bank=(to_t(REF),))


def test_pose_controlnet_residuals():
    jm = JCN(JCFG.pose_control)
    params = init_random(jm, (jx(X), jx(HINT), jx(T), jx(CTX)), 30, dtype=F32)
    want = jm.apply(jax.tree.map(jnp.asarray, params), jx(X), jx(HINT), jx(T), jx(CTX),
                    dtype=F32)
    tm = PoseControlNet(TCFG.pose_control, in_channels=4).eval()
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(to_t(X), to_t(HINT), torch.tensor(T), to_t(CTX))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert_close(g, w, **TOL)


@pytest.mark.parametrize("uc", [False, True])
def test_magicpose_forward(uc):
    jm = JModel(JCFG)
    params = init_random(jm, (jx(X), jx(T), jx(CTX)), 40,
                         reference_noisy=jx(REF), pose_hint=jx(HINT))
    jp = jax.tree.map(jnp.asarray, params)
    tm = MagicPoseModel(TCFG).eval()
    load_flax_params(tm, params)
    if uc:
        want = jm.apply(jp, jx(X), jx(T), jx(CTX), uc=True)
        with torch.no_grad():
            got = tm(to_t(X), torch.tensor(T), to_t(CTX), uc=True)
    else:
        bank = jm.apply(jp, jx(REF), jx(T[:1]), jx(CTX[:1]), method=jm.compute_bank)
        want = jm.apply(jp, jx(X), jx(T), jx(CTX), bank=bank, pose_hint=jx(HINT))
        with torch.no_grad():
            tbank = tm.compute_bank(to_t(REF), torch.tensor(T[:1]), to_t(CTX[:1]))
            got = tm(to_t(X), torch.tensor(T), to_t(CTX), bank=tbank, pose_hint=to_t(HINT))
            # the bank computed inline from reference_noisy is the same bank
            inline = tm(to_t(X), torch.tensor(T), to_t(CTX),
                        reference_noisy=to_t(REF), pose_hint=to_t(HINT))
        for g, w in zip(tbank, bank):
            assert_close(g, w, **TOL)
        assert_close(inline, want, **TOL)
    assert_close(got, want, **TOL)


def test_clip_text_encoder():
    jm = JCLIP(JCFG.clip)
    ids = np.full((2, 77), 49407, np.int32)
    ids[:, 0] = 49406
    ids[1, 1:6] = [320, 1125, 539, 1000, 7]
    params = init_random(jm, (jx(ids),), 50)
    want = jm.apply(jax.tree.map(jnp.asarray, params), jx(ids))
    tm = CLIPTextEncoder(TCFG.clip).eval()
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    assert got.dtype == torch.float32
    assert_close(got, want, **TOL)


def test_vae_encode_decode():
    jm = JVAE(JCFG.vae)
    img = np_rand((2, 64, 64, 3), 60, -1.0, 1.0)
    params = init_random(jm, (jx(img), jax.random.PRNGKey(1)), 61)
    jp = jax.tree.map(jnp.asarray, params)
    post = jm.apply(jp, jx(img), method=jm.encode)
    z = np_rand((2, 8, 8, 4), 62)
    dec = jm.apply(jp, jx(z), method=jm.decode)
    tm = AutoencoderKL(TCFG.vae).eval()
    load_flax_params(tm, params)
    with torch.no_grad():
        tpost = tm.encode(to_t(img))
        tdec = tm.decode(to_t(z))
    assert_close(tpost.mode(), post.mode(), **TOL)
    assert_close(tpost.logvar, post.logvar, **TOL)
    assert tdec.shape == (2, 64, 64, 3)
    assert_close(tdec, dec, **TOL)
