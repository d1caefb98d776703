"""The port's direct loader of reference checkpoints
(`magicdance_tpu_torch.convert.torch_convert`) against the JAX converter
(`magicdance_tpu.convert.torch_convert` -> `convert.from_jax`): bit-equal
state dicts for every layout, motion modules and the surgery helpers; the
reverse direction; forward parity of the converted networks with the torch
oracle `tests/torch_ref.py` (fp32, 2e-4); the JAX converter's two gaps raise
in the port; the legacy surgery leaves no shared storage."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magicdance_tpu.config as jcfg
from magicdance_tpu.convert import torch_convert as J
from magicdance_tpu_torch.convert import torch_convert as T
from magicdance_tpu_torch.convert.from_jax import flax_to_state_dict
from magicdance_tpu_torch.models import MagicPoseModel
from magicdance_tpu_torch.models.unet import UNet
from magicdance_tpu_torch.pipeline import MagicPosePipeline
from torch_port_util import (  # noqa: F401  (autouse fixture)
    TINY_UNET,
    port_cfg,
    reference_state,
    tiny_model_cfg_jax,
    tiny_temporal_cfg_jax,
    torch_single_thread,
)
from torch_ref import TorchControlNet, TorchMotionModule, TorchUNet, TorchVAE

NETS = ("model", "vae", "clip")


def legacy_pairs(cfg):
    """control_sd15_ini.ckpt layout: SD UNet + `control_model.*` (a
    ControlNet) + VAE + CLIP, no appearance or pose keys."""
    pairs = [(r, p) for r, p in T.reference_key_map(cfg)
             if not r.startswith((T.APPEARANCE, T.POSE))]
    return pairs + T.controlnet_key_map(T.LEGACY_CONTROL, cfg.pose_control, "model.pose_control.")


def layout(name, cfg):
    if name == "current":
        return T.reference_key_map(cfg)
    if name == "legacy":
        return legacy_pairs(cfg)
    if name == "no_vae_clip":
        return T.reference_key_map(cfg, vae=False, clip=False)
    if name == "clip_text_model":
        return T.reference_key_map(cfg, text_model=True)
    raise ValueError(name)


def jax_state_dicts(sd_np, jc):
    """The JAX converter, then `convert.from_jax`: the state dicts the port
    reached before it had a loader of its own."""
    tree = J.convert_magicpose_state(sd_np, jc)
    return {net: flax_to_state_dict(tree[net]) for net in NETS if net in tree}


def assert_bit_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k].float(), want[k]), k


@pytest.mark.parametrize("name", ["current", "legacy", "no_vae_clip", "clip_text_model"])
def test_loader_bit_equal_to_jax_converter(name):
    jc = tiny_model_cfg_jax()
    cfg = port_cfg(jc)
    sd = reference_state(cfg, layout(name, cfg), seed=1)
    got = T.convert_magicpose_state({k: torch.from_numpy(v) for k, v in sd.items()}, cfg)
    want = jax_state_dicts(sd, jc)
    assert sorted(got) == sorted(want)
    assert sorted(got) == (["model"] if name == "no_vae_clip" else sorted(NETS))
    for net in want:
        assert_bit_equal(got[net], want[net])
    if name == "no_vae_clip":
        with pytest.raises(KeyError, match="lacks them"):
            MagicPosePipeline(cfg, device="cpu").load_state_dicts(got)
    else:
        MagicPosePipeline(cfg, device="cpu").load_state_dicts(got)  # strict


def test_load_torch_state_containers_and_dtypes(tmp_path):
    """.th (raw) and .ckpt ({"state_dict": ...}) containers, fp16 and bf16
    tensors kept as they are and cast to each parameter's dtype on load;
    other containers are rejected."""
    jc = tiny_model_cfg_jax()
    cfg = port_cfg(jc)
    sd = {k: torch.from_numpy(v) for k, v in reference_state(cfg, T.reference_key_map(cfg),
                                                             seed=2).items()}
    for dtype, wrap in ((torch.float16, False), (torch.bfloat16, True)):
        half = {k: v.to(dtype) for k, v in sd.items()}
        path = tmp_path / f"m_{dtype}.ckpt"
        torch.save({"state_dict": half, "global_step": 3} if wrap else half, path)
        loaded = T.load_torch_state(str(path))
        assert sorted(loaded) == sorted(half)
        assert all(t.dtype == dtype for t in loaded.values())
        pipe = MagicPosePipeline(cfg, device="cpu")
        pipe.load_state_dicts(T.convert_magicpose_state(loaded, cfg))
        params = {f"{n}.{k}": t for n in NETS
                  for k, t in getattr(pipe, n).state_dict().items()}
        for ref, port in T.reference_key_map(cfg):
            assert torch.equal(params[port], half[ref].to(params[port].dtype)), port
    torch.save([torch.zeros(1)], tmp_path / "bad.th")
    with pytest.raises(ValueError, match="unsupported checkpoint container"):
        T.load_torch_state(str(tmp_path / "bad.th"))


def _tiny_mm_ckpt(prefixes_channels, seed):
    torch.manual_seed(seed)
    sd = {}
    for prefix, ch in prefixes_channels:
        sd.update({f"{prefix}.{k}": v for k, v in TorchMotionModule(ch, 2).state_dict().items()})
    return sd


# (site prefix, channels) of the tiny temporal UNet (R = 1): down (level, j)
# -> enc_motion_{level*R+j}; up (i, j) -> dec_motion_{i*(R+1)+j}, i counted
# from the deepest level; the mid-block module is skipped
ANIMATEDIFF = [("down_blocks.0.motion_modules.0", 32), ("down_blocks.1.motion_modules.0", 64),
               ("up_blocks.0.motion_modules.0", 64), ("up_blocks.0.motion_modules.1", 64),
               ("up_blocks.1.motion_modules.0", 32), ("up_blocks.1.motion_modules.1", 32),
               ("mid_block.motion_modules.0", 64)]
REFERENCE_MM = [("model.diffusion_model.input_blocks_motion_module.1.0", 64),
                ("output_blocks_motion_module.2.0", 32)]


@pytest.mark.parametrize("sites,names", [
    (ANIMATEDIFF, ["dec_motion_0", "dec_motion_1", "dec_motion_2", "dec_motion_3",
                   "enc_motion_0", "enc_motion_1"]),
    (REFERENCE_MM, ["dec_motion_2", "enc_motion_1"]),
], ids=["animatediff", "reference_layout"])
def test_motion_modules_bit_equal_to_jax(sites, names):
    jc = tiny_temporal_cfg_jax()
    cfg = port_cfg(jc)
    sd = _tiny_mm_ckpt(sites, seed=3)
    got = T.convert_motion_modules(sd, cfg.unet)
    tree = J.convert_motion_modules({k: v.numpy() for k, v in sd.items()}, jc.unet)
    assert sorted(tree) == names
    assert sorted({k.split(".")[0] for k in got}) == names
    assert_bit_equal(got, flax_to_state_dict(tree))
    with pytest.raises(KeyError, match="no motion-module keys"):
        T.convert_motion_modules({"x.weight": torch.zeros(1)}, cfg.unet)


def test_expand_conv_in_and_merge_motion_state_match_jax():
    jc = tiny_temporal_cfg_jax()
    cfg = port_cfg(jc)
    sd = reference_state(cfg, T.unet_key_map(T.UNET, cfg.unet, "model.unet."), seed=4)
    unet_tree = J.convert_unet(sd, T.UNET, jc.unet)
    unet_sd = {p[len("model.unet."):]: torch.from_numpy(sd[r])
               for r, p in T.unet_key_map(T.UNET, cfg.unet, "model.unet.")}
    assert_bit_equal(unet_sd, flax_to_state_dict(unet_tree))

    got = T.expand_conv_in(unet_sd, 9)
    assert_bit_equal(got, flax_to_state_dict(J.expand_conv_in(unet_tree, 9)))
    assert torch.equal(got["conv_in.weight"][:, 4:], torch.zeros(32, 5, 3, 3))
    assert T.expand_conv_in(unet_sd, 4).keys() == unet_sd.keys()
    with pytest.raises(ValueError, match="cannot shrink"):
        T.expand_conv_in(unet_sd, 3)

    mm = _tiny_mm_ckpt(ANIMATEDIFF, seed=5)
    mm_tree = J.convert_motion_modules({k: v.numpy() for k, v in mm.items()}, jc.unet)
    merged = T.merge_motion_state(unet_sd, T.convert_motion_modules(mm, cfg.unet))
    assert_bit_equal(merged, flax_to_state_dict(J.merge_motion_state(unet_tree, mm_tree)))
    # every parameter of the temporal UNet is set (strict)
    T.load_strict(UNet(cfg.unet), merged, "unet")


def test_to_flax_round_trips_with_from_jax():
    jc = tiny_model_cfg_jax()
    cfg = port_cfg(jc)
    sd = reference_state(cfg, T.reference_key_map(cfg), seed=6)
    states = T.convert_magicpose_state({k: torch.from_numpy(v) for k, v in sd.items()}, cfg)
    tree = T.to_flax(states)
    want = J.convert_magicpose_state(sd, jc)
    flat_got = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_got:
        assert leaf.dtype == np.float32 and np.array_equal(leaf, flat_want[path]), path
    for net in NETS:
        assert_bit_equal(flax_to_state_dict(tree[net]), {k: v.float() for k, v in
                                                         states[net].items()})


# --------------------------------------------------------------------------
# forward parity with the torch oracle (as tests/test_convert.py)
# --------------------------------------------------------------------------

def _prefixed(module, prefix):
    return {f"{prefix}.{k}": v.detach() for k, v in module.state_dict().items()}


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_unet_forward_parity_with_oracle():
    """UNet eps, the bank it writes, a bank read and pose residuals."""
    torch.manual_seed(0)
    tunet = TorchUNet(**{k: v for k, v in TINY_UNET.items() if k != "num_heads"},
                      heads=TINY_UNET["num_heads"]).eval()
    cfg = port_cfg(jcfg.UNetConfig(**TINY_UNET))
    unet = UNet(cfg).eval()
    sd = _prefixed(tunet, T.UNET)
    T.load_strict(unet, {p: sd[r] for r, p in T.unet_key_map(T.UNET, cfg)}, "unet")
    rs = np.random.RandomState(0)
    x, ref = rs.randn(1, 8, 8, 4).astype(np.float32), rs.randn(1, 8, 8, 4).astype(np.float32)
    t = np.array([25])
    ctx = rs.randn(1, 5, 16).astype(np.float32)
    shapes = [(1, 8, 8, 32), (1, 8, 8, 32), (1, 4, 4, 32), (1, 4, 4, 64), (1, 4, 4, 64)]
    res = [rs.randn(*s).astype(np.float32) * 0.1 for s in shapes]
    with torch.no_grad():
        want, tbank = tunet(_nchw(ref), torch.from_numpy(t), torch.from_numpy(ctx),
                            collect_bank=True)
        want_read = tunet(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx), bank=tbank)
        want_res = tunet(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx),
                         pose_residuals=[_nchw(r) for r in res])
        got, bank = unet(torch.from_numpy(ref), torch.from_numpy(t), torch.from_numpy(ctx),
                         collect_bank=True)
        got_read, _ = unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                           bank=bank)
        got_res, _ = unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                          pose_residuals=[torch.from_numpy(r) for r in res])
    np.testing.assert_allclose(got.numpy(), _nhwc(want), atol=2e-4, rtol=2e-4)
    assert len(bank) == len(tbank)
    for e, te in zip(bank, tbank):
        np.testing.assert_allclose(e.numpy(), te.numpy(), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got_read.numpy(), _nhwc(want_read), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got_res.numpy(), _nhwc(want_res), atol=2e-4, rtol=2e-4)


def test_controlnet_forward_parity_with_oracle():
    from magicdance_tpu_torch.models.controlnet import PoseControlNet

    torch.manual_seed(1)
    tcn = TorchControlNet(**{k: v for k, v in TINY_UNET.items() if k != "num_heads"},
                          heads=TINY_UNET["num_heads"]).eval()
    ccfg = port_cfg(jcfg.ControlNetConfig(**TINY_UNET))
    net = PoseControlNet(ccfg).eval()
    sd = _prefixed(tcn, T.LEGACY_CONTROL)
    T.load_strict(net, {p: sd[r] for r, p in T.controlnet_key_map(T.LEGACY_CONTROL, ccfg)},
                  "pose_control")
    rs = np.random.RandomState(2)
    x = rs.randn(1, 8, 8, 4).astype(np.float32)
    hint = rs.rand(1, 64, 64, 3).astype(np.float32)
    t, ctx = np.array([123]), rs.randn(1, 5, 16).astype(np.float32)
    with torch.no_grad():
        want = tcn(_nchw(x), _nchw(hint), torch.from_numpy(t), torch.from_numpy(ctx))
        got = net(torch.from_numpy(x), torch.from_numpy(hint), torch.from_numpy(t),
                  torch.from_numpy(ctx))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _nhwc(w), atol=2e-4, rtol=2e-4)


def test_vae_forward_parity_with_oracle():
    from magicdance_tpu_torch.models import AutoencoderKL

    torch.manual_seed(5)
    tvae = TorchVAE(base=32, mult=(1, 2), zc=4).eval()
    vcfg = port_cfg(jcfg.VAEConfig(base_channels=32, channel_mult=(1, 2), num_res_blocks=1))
    vae = AutoencoderKL(vcfg).eval()
    sd = _prefixed(tvae, T.VAE)
    T.load_strict(vae, {p: sd[r] for r, p in T.vae_key_map(T.VAE, vcfg)}, "vae")
    rs = np.random.RandomState(4)
    x = rs.randn(1, 32, 32, 3).astype(np.float32)
    z = rs.randn(1, 16, 16, 4).astype(np.float32)
    with torch.no_grad():
        mean_ref = tvae.encode_moments(_nchw(x)).chunk(2, dim=1)[0]
        dec_ref = tvae.decode(_nchw(z))
        post = vae.encode(torch.from_numpy(x))
        dec = vae.decode(torch.from_numpy(z))
    np.testing.assert_allclose(post.mean.numpy(), _nhwc(mean_ref), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(dec.numpy(), _nhwc(dec_ref), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("wrapped", [False, True], ids=["bare", "cond_stage_model"])
def test_clip_forward_parity_with_hf(wrapped):
    """HF CLIPTextModel keys (they carry `text_model.`), bare or under
    `cond_stage_model.transformer`; `position_ids` is not read."""
    from transformers import CLIPTextConfig as HFConfig, CLIPTextModel

    from magicdance_tpu_torch.models import CLIPTextEncoder

    torch.manual_seed(3)
    hf = CLIPTextModel(HFConfig(vocab_size=99, hidden_size=32, intermediate_size=128,
                                num_hidden_layers=2, num_attention_heads=4,
                                max_position_embeddings=10)).eval()
    prefix = T.CLIP if wrapped else ""
    sd = {f"{prefix}.{k}" if prefix else k: v for k, v in hf.state_dict().items()}
    ccfg = port_cfg(jcfg.CLIPTextConfig(vocab_size=99, hidden_size=32, num_layers=2,
                                        num_heads=4, max_length=10))
    enc = CLIPTextEncoder(ccfg).eval()
    assert T._has_text_model(sd, prefix)
    T.load_strict(enc, {p: sd[r] for r, p in T.clip_key_map(prefix, ccfg, text_model=True)},
                  "clip")
    ids = torch.tensor([[1, 5, 7, 2, 0, 0, 0, 0, 0, 0]])
    with torch.no_grad():
        want = hf(ids).last_hidden_state
        got = enc(ids)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4, rtol=2e-4)


def test_motion_module_in_unet_forward_parity():
    """An image checkpoint plus AnimateDiff motion modules fill the temporal
    UNet (strict); a motion module taken from that UNet reproduces the torch
    oracle, and the whole temporal UNet the JAX UNet on the JAX converter's
    merged tree."""
    from magicdance_tpu.models.unet import UNet as JUNet

    jc = tiny_temporal_cfg_jax()
    cfg = port_cfg(jc)
    torch.manual_seed(3)
    tunet = TorchUNet(**{k: v for k, v in TINY_UNET.items() if k != "num_heads"},
                      heads=TINY_UNET["num_heads"])
    sd = _prefixed(tunet, T.UNET)
    mm = _tiny_mm_ckpt(ANIMATEDIFF, seed=7)
    unet = UNet(cfg.unet).eval()
    unet_sd = {p: sd[r] for r, p in T.unet_key_map(T.UNET, cfg.unet)}
    T.load_strict(unet, T.merge_motion_state(unet_sd, T.convert_motion_modules(mm, cfg.unet)),
                  "unet")

    ref_mod = TorchMotionModule(32, 2).eval()
    ref_mod.load_state_dict({k[len("down_blocks.0.motion_modules.0."):]: v for k, v in mm.items()
                             if k.startswith("down_blocks.0.motion_modules.0.")})
    b, f, hw = 2, 4, 8
    x = np.random.RandomState(0).randn(b * f, 32, hw, hw).astype(np.float32)
    with torch.no_grad():
        want = ref_mod(torch.from_numpy(x), video_length=f)
        got = unet.enc_motion_0(torch.from_numpy(x), f)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4, rtol=2e-4)

    tree = J.merge_motion_state(
        J.convert_unet({k: v.numpy() for k, v in sd.items()}, T.UNET, jc.unet),
        J.convert_motion_modules({k: v.numpy() for k, v in mm.items()}, jc.unet))
    rs = np.random.RandomState(1)
    xl = rs.randn(4, 8, 8, 4).astype(np.float32)
    t = np.array([5, 5, 700, 700])
    ctx = rs.randn(4, 5, 16).astype(np.float32)
    jout, _ = jax.jit(lambda p, a, tt, c: JUNet(jc.unet).apply(
        {"params": p}, a, tt, c, num_frames=2, dtype=jnp.float32))(
        jax.tree.map(jnp.asarray, tree), xl, t, ctx)
    with torch.no_grad():
        out, _ = unet(torch.from_numpy(xl), torch.from_numpy(t), torch.from_numpy(ctx),
                      num_frames=2)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-4, rtol=2e-4)


# --------------------------------------------------------------------------
# the JAX converter's gaps, and the surgery's storage
# --------------------------------------------------------------------------

def test_jax_gaps_raise_in_the_port():
    """The JAX converter converts neither the DUAL_CONTROL image ControlNet
    nor motion modules from one `model_state-*.th`; the port's strict load
    names the missing parts instead of leaving them random."""
    base = tiny_model_cfg_jax()
    for jc, part in ((dataclasses.replace(base, variant=jcfg.ModelVariant.DUAL_CONTROL,
                                          image_control=base.pose_control),
                      "image_control_model"),
                     (tiny_temporal_cfg_jax(), "unet.enc_motion_0")):
        cfg = port_cfg(jc)
        sd = reference_state(cfg, T.reference_key_map(cfg), seed=8)
        jtree = J.convert_magicpose_state(sd, jc)["model"]["params"]
        assert "image_control_model" not in jtree
        assert not any(k.startswith(("enc_motion", "dec_motion")) for k in jtree["unet"])
        states = T.convert_magicpose_state({k: torch.from_numpy(v) for k, v in sd.items()}, cfg)
        with pytest.raises(KeyError, match=part):
            MagicPosePipeline(cfg, device="cpu").load_state_dicts(states)


def test_legacy_surgery_leaves_no_shared_storage():
    jc = tiny_model_cfg_jax()
    cfg = port_cfg(jc)
    sd = {k: torch.from_numpy(v) for k, v in reference_state(cfg, legacy_pairs(cfg),
                                                             seed=9).items()}
    model = MagicPoseModel(cfg)
    T.load_strict(model, T.convert_magicpose_state(sd, cfg)["model"], "model")
    # control_model -> appearance encoder and pose ControlNet; SD decoder ->
    # appearance decoder: equal values, separate storage
    pairs = [("appearance_unet.enc_res_0.conv_in.weight", "pose_control.enc_res_0.conv_in.weight"),
             ("appearance_unet.dec_res_0.conv_in.weight", "unet.dec_res_0.conv_in.weight"),
             ("appearance_unet.conv_out.weight", "unet.conv_out.weight")]
    params = dict(model.named_parameters())
    for a, b in pairs:
        assert torch.equal(params[a], params[b])
        before = params[b].detach().clone()
        with torch.no_grad():
            params[a].add_(1.0)
        assert torch.equal(params[b], before), (a, b)
    assert torch.equal(sd["control_model.input_blocks.1.0.in_layers.2.weight"],
                       params["pose_control.enc_res_0.conv_in.weight"])
