"""The port's int8 frozen storage (`models/quant.py`, the policy in
`train/quant.py`, `frozen_dtype="int8"`) against the JAX package's
`train/quant.py` and its trainer.

The JAX side is a tiny stage-2 `TrainState` created with
`frozen_dtype="int8"` (its frozen tree holds `QuantizedLeaf(q, scale)`),
with every leaf drawn with numpy (tests/torch_port_util.py). Checked: the
port's own quantization of the same fp32 weights equals JAX's (int8 values
exactly, scales to the bit); `load_train_state` carries a JAX int8 state
across as int8 and scales; the int8 trainer's loss, gradients and steps
match JAX's int8 step (tolerances of tests/test_torch_trainer_stages.py:
loss 1e-5 relative, gradients 2e-4, updates 2% of the learning rate); an
int8 trainer computes what a bf16-frozen trainer holding the dequantized
values computes, bit for bit; the checkpoint round trip; the preview's
dequantized state. ZeRO-1 and the tensor-parallel plan with int8 leaves:
tests/test_torch_quant_parallel.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from magicdance_tpu import config as J
from magicdance_tpu.train.quant import QuantizedLeaf, quantize_tree
from magicdance_tpu_torch.convert.from_jax import flat_to_state_dict, flax_to_state_dict
from magicdance_tpu_torch.models import quant
from magicdance_tpu_torch.train.quant import should_quantize
from magicdance_tpu_torch.train.trainer import Trainer
from torch_port_util import (
    JaxReference,
    assert_tree_close,
    jax_draws,
    jax_params,
    jax_train_cfg,
    make_train_batch,
    port_batch,
    port_train_cfg,
    port_trainer,
    to_port,
)
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

LR = 1e-3


def int8_cfg(**kw):
    # adam_eps 1e-4 bounds how far the fp32 noise of a near-zero gradient
    # moves a parameter (Adam normalizes each element)
    return jax_train_cfg(optim=J.OptimConfig(learning_rate=LR, warmup_steps=1, adam_eps=1e-4,
                                             frozen_dtype="int8", **kw))


@pytest.fixture(scope="module")
def params():
    return jax_params(int8_cfg(), 11)


@pytest.fixture(scope="module")
def ref(params):
    return JaxReference(int8_cfg(), params=params)


@pytest.fixture(scope="module")
def fp32_states(params):
    """The fp32 weights the JAX int8 state was quantized from, as port state
    dicts."""
    return [flax_to_state_dict(jax.tree.map(np.asarray, t)) for t in params[1]]


def port_int8_from_fp32(jc, states):
    """A port int8 trainer that quantizes the fp32 weights itself."""
    tr = Trainer(port_train_cfg(jc), device="cpu")
    tr.load_state_dicts(*states)
    return tr


def test_should_quantize_matches_jax():
    from magicdance_tpu.train.quant import _should_quantize

    for shape, dtype in (((64, 64), np.float32), ((63, 64), np.float32), ((4096,), np.float32),
                         ((3, 3, 32, 32), np.float32), ((64, 64), np.int32),
                         ((2, 4096), np.float32)):
        a = np.zeros(shape, dtype)
        assert should_quantize(torch.from_numpy(a)) == bool(_should_quantize(a)), shape


def test_port_quantization_equals_jax_quantize_tree(ref, fp32_states):
    """Frozen denoiser leaves, VAE and CLIP, quantized by the port from the
    same fp32 values: every int8 value and every scale bit-equal to JAX's,
    the same leaves quantized, the others kept fp32 as JAX keeps them."""
    tr = port_int8_from_fp32(ref.cfg, fp32_states)
    frozen = ref.state.frozen_params
    want = {"model": flat_to_state_dict(frozen["model"]),
            "vae": flax_to_state_dict(frozen["vae"]),
            "clip": flax_to_state_dict(frozen["clip"])}
    n_q = 0
    for name, w in want.items():
        got = getattr(tr, name).state_dict()
        for k, t in w.items():
            assert got[k].dtype == t.dtype, k
            if t.dtype == torch.int8:
                n_q += 1
                assert torch.equal(got[k], t), k
                assert torch.equal(got[k + "_scale"], want[name][k + "_scale"]), k
            elif name != "model" or k not in tr.train_params:
                assert torch.equal(got[k], t), k
        extra = {k for k in got if k not in w and not (name == "model" and k in tr.train_params)}
        assert not extra, extra
    assert n_q > 20
    assert quant.has_quantized(tr.model) and quant.has_quantized(tr.vae)
    assert all(p.requires_grad for p in tr.train_params.values())
    assert not any(p.requires_grad for m in (tr.model, tr.vae, tr.clip)
                   for p in m.parameters() if p.dtype == torch.int8)


def test_quantize_tensor_layouts_match_jax():
    """A Dense, a Conv and an embedding-layout leaf, channels by the
    converter's rules: the port reduces over the dims JAX reduces over in
    its own layout."""
    rs = np.random.RandomState(0)
    for shape, path in (((96, 64), ("a", "kernel")), ((3, 3, 16, 32), ("b", "kernel")),
                        ((300, 16), ("e", "embedding")), ((77, 64), ("position_embedding",))):
        w = (rs.randn(*shape) * 0.05).astype(np.float32)
        w[..., 0] = 0.0  # a channel (or slice) of zeros takes the 1e-8 floor
        jq = quantize_tree({"w": w})["w"]
        from magicdance_tpu_torch.convert.from_jax import convert_leaf

        _, t = convert_leaf(path, w)
        keep = 0 if path[-1] == "kernel" else t.dim() - 1
        q, scale = quant.quantize(t, keep)
        assert torch.equal(q, convert_leaf(path, np.asarray(jq.q), np.int8)[1]), path
        assert torch.equal(scale, convert_leaf(path, np.asarray(jq.scale))[1]), path
        deq = quant.dequantize(q, scale)
        from magicdance_tpu.train.quant import dequantize_tree

        jd = np.asarray(dequantize_tree({"w": jq})["w"].astype(np.float32))
        assert torch.equal(deq.float(), convert_leaf(path, jd)[1]), path


def test_load_train_state_carries_jax_int8_leaves(ref):
    tr = port_trainer(ref)
    flat = ref.state.frozen_params["model"]
    n = 0
    got = tr.model.state_dict()
    for path, leaf in flat.items():
        if isinstance(leaf, QuantizedLeaf):
            key = ".".join(path[:-1]) + ".weight"
            n += 1
            q = np.asarray(leaf.q)
            want_q = q.T if q.ndim == 2 else q.transpose(3, 2, 0, 1)
            assert got[key].dtype == torch.int8
            np.testing.assert_array_equal(got[key].numpy(), want_q, err_msg=key)
            s = np.asarray(leaf.scale)
            want_s = s.T if s.ndim == 2 else s.transpose(3, 2, 0, 1)
            np.testing.assert_array_equal(got[key + "_scale"].numpy(), want_s, err_msg=key)
    assert n > 10


def test_int8_trainer_matches_jax_int8_step(ref):
    jc = ref.cfg
    tr = port_trainer(ref)
    batch, rng = make_train_batch(80), jax.random.PRNGKey(81)
    (want_loss, _), want_g = ref.loss_and_grads(batch, rng)
    loss, _, grads = tr.loss_and_grads(port_batch(batch), jax_draws(jc, rng))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert_tree_close(grads, want_g)
    before = {k: p.detach().clone() for k, p in tr.train_params.items()}
    frozen_before = {k: t.clone() for k, t in tr.model.state_dict().items()
                     if k not in tr.train_params}
    for i in range(2):
        batch, rng = make_train_batch(82 + i), jax.random.PRNGKey(90 + i)
        metrics = tr.train_step(port_batch(batch), jax_draws(jc, rng))
        np.testing.assert_allclose(float(metrics["loss"]), ref.step(batch, rng), rtol=1e-5)
    want = to_port(ref.state.train_params)
    for k, p in tr.train_params.items():
        np.testing.assert_allclose((p.detach() - before[k]).numpy(),
                                   (want[k] - before[k]).numpy(), atol=0.02 * LR, err_msg=k)
    after = tr.model.state_dict()
    assert all(torch.equal(after[k], t) for k, t in frozen_before.items())


def _round_small_frozen_to_bf16(tr):
    """The frozen leaves int8 leaves fp32: give them bf16 values, so a bf16
    trainer stores the very same numbers."""
    with torch.no_grad():
        for m in (tr.model, tr.vae, tr.clip):
            for k, p in m.named_parameters():
                if p.dtype == torch.float32 and not p.requires_grad:
                    p.copy_(p.bfloat16().float())


def test_int8_equals_bf16_frozen_of_the_dequantized_values(ref, fp32_states):
    """What the card's phase 26a checks at full width: an int8 trainer and a
    bf16-frozen trainer holding its dequantized values compute the same
    losses, gradients and updates, bit for bit."""
    q8 = port_int8_from_fp32(ref.cfg, fp32_states)
    _round_small_frozen_to_bf16(q8)
    bf_cfg = port_train_cfg(dataclasses.replace(ref.cfg, optim=dataclasses.replace(
        ref.cfg.optim, frozen_dtype="bfloat16")))
    bf = Trainer(bf_cfg, device="cpu")
    bf.load_state_dicts(*(quant.dequantize_state_dict(getattr(q8, n).state_dict())
                          for n in ("model", "vae", "clip")))
    assert not quant.has_quantized(bf.model)
    assert quant.storage_bytes((q8.model, q8.vae, q8.clip), q8.train_params) < \
        quant.storage_bytes((bf.model, bf.vae, bf.clip), bf.train_params)
    for i in range(2):
        batch, rng = make_train_batch(100 + i), jax.random.PRNGKey(110 + i)
        draws = jax_draws(ref.cfg, rng)
        m8 = q8.train_step(port_batch(batch), draws)
        mb = bf.train_step(port_batch(batch), draws)
        assert float(m8["loss"]) == float(mb["loss"])
        assert float(m8["grad_norm"]) == float(mb["grad_norm"])
    for k, p in q8.train_params.items():
        assert torch.equal(p, bf.train_params[k]), k


def test_int8_checkpoint_round_trip_and_preview_state(ref, tmp_path):
    """Checkpoints hold q and scale (as JAX's TrainState does); a new int8
    trainer restores them and continues identically; the training CLI's
    preview takes the dequantized (bf16) values into a pipeline."""
    from magicdance_tpu_torch.pipeline import MagicPosePipeline
    from magicdance_tpu_torch.train.checkpoint import CheckpointManager

    a = port_trainer(ref)
    batch, rng = make_train_batch(120), jax.random.PRNGKey(121)
    a.train_step(port_batch(batch), jax_draws(ref.cfg, rng))
    sd = a.state_dict()
    assert sd["model"]["unet.conv_out.weight"].dtype == torch.int8 or any(
        t.dtype == torch.int8 for t in sd["model"].values())
    CheckpointManager(str(tmp_path)).save(a.step, sd)
    b = Trainer(port_train_cfg(ref.cfg), device="cpu")
    b.init_random(seed=5, scale=0.1)
    b.load_state_dict(CheckpointManager(str(tmp_path)).restore())
    for name in ("model", "vae", "clip"):
        got, want = getattr(b, name).state_dict(), getattr(a, name).state_dict()
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    batch, rng = make_train_batch(122), jax.random.PRNGKey(123)
    d = jax_draws(ref.cfg, rng)
    assert float(a.train_step(port_batch(batch), d)["loss"]) == \
        float(b.train_step(port_batch(batch), d)["loss"])
    pipe = MagicPosePipeline(port_train_cfg(ref.cfg).model, device="cpu")
    for name in ("model", "vae", "clip"):
        state = quant.dequantize_state_dict(getattr(a, name).state_dict())
        assert not quant.has_quantized(state)
        getattr(pipe, name).load_state_dict(state)
    w = a.model.unet.conv_in
    if quant.is_quantized(w, "weight"):
        assert torch.equal(pipe.model.unet.conv_in.weight,
                           quant.dequantize(w.weight, w.weight_scale).float())
