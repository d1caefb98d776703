"""The port's distribution layer in one process: the ZeRO-1 and
tensor-parallel specs against the JAX package's (`parallel/mesh.py`) leaf
for leaf, the column / row split of the attention and GEGLU layers worked
out by hand (two ranks' shares summed equal the whole layer), the rank
helpers without a group, the loader's rows and default device, and the
trainer's rows of the global draws. The multi-process paths are in
tests/test_torch_distributed*.py and test_torch_sharded_*.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from magicdance_tpu.config import UNetConfig as JUNetConfig
from magicdance_tpu.models.unet import UNet as JUNet
from magicdance_tpu.parallel.mesh import _zero1_spec, make_mesh, tensor_parallel_shardings
from magicdance_tpu.train.trainer import Trainer as JTrainer
from magicdance_tpu_torch.convert.from_jax import flax_key
from magicdance_tpu_torch.data.loader import PrefetchLoader
from magicdance_tpu_torch.models.layers import CrossAttention, GEGLUFeedForward, Linear
from magicdance_tpu_torch.models.unet import UNet
from magicdance_tpu_torch.parallel import mesh as M
from magicdance_tpu_torch.parallel import multihost as H
from magicdance_tpu_torch.train.trainer import Draws, Trainer
from torch_port_util import (
    TINY_UNET,
    jax_params,
    jax_train_cfg,
    port_cfg,
    port_train_cfg,
)
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)


def port_axis(flax_axis, path, ndim):
    """The port's axis of the Flax kernel axis at `path` (identity for other
    leaves)."""
    if flax_axis is None or path[-1] != "kernel" or ndim not in M._TO_FLAX:
        return flax_axis
    return M._TO_FLAX[ndim].index(flax_axis)


def data_axis(spec, name="data"):
    return next((i for i, a in enumerate(spec) if a == name), None)


@pytest.fixture(scope="module")
def stage2():
    jc = jax_train_cfg()
    (m, v, c), (mp, vp, cp) = jax_params(jc)
    state = JTrainer(jc, m, v, c).create_state(mp, vp, cp)
    return jc, state, Trainer(port_train_cfg(jc), device="cpu")


@pytest.mark.parametrize("n", [2, 4, 8])
def test_zero1_specs_match_jax_for_every_optimizer_leaf(stage2, n):
    jc, state, tr = stage2
    opt_state = JTrainer(jc, None, None, None).tx.init(state.train_params)
    ours = M.zero1_sharding(tr.model, list(tr.train_params), n)
    seen = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        spec = _zero1_spec(tuple(leaf.shape), n)
        keys = [p.key for p in path if isinstance(p, jax.tree_util.DictKey)]
        if not keys:  # the step counters: scalars, replicated
            assert leaf.shape == () and spec == jax.sharding.PartitionSpec()
            continue
        flax_path = keys[-1]
        assert port_axis(data_axis(spec), flax_path, leaf.ndim) == ours[flax_key(flax_path)], \
            flax_path
        seen += 1
    assert seen == 2 * len(ours)  # mu and nu of every trainable leaf
    assert any(a is not None for a in ours.values())


def test_zero1_spec_rule():
    assert M.zero1_spec((), 2) is None
    assert M.zero1_spec((3,), 2) is None  # small, indivisible: whole
    assert M.zero1_spec((4, 6), 2) == 1  # the largest divisible axis
    assert M.zero1_spec((6, 6), 2) == 0  # ties go to the first
    assert M.zero1_spec((7, 4), 4) == 1
    # a Linear weight (out, in) = (8, 8): the Flax (in, out) kernel's tie-break
    assert M.kernel_zero1_axis((8, 8), 2) == 1
    assert M.kernel_zero1_axis((320, 4, 3, 3), 2) == 0


@pytest.fixture(scope="module")
def tiny_unet():
    cfg = JUNetConfig(**TINY_UNET)
    shapes = jax.eval_shape(lambda: JUNet(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 5, 16))))["params"]
    return cfg, shapes, UNet(port_cfg(cfg))


@pytest.mark.parametrize("n", [2, 4])
def test_tp_specs_match_jax_leaf_for_leaf(tiny_unet, n):
    cfg, shapes, net = tiny_unet
    jmesh = make_mesh(("data", "model"), shape=(8 // n, n))
    flat = jax.tree_util.tree_flatten_with_path(tensor_parallel_shardings(shapes, jmesh))[0]
    sd = net.state_dict()
    kinds = set()
    for path, sh in flat:
        path = tuple(p.key for p in path)
        key = flax_key(path)
        spec = tuple(sh.spec)
        want = port_axis(data_axis(spec, "model"), path, len(sd[key].shape))
        assert M.tp_spec(tuple(key.split(".")), tuple(sd[key].shape), n) == want, key
        if want is not None:
            kinds.add((path[-2], path[-1], want))
            assert "conv" not in path[-2]  # convolutions stay replicated
    assert len(flat) == len(sd)
    assert {("to_q", "kernel", 0), ("to_out", "kernel", 1), ("proj_in", "kernel", 0),
            ("proj_out", "kernel", 1), ("proj_in", "bias", 0)} <= kinds


def test_column_row_split_of_attention_sums_to_the_layer():
    """Two ranks' shares of a CrossAttention: to_q/k/v rows (heads) and
    to_out columns split in halves; each share attends over its own heads
    (read from the width) and the partial outputs sum to the whole layer."""
    torch.manual_seed(0)
    attn = CrossAttention(32, 16, num_heads=4, head_dim=8)
    x, ctx = torch.randn(2, 5, 32), torch.randn(2, 7, 16)
    with torch.no_grad():
        want = attn(x, ctx)
        total = attn.to_out.bias.clone()
        for r in range(2):
            share = CrossAttention(32, 16, num_heads=4, head_dim=8)  # 4 heads: the config's
            rows = slice(16 * r, 16 * (r + 1))
            for name in ("to_q", "to_k", "to_v"):
                full = getattr(attn, name)
                setattr(share, name, Linear(full.in_features, 16, bias=False))
                getattr(share, name).weight.copy_(full.weight[rows])
            share.to_out = Linear(16, 32, bias=False)
            share.to_out.weight.copy_(attn.to_out.weight[:, rows])
            total = total + share(x, ctx)
    torch.testing.assert_close(total, want, atol=1e-5, rtol=1e-5)


def test_geglu_rows_paired_for_the_column_split():
    """After `_pair_geglu_rows`, rank r's block of proj_in's rows holds its
    [value | gate] features: each share's GEGLU over its proj_out columns,
    summed, is the whole feed-forward."""
    torch.manual_seed(1)
    ff = GEGLUFeedForward(8)  # inner 32, proj_in 8 -> 64
    x = torch.randn(3, 8)
    with torch.no_grad():
        want = ff(x)
        M._pair_geglu_rows(ff.proj_in, 2)
        total = ff.proj_out.bias.clone()
        for r in range(2):
            rows = slice(32 * r, 32 * (r + 1))
            local = F.linear(x, ff.proj_in.weight[rows], ff.proj_in.bias[rows])
            h, gate = local.chunk(2, dim=-1)
            cols = slice(16 * r, 16 * (r + 1))
            total = total + F.linear(h * F.gelu(gate, approximate="tanh"),
                                     ff.proj_out.weight[:, cols])
    torch.testing.assert_close(total, want, atol=1e-5, rtol=1e-5)


def test_rank_helpers_without_a_group(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    H.initialize_distributed()  # a single process: nothing to join
    assert not torch.distributed.is_initialized()
    assert H.is_primary()
    H.sync_global_devices("no-op")
    assert H.local_device() == (torch.device("cuda", torch.cuda.current_device())
                                if torch.cuda.is_available() else torch.device("cpu"))
    with pytest.raises(RuntimeError, match="initialized process group"):
        M.make_mesh(("data",))
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="rank"):
        H.initialize_distributed()
    assert not torch.distributed.is_initialized()


def fake_axis(rank: int, size: int) -> M.MeshAxis:
    """A MeshAxis that places this process at `rank` of `size` without a
    group (its collectives are the identity): enough to test rows."""
    axis = M.MeshAxis.single()
    axis.rank, axis.size = rank, size
    return axis


def test_rows_are_tensor_split_shares():
    for n in range(0, 11):
        for size in (1, 2, 3, 4):
            shares = torch.tensor_split(torch.arange(n), size)
            for r in range(size):
                start, stop = fake_axis(r, size).rows(n)
                assert list(range(start, stop)) == shares[r].tolist(), (n, size, r)
    single = M.MeshAxis.single()
    t = torch.arange(6.0)
    assert single.gather_rows(t, 6) is t and single.all_reduce(t) is t
    assert single.all_gather(t) == [t] and single.broadcast(t) is t


def test_loader_default_device_is_the_card():
    def factory(worker):
        def gen():
            while True:
                yield {"x": np.zeros((2, 4), np.float32)}
        return gen()

    if torch.cuda.is_available():  # pragma: no cover - a GPU machine
        with PrefetchLoader(factory, workers=1) as loader:
            assert loader.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            PrefetchLoader(factory, workers=1)


def test_loader_keeps_its_rows_in_a_fixed_order():
    """Two producers alternate (worker 0, 1, 0, ...) and a rank keeps its
    rows of each global batch; a batch that does not split raises; a finite
    stream ends."""
    def factory(worker):
        return iter([{"x": np.full((4, 2), 10 * i + worker, np.float32),
                      "ids": np.arange(4)} for i in range(3)])

    with PrefetchLoader(factory, workers=2, device="cpu", mesh=fake_axis(1, 2)) as loader:
        got = list(loader)
    assert [float(b["x"][0, 0]) for b in got] == [0, 1, 10, 11, 20, 21]
    assert all(b["ids"].tolist() == [2, 3] and b["x"].shape == (2, 2) for b in got)
    with PrefetchLoader(factory, workers=1, device="cpu", mesh=fake_axis(0, 3)) as loader:
        with pytest.raises(RuntimeError, match="does not split"):
            next(loader)


def test_trainer_keeps_its_rows_of_the_global_draws():
    jc = jax_train_cfg()
    tr = Trainer(port_train_cfg(jc), device="cpu")
    tr.data = fake_axis(1, 2)
    batch = {"image": torch.zeros(2, 16, 16, 3), "reference": torch.zeros(2, 16, 16, 3)}
    d = tr.draw(batch)
    assert d.t.shape == (4,) and d.noise.shape == (4, 8, 8, 4)
    assert d.vae_reference.shape == (4, 8, 8, 4)
    mine = tr.local_draws(d, batch)
    for name in ("t", "noise", "vae_image", "vae_reference"):
        assert torch.equal(getattr(mine, name), getattr(d, name)[2:4]), name
    with pytest.raises(ValueError, match="global batch"):
        tr.local_draws(mine, batch)
    # a temporal batch: one clip a rank, its frames' rows and its reference
    clips = Draws(t=torch.arange(8), noise=torch.randn(8, 1), vae_image=torch.randn(8, 1),
                  vae_reference=torch.randn(2, 1))
    got = tr.local_draws(clips, {"image": torch.zeros(4, 1), "reference": torch.zeros(1, 1)})
    assert got.t.tolist() == [4, 5, 6, 7] and torch.equal(got.vae_reference,
                                                           clips.vae_reference[1:])


def test_trainer_mesh_axes():
    """("data", "model") builds (data parallel, as JAX's trainer); a mesh
    without 'data' has no axis to split the batch over."""
    cfg = port_train_cfg(jax_train_cfg())
    tr = Trainer(dataclasses.replace(cfg, mesh_axes=("data", "model")), device="cpu")
    assert tr.mesh is None and tr.data.size == 1
    with pytest.raises(ValueError, match="'data'"):
        Trainer(dataclasses.replace(cfg, mesh_axes=("model",)), device="cpu")
