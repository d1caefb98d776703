"""ZeRO-1 and the tensor-parallel plan with int8 frozen leaves
(`frozen_dtype="int8"`, `models/quant.py`), on two gloo ranks on the CPU.

ZeRO-1 slices only the trainable state, so the int8 leaves stay whole on
every rank: two ranks at B = 1 compute the global batch one process
computes at B = 2 with the same draws (loss 1e-5 relative, parameters 2% of
the learning rate, as tests/test_torch_distributed.py). The tensor-parallel
plan shards an int8 weight as a float one, its per-output-channel scale with
the column split and whole under the row split: the sharded UNet gives the
unsharded output.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

from magicdance_tpu import config as J
from magicdance_tpu_torch import config as C
from magicdance_tpu_torch.models import quant
from magicdance_tpu_torch.train.quant import should_quantize
from magicdance_tpu_torch.train.trainer import Trainer
from torch_port_util import Ranks, jax_train_cfg, make_train_batch, port_batch, port_train_cfg
from torch_port_util import torch_single_thread  # noqa: F401  (autouse fixture)

LR = 1e-3


def test_zero1_two_ranks_with_int8_frozen_leaves(tmp_path):
    """ZeRO-1 over two gloo ranks with int8 frozen leaves: the global batch's
    loss and parameters equal one process's."""
    cfg = port_train_cfg(jax_train_cfg(optim=J.OptimConfig(
        learning_rate=LR, warmup_steps=1, adam_eps=1e-4, frozen_dtype="int8")))
    one = Trainer(cfg, device="cpu")
    one.init_random(seed=3, scale=0.1)
    assert quant.has_quantized(one.model)
    state = one.state_dict()
    batches = [make_train_batch(130 + i) for i in range(2)]
    draws = [one.draw(port_batch(b)) for b in batches]
    job = dict(kind="train", name="int8", state=state, steps=2, batches=batches, draws=draws,
               cfg=C.to_dict(dataclasses.replace(cfg, batch_size_per_device=1)))
    ranks = Ranks(tmp_path / "ranks", [job])
    want = [float(one.train_step(port_batch(b), d)["loss"]) for b, d in zip(batches, draws)]
    out = ranks.join()
    for r in range(2):
        got = out[r]["int8"]
        np.testing.assert_allclose([m["loss"] for m in got["metrics"]], want, rtol=1e-5)
        for k, p in one.train_params.items():
            np.testing.assert_allclose(got["params"][k].numpy(), p.detach().numpy(),
                                       atol=0.02 * LR, err_msg=k)


TP_WORKER = textwrap.dedent('''
    import os, sys
    rank, world, work, root = int(sys.argv[1]), 2, sys.argv[2], sys.argv[3]
    sys.path.insert(0, root)
    import torch
    torch.set_num_threads(1)
    from magicdance_tpu_torch import config as C
    from magicdance_tpu_torch.models.unet import UNet
    from magicdance_tpu_torch.parallel.mesh import make_mesh, tensor_parallel_plan
    from magicdance_tpu_torch.parallel.multihost import initialize_distributed
    from magicdance_tpu_torch.models import quant
    job = torch.load(os.path.join(work, "job.pt"), weights_only=False)
    initialize_distributed(backend="gloo", init_method="file://" + os.path.join(work, "rdzv"),
                           world_size=world, rank=rank, timeout_s=60)
    net = UNet(C.from_dict(C.UNetConfig, job["cfg"])).eval().requires_grad_(False)
    quant.match_(net, job["weights"])
    net.load_state_dict(job["weights"])
    plan = tensor_parallel_plan(net, make_mesh(("data", "model"), (1, world)))
    with torch.no_grad():
        out = net(job["x"], job["t"], job["ctx"])
    out = out[0] if isinstance(out, tuple) else out
    torch.save({"out": out, "plan": sorted(plan)}, os.path.join(work, f"out_{rank}.pt"))
    torch.distributed.destroy_process_group()
    print("TP_OK", rank, flush=True)
''')


def test_tensor_parallel_plan_with_int8_leaves(tmp_path):
    """The tensor-parallel plan on a UNet whose attention and GEGLU weights
    are int8 (two gloo ranks): the same output as the unsharded int8 UNet."""
    from magicdance_tpu_torch.convert.from_jax import flax_last_dim
    from magicdance_tpu_torch.models.unet import UNet

    ucfg = C.UNetConfig(model_channels=64, channel_mult=(1,), num_res_blocks=1,
                        attention_resolutions=(1,), num_heads=2, context_dim=64)
    torch.manual_seed(0)
    net = UNet(ucfg).eval().requires_grad_(False)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn_like(p) * 0.1)
    n = 0
    for sub in net.modules():
        if isinstance(sub, torch.nn.Linear) and should_quantize(sub.weight):
            quant.quantize_param_(sub, "weight", flax_last_dim(sub, "weight", 2))
            n += 1
    assert n >= 6
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 8, 8, 4, generator=g)
    t = torch.tensor([3, 500])
    ctx = torch.randn(2, 5, 64, generator=g)
    with torch.no_grad():
        want = net(x, t, ctx)
    want = want[0] if isinstance(want, tuple) else want
    work = tmp_path / "tp"
    work.mkdir()
    torch.save(dict(cfg=C.to_dict(ucfg), weights=net.state_dict(), x=x, t=t, ctx=ctx),
               work / "job.pt")
    (work / "worker.py").write_text(TP_WORKER)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, str(work / "worker.py"), str(r), str(work), root],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"TP_OK {r}" in o, o[-3000:]
    for r in range(2):
        got = torch.load(work / f"out_{r}.pt", weights_only=False)
        assert any(name.endswith("ff.proj_in") for name in got["plan"])
        np.testing.assert_allclose(got["out"].numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
