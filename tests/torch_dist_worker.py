"""Worker process of the port's multi-process tests -- NOT a pytest module.

Each of `world` processes joins a gloo group through a `file://` store
under the work directory (no port to race for), runs the jobs the parent
test wrote to `{workdir}/jobs.pt` in order, and writes what it observed to
`{workdir}/out_{rank}.pt`. It imports torch and the PyTorch port only.

Jobs ({"kind": ..., "name": ..., ...}):
  train  build a `Trainer` from a port TrainConfig dict and a state dict (or
         a checkpoint to resume), run `steps` steps on this rank's rows of
         the given global batches (with the given global draws, or the
         trainer's own), optionally save a checkpoint; report the metrics of
         every step, the full trainable parameters and EMA, and the
         optimizer-state bytes this rank holds.
  image  `MagicPosePipeline.sample_frames(mesh=)` on the images path.
  video  `ddim_sample_video(window_sharding=)` with given window offsets.
  tp     the UNet forward under `tensor_parallel_plan` on a (1, world)
         ("data", "model") mesh.

Usage: python tests/torch_dist_worker.py <rank> <world> <workdir>
"""

import os
import sys

rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

torch.set_num_threads(1)

from magicdance_tpu_torch import config as C  # noqa: E402
from magicdance_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from magicdance_tpu_torch.parallel.multihost import (  # noqa: E402
    initialize_distributed,
    is_primary,
    sync_global_devices,
)


def rows_of(batch: dict, mesh) -> dict:
    from magicdance_tpu_torch.parallel.mesh import batch_sharding

    axis = batch_sharding(mesh)
    out = {}
    for k, v in batch.items():
        start, stop = axis.rows(v.shape[0])
        out[k] = torch.as_tensor(v[start:stop])
    return out


def train(job: dict) -> dict:
    from magicdance_tpu_torch.train.checkpoint import CheckpointManager
    from magicdance_tpu_torch.train.trainer import Trainer

    cfg = C.from_dict(C.TrainConfig, job["cfg"])
    tr = Trainer(cfg, device="cpu")
    if job.get("resume"):
        tr.load_state_dict(CheckpointManager(job["resume"]).restore())
    elif job.get("state") is not None:
        tr.load_state_dict(job["state"])
    else:
        tr.init_random(seed=job.get("seed", 0), scale=0.1)
    metrics = []
    for i in range(job["steps"]):
        draws = job["draws"][i] if job.get("draws") else None
        m = tr.train_step(rows_of(job["batches"][i], tr.mesh), draws)
        metrics.append({k: float(v) for k, v in m.items()})
    state = tr.state_dict()  # a collective: every rank gathers
    if job.get("save"):
        CheckpointManager(job["save"]).save(tr.step, state)
    return {"metrics": metrics,
            "params": {k: p.detach().clone() for k, p in tr.train_params.items()},
            "ema": tr.full_ema(),
            "opt": state["opt"],
            "opt_bytes": tr.opt.state_bytes(),
            "full_opt_bytes": sum(t.numel() * t.element_size()
                                  for part in ("mu", "nu") for t in state["opt"][part].values()),
            "mesh": dict(zip(tr.mesh.mesh_dim_names, tr.mesh.shape)),
            "step": tr.step}


def image(job: dict) -> dict:
    from magicdance_tpu_torch.pipeline import MagicPosePipeline

    pipe = MagicPosePipeline(C.from_dict(C.ModelConfig, job["cfg"]), device="cpu")
    pipe.load_state_dicts(job["weights"])
    mesh = make_mesh(("data",))
    out = pipe.sample_frames(job["pose"], job["ref"], C.from_dict(C.SampleConfig, job["scfg"]),
                             x_T=job["x_T"] if rank == 0 else torch.zeros_like(job["x_T"]),
                             decode=job.get("decode", False), mesh=mesh)
    return {"out": out}


def video(job: dict) -> dict:
    from magicdance_tpu_torch.models import MagicPoseModel
    from magicdance_tpu_torch.ops import schedules as S
    from magicdance_tpu_torch.sampling.overlap import ddim_sample_video

    cfg = C.from_dict(C.ModelConfig, job["cfg"])
    model = MagicPoseModel(cfg).eval().requires_grad_(False)
    model.load_state_dict(job["weights"])
    sched = S.make_schedule(cfg.diffusion)
    scfg = C.from_dict(C.SampleConfig, job["scfg"])
    out = ddim_sample_video(model, sched, S.make_ddim_schedule(sched, scfg.steps), scfg,
                            job["x_T"], job["ctx"], job["uctx"],
                            reference_latent=job["ref"], pose_hint=job["hint"],
                            window_offsets=job["offsets"],
                            window_sharding=make_mesh(("data",)))
    return {"out": out}


def tp(job: dict) -> dict:
    from magicdance_tpu_torch.models.unet import UNet
    from magicdance_tpu_torch.parallel.mesh import tensor_parallel_plan

    net = UNet(C.from_dict(C.UNetConfig, job["cfg"])).eval().requires_grad_(False)
    net.load_state_dict(job["weights"])
    mesh = make_mesh(("data", "model"), (1, world))
    plan = tensor_parallel_plan(net, mesh)
    local = {k: (v.to_local() if hasattr(v, "to_local") else v).shape
             for k, v in net.state_dict().items()}
    with torch.no_grad():
        out = net(job["x"], job["t"], job["ctx"])
    out = out[0] if isinstance(out, tuple) else out
    return {"out": out, "plan": sorted(plan), "local_shapes": local}


initialize_distributed(backend="gloo", init_method=f"file://{os.path.join(workdir, 'rdzv')}",
                       world_size=world, rank=rank, timeout_s=60)
assert is_primary() == (rank == 0)
jobs = torch.load(os.path.join(workdir, "jobs.pt"), weights_only=False)
results = {}
for job in jobs:
    results[job["name"]] = {"train": train, "image": image, "video": video,
                            "tp": tp}[job["kind"]](job)
    sync_global_devices(job["name"])
torch.save(results, os.path.join(workdir, f"out_{rank}.pt"))
torch.distributed.destroy_process_group()
print(f"TORCH_DIST_OK rank={rank}", flush=True)
