"""The training cells: `Trainer.train_step` back to back on fresh batches.

Set-up builds one trainer with the seeded weights and drives it through its
first `check_steps` steps on batches and draws made from the seed (every
row differs), keeping what the check compares: each step's loss, the norm of
each trainable leaf's first gradient as the optimizer got it (its first
moment after one step, over 1 - b1) and the norm of each leaf's change after
those steps. The same trainer then runs the window. Batch i: images,
references and pose maps uniform on the card, the empty prompt, and the
step's draws (timesteps, diffusion noise, VAE posterior noise), which the
benchmark hands to both the program and the reference.
"""

from __future__ import annotations

import time

import torch

from port_bench.harness import weights as W
from port_bench.harness.spec import reference_family
from port_bench.harness.tracing import Spans, profile_segment
from port_bench.reference.model import Numerics
from port_bench.reference.sample import empty_ids

BATCH_STREAM = 2000


def leaf_norms(tensors: dict) -> dict:
    keys = list(tensors)
    vals = torch.stack([tensors[k].float().norm() for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


class TrainCell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.model_cfg, self.train_cfg = config, config["model"], config["train"]
        self.family = reference_family(config)
        self.t = traffic
        self.seed, self.device = seed, torch.device(device)
        self.temporal = self.model_cfg["variant"] == "appearance_pose_temporal"
        self.frames = self.train_cfg["video_frames"] if self.temporal else 1
        self.batch_rows = self.train_cfg["batch_size_per_device"] * self.frames
        self.size = traffic.get("image_size", self.train_cfg["image_size"])
        self.records: list = []
        self.spans = Spans()
        self.setup_parts: dict = {}
        self.cache_dir = None      # where the weight layout is kept between runs
        self.readings: dict = {}

    # -- inputs ----------------------------------------------------------------
    def inputs(self, i: int, device=None):
        """(batch, draws) of step i, as plain dicts of tensors."""
        dev = device or self.device
        gen = torch.Generator(device=dev).manual_seed(W.sub_seed(self.seed, BATCH_STREAM + i))
        n, s, f = self.batch_rows, self.size, self.frames
        clips = n // f
        h = s // 8
        batch = {"image": torch.rand(n, s, s, 3, generator=gen, device=dev) * 2 - 1,
                 "reference": torch.rand(clips, s, s, 3, generator=gen, device=dev) * 2 - 1,
                 "pose": torch.rand(n, s, s, 3, generator=gen, device=dev),
                 "input_ids": empty_ids(n, self.model_cfg["clip"]["max_length"]).to(dev)}
        t = torch.randint(0, self.model_cfg["diffusion"]["timesteps"], (clips,), generator=gen,
                          device=dev).repeat_interleave(f)
        draws = {"t": t,
                 "noise": torch.randn(n, h, h, 4, generator=gen, device=dev),
                 "vae_image": torch.randn(n, h, h, 4, generator=gen, device=dev),
                 "vae_reference": torch.randn(clips, h, h, 4, generator=gen, device=dev)}
        return batch, draws

    def train_config(self):
        from magicdance_tpu_torch.config import TrainConfig, from_dict

        return from_dict(TrainConfig, {**self.train_cfg, "model": self.model_cfg})

    # -- the program -------------------------------------------------------------
    def setup(self):
        from magicdance_tpu_torch.train.trainer import Trainer

        t0 = time.perf_counter()
        self.tr = Trainer(self.train_config(), device=self.device)
        self.sync()
        t1 = time.perf_counter()
        self.setup_parts["build_s"] = t1 - t0
        st = W.seeded_states(self.config, self.seed, self.device, self.setup_parts,
                                self.cache_dir)
        self.sync()
        t2 = time.perf_counter()
        self.tr.load_state_dicts(st["model"], st["vae"], st["clip"])
        del st
        self.sync()
        self.setup_parts["weights_s"] = t2 - t1
        self.setup_parts["load_s"] = time.perf_counter() - t2
        t0 = time.perf_counter()
        losses = []
        for i in range(self.t["check_steps"]):   # also every shape of the window
            losses.append(self.step(i)["loss"])
            if i == 0:
                b1 = self.tr.cfg.optim.adam_b1
                self.readings["grad1"] = {k: v / (1 - b1)
                                          for k, v in leaf_norms(self.tr.opt.mu).items()}
        self.readings["loss"] = [float(v) for v in losses]
        self.readings["delta"] = self.change_norms()
        self.sync()
        self.setup_parts["first_steps_s"] = time.perf_counter() - t0
        self.instrument()

    @torch.no_grad()
    def change_norms(self) -> dict:
        """Each trainable leaf's distance from its seeded start."""
        shapes = W.layout(self.config, self.cache_dir)["model"]
        start = W.seeded_state(shapes, self.seed, 0, self.device)
        out = {k: (p.detach().float() - start[k].float()).norm()
               for k, p in self.tr.train_params.items()}
        return {k: float(v) for k, v in zip(out, torch.stack(list(out.values())).cpu())}

    def instrument(self):
        sp, m = self.spans, self.tr.model
        sp.name_pass(m.appearance_unet, "pb.bank_write")
        sp.name_pass(m.pose_control, "pb.controlnet")
        sp.name_pass(m.unet, "pb.unet")
        sp.wrap(self.tr, "encode", "pb.encode",
                frames_of=lambda args, out: args[0]["image"].shape[0]
                + args[0]["reference"].shape[0])
        sp.wrap(self.tr, "apply_update", "pb.optimizer")

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def step(self, i: int):
        from magicdance_tpu_torch.train.trainer import Draws

        batch, draws = self.inputs(i)
        return self.tr.train_step(batch, Draws(**draws))

    def window(self, seconds: float, timing: bool):
        """Steps back to back until `seconds` have passed, at most one step
        queued ahead of the card (the host waits for step i - 1 after it has
        enqueued step i). Returns the window's length."""
        self.spans.timing = timing
        i = self.t["check_steps"]
        t0 = time.perf_counter()
        prev = None
        while time.perf_counter() - t0 < seconds:
            self.step(i)
            done = torch.cuda.Event() if self.device.type == "cuda" else None
            if done is not None:
                done.record()
            if prev is not None:
                prev.synchronize()
            prev = done
            self.records.append((0.0, self.batch_rows))
            i += 1
        self.sync()
        self.spans.timing = False
        return time.perf_counter() - t0

    def segment(self):
        def two():
            for k in range(self.t["trace_steps"]):
                self.step(10_000 + k)

        return profile_segment(two, self.spans)

    def release(self):
        self.spans.remove()
        del self.tr

    # -- the check ----------------------------------------------------------------
    def reference(self, num: Numerics) -> dict:
        """The plain reference through the same first steps: losses, first
        clipped gradient norms per leaf, change norms per leaf."""
        nets = W.reference_on(self.config, self.seed, self.device, num)
        ref = self.family.ReferenceTrainer(nets["model"], nets["vae"], nets["clip"],
                                           self.model_cfg, self.train_cfg, num)
        start = {k: p.detach().clone() for k, p in ref.params.items()}
        losses, grad1 = [], None
        for i in range(self.t["check_steps"]):
            batch, draws = self.inputs(i)
            loss, grads = ref.loss_and_grads(batch, draws)
            norms = ref.update(grads)
            del grads
            losses.append(float(loss))
            if i == 0:
                grad1 = {k: float(v) for k, v in zip(norms, torch.stack(list(norms.values()))
                                                      .cpu())}
        delta = {k: float((p.detach() - start[k]).norm()) for k, p in ref.params.items()}
        return {"loss": losses, "grad1": grad1, "delta": delta}

    def flops_per_step(self) -> float:
        """Model FLOPs of one step (forward and backward, nothing
        recomputed), counted on the reference (meta)."""
        from port_bench.harness.yardstick import count_flops

        nets = W.reference_networks(self.config, Numerics())
        ref = self.family.ReferenceTrainer(nets["model"], nets["vae"], nets["clip"],
                                           self.model_cfg, self.train_cfg, Numerics())
        batch, draws = self.inputs(0, device=torch.device("cpu"))
        meta = {k: torch.empty_like(v, device="meta") if v.is_floating_point() else v.to("meta")
                for k, v in {**batch, **draws}.items()}
        b = {k: meta[k] for k in batch}
        d = {k: meta[k] for k in draws}
        return count_flops(ref.loss_and_grads, b, d)
