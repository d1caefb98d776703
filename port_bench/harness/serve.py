"""The serving cells: one client, a closed loop of requests.

Each request is one dancer's clip of `frames` pose maps with one reference
image, sampled at the exact recipe (DDIM, classifier-free guidance,
`controlnet_important`, one x_T shared by the frames) through the program's
entry `MagicPosePipeline.sample_frames`, images or (`video`) the overlap
windows. Request i's inputs come from a generator of its own seeded from
the run's seed, so a request can be made again for the check. The check
recomputes every frame of a checked request in the configuration's
reference family, or, where an image traffic gives `check_frames` = k, k
of its frames drawn from the seed: an image request's frames share only
the bank and x_T, so each frame's trajectory is exact on its own (a video
window mixes frames, so a video traffic may not give the key).
"""

from __future__ import annotations

import time

import torch

from port_bench.harness import weights as W
from port_bench.harness.check import rows_of
from port_bench.harness.spec import reference_family
from port_bench.harness.tracing import Spans, profile_segment
from port_bench.reference.model import Numerics

INPUT_STREAM = 1000
CHECK_FRAMES_STREAM = 3000


class ServeCell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.model_cfg = config, config["model"]
        self.family = reference_family(config)
        self.t = traffic
        self.seed, self.device = seed, torch.device(device)
        self.frames = traffic["frames"]
        self.size = self.model_cfg["latent_size"] * 8
        self.video = bool(traffic.get("video", False))
        self.check_frames = traffic.get("check_frames")
        if self.check_frames is not None:
            if self.video:
                raise ValueError("check_frames is for image traffic: a video window mixes "
                                 "frames, so a subset of them is not exact")
            if not 1 <= self.check_frames <= self.frames:
                raise ValueError(f"check_frames {self.check_frames} is not in 1..{self.frames}")
        self.records: list = []    # (seconds, frames) of each request of the window
        self.outputs: dict = {}    # request index -> (images, latents) on the host
        self._latents = None       # the latents the last request handed to its decode
        self.spans = Spans()
        self.setup_parts: dict = {}
        self.cache_dir = None      # where the weight layout is kept between runs

    # -- inputs ------------------------------------------------------------------
    def inputs(self, i: int):
        """(pose maps, reference, x_T, window offsets) of request i: uniform
        pose maps in [0, 1], a reference image in [-1, 1], one x_T for every
        frame, one cyclic window offset per step (video)."""
        gen = torch.Generator(device=self.device).manual_seed(
            W.sub_seed(self.seed, INPUT_STREAM + i))
        f, s, h = self.frames, self.size, self.model_cfg["latent_size"]
        pose = torch.rand(f, s, s, 3, generator=gen, device=self.device)
        ref = torch.rand(1, s, s, 3, generator=gen, device=self.device) * 2 - 1
        x_T = torch.randn(1, h, h, 4, generator=gen, device=self.device).expand(f, h, h, 4)
        cpu = torch.Generator().manual_seed(W.sub_seed(self.seed, INPUT_STREAM + i))
        offsets = torch.randint(0, f, (self.t["steps"],), generator=cpu).tolist()
        return pose, ref, x_T, offsets

    def scfg(self, steps: int):
        from magicdance_tpu_torch.config import SampleConfig

        return SampleConfig(steps=steps, cfg_scale=self.t["cfg_scale"],
                            window=self.t.get("window", 16), stride=self.t.get("stride", 12))

    # -- the program ---------------------------------------------------------------
    def setup(self):
        from magicdance_tpu_torch.config import ModelConfig, from_dict
        from magicdance_tpu_torch.pipeline import MagicPosePipeline

        t0 = time.perf_counter()
        self.pipe = MagicPosePipeline(from_dict(ModelConfig, self.model_cfg), device=self.device)
        self.sync()
        t1 = time.perf_counter()
        states = W.seeded_states(self.config, self.seed, self.device, self.setup_parts,
                                  self.cache_dir)
        self.sync()
        t2 = time.perf_counter()
        self.pipe.load_state_dicts(states)
        del states
        self.sync()
        self.setup_parts["build_s"] = t1 - t0
        self.setup_parts["weights_s"] = t2 - t1
        self.setup_parts["load_s"] = time.perf_counter() - t2
        t0 = time.perf_counter()
        self.request(-1, self.t["warmup_steps"])   # every shape of the window, once
        self.sync()
        self.setup_parts["warmup_s"] = time.perf_counter() - t0
        self.instrument()

    def instrument(self):
        """Spans around the passes and attention calls (on only in the
        profiled segment) and events around the VAE decode."""
        m, sp = self.pipe.model, self.spans
        sp.name_pass(m.appearance_unet, "pb.bank_write")
        sp.name_pass(m.pose_control, "pb.controlnet")
        sp.name_pass(m.unet, lambda a, kw: "pb.unet.cond" if kw.get("bank") is not None
                     or kw.get("pose_residuals") is not None else "pb.unet.uncond")
        for mod in m.modules():
            if type(mod).__name__ == "CrossAttention":
                sp.name_attention(mod)
        decode = self.pipe.decode_latents

        def keep(latents):
            self._latents = latents.detach().clone()
            return decode(latents)

        self.pipe.decode_latents = keep
        sp.wrap(self.pipe, "decode_latents", "pb.vae_decode",
                frames_of=lambda args, out: out.shape[0])
        sp.wrap(self.pipe, "encode_reference", "pb.vae_encode")
        sp.wrap(self.pipe, "encode_empty", "pb.clip")

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def request(self, i: int, steps: int):
        pose, ref, x_T, offsets = self.inputs(i)
        return self.pipe.sample_frames(pose, ref, self.scfg(steps), x_T=x_T, video=self.video,
                                       window_offsets=offsets[:steps] if self.video else None)

    def window(self, seconds: float, timing: bool):
        """Requests back to back until `seconds` have passed; the one in
        flight then finishes. Returns the window's length."""
        self.spans.timing = timing
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            ts = time.perf_counter()
            out = self.request(i, self.t["steps"])
            # waits for the request to finish
            self.outputs[i] = (out.float().cpu(), self._latents.float().cpu())
            self.records.append((time.perf_counter() - ts, out.shape[0]))
            i += 1
        self.spans.timing = False
        return time.perf_counter() - t0

    def segment(self):
        """One request cut to `trace_steps` DDIM steps, with its decode,
        under the profiler."""
        return profile_segment(lambda: self.request(-2, self.t["trace_steps"]), self.spans)

    def release(self):
        self.spans.remove()
        del self.pipe

    # -- the check -------------------------------------------------------------
    def check_sample(self, n_done: int) -> list:
        """The requests the check compares: `check_requests` of the finished
        ones, drawn from the seed."""
        gen = torch.Generator().manual_seed(W.sub_seed(self.seed, 7))
        k = min(self.t["check_requests"], n_done)
        return sorted(torch.randperm(n_done, generator=gen)[:k].tolist())

    def check_rows(self, i: int):
        """The frames of request i that the check recomputes: None for all,
        or `check_frames` of them drawn from the seed, in order."""
        if self.check_frames is None:
            return None
        gen = torch.Generator().manual_seed(W.sub_seed(self.seed, CHECK_FRAMES_STREAM + i))
        return sorted(torch.randperm(self.frames, generator=gen)[:self.check_frames].tolist())

    def reference(self, i: int, num: Numerics, latents=None):
        """(latents, images, rows): the plain reference's latents for the
        checked frames `rows` of request i (None: all of them), with the
        weights made again from the seed, in the precision `num` gives; and
        its decode of those rows of `latents` (the program's) when given."""
        nets = W.reference_on(self.config, self.seed, self.device, num)
        pose, ref, x_T, offsets = self.inputs(i)
        rows = self.check_rows(i)
        pose, x_T = rows_of(pose, rows), rows_of(x_T, rows)
        lat = self.family.sample(nets, self.model_cfg, pose, ref, x_T, self.t["steps"],
                                 self.t["cfg_scale"], num, video=self.video, offsets=offsets,
                                 window=self.t.get("window", 16),
                                 stride=self.t.get("stride", 12))
        images = None
        if latents is not None:
            images = self.family.decode(nets["vae"], rows_of(latents, rows).to(self.device),
                                        self.model_cfg, num).float().cpu()
        return lat.float().cpu(), images, rows

    def flops_per_request(self) -> float:
        """Model FLOPs of one request, counted on the reference (meta)."""
        from port_bench.harness.yardstick import count_flops

        nets = W.reference_networks(self.config)
        f, s, h = self.frames, self.size, self.model_cfg["latent_size"]
        meta = torch.device("meta")
        pose = torch.empty(f, s, s, 3, device=meta)
        ref = torch.empty(1, s, s, 3, device=meta)
        x_T = torch.empty(f, h, h, 4, device=meta)
        steps = self.t["steps"]

        def one(k):
            lat = self.family.sample(nets, self.model_cfg, pose, ref, x_T, k,
                                     self.t["cfg_scale"], Numerics(), video=self.video,
                                     offsets=[0] * k, window=self.t.get("window", 16),
                                     stride=self.t.get("stride", 12))
            self.family.decode(nets["vae"], lat, self.model_cfg, Numerics())

        one_step = count_flops(one, 1)
        two_steps = count_flops(one, 2)
        return one_step + (steps - 1) * (two_steps - one_step)
