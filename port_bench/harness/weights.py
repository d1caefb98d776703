"""Seeded weights and the plain reference's networks.

`reference_networks`, `layout`, `seeded_states` and `reference_on` take the
configuration file (`{"model": ..., ...}`), whose reference family
(`harness.spec.reference_family`) builds the networks.

Every leaf of the three networks is drawn from N(0, 0.02^2) (the output and
zero convolutions too, so every branch shows in the result), on the device,
in bf16 (the denoiser's serving type; the VAE and CLIP hold these values in
fp32), one `torch.randn` per network from a generator of its own. The
layout is the reference's parameter order, and the names are the program's
state-dict keys, so both sides get the same numbers.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path

import torch

from port_bench.harness.spec import reference_family
from port_bench.reference.model import Numerics

NETWORKS = ("model", "vae", "clip")
SCALE = 0.02


def sub_seed(seed: int, stream: int) -> int:
    """A generator seed of its own for each stream of one run's seed."""
    return (seed * 1_000_003 + stream * 7_919 + 17) % (1 << 63)


def reference_networks(config: dict, num: Numerics = Numerics()) -> dict:
    """The reference's networks on the meta device."""
    return reference_family(config).networks(config["model"], num)


def layout_key(config: dict) -> str:
    """The layout cache's key: the model configuration, and the reference
    family where the file names one."""
    keyed = [config["reference"], config["model"]] if "reference" in config else config["model"]
    return hashlib.sha256(json.dumps(keyed, sort_keys=True).encode()).hexdigest()[:16]


def layout(config: dict, cache_dir=None) -> dict:
    """{network: [(key, shape)]} in the reference's parameter order. Built
    on the meta device (whose first use imports PyTorch's meta kernels, some
    seconds); with `cache_dir` kept there as JSON, keyed by `layout_key`,
    so only a checkout's first run builds it."""
    path = None
    if cache_dir is not None:
        path = Path(cache_dir) / "layout" / f"{layout_key(config)}.json"
        if path.is_file():
            return {n: [(k, tuple(s)) for k, s in v]
                    for n, v in json.loads(path.read_text()).items()}
    nets = reference_networks(config)
    out = {n: [(k, tuple(p.shape)) for k, p in nets[n].named_parameters()] for n in NETWORKS}
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        tmp.write_text(json.dumps(out))
        tmp.replace(path)
    return out


@torch.no_grad()
def seeded_state(shapes, seed: int, stream: int, device) -> dict:
    """{key: bf16 tensor} views into one seeded draw for a whole network
    whose parameters are `shapes`, [(key, shape)]."""
    shapes = [(k, torch.Size(s)) for k, s in shapes]
    total = sum(s.numel() for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, stream))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.bfloat16)
    flat.mul_(SCALE)
    out, off = {}, 0
    for k, s in shapes:
        out[k] = flat[off:off + s.numel()].view(s)
        off += s.numel()
    return out


def seeded_states(config: dict, seed: int, device, times: dict | None = None,
                  cache_dir=None) -> dict:
    t0 = time.perf_counter()
    shapes = layout(config, cache_dir)
    t1 = time.perf_counter()
    out = {n: seeded_state(shapes[n], seed, i, device) for i, n in enumerate(NETWORKS)}
    if times is not None:
        times["layout_s"], times["draw_s"] = t1 - t0, time.perf_counter() - t1
    return out


@torch.no_grad()
def materialize(net: torch.nn.Module, state: dict, device) -> torch.nn.Module:
    """A meta-device reference network with the given weights, in fp32."""
    net.load_state_dict({k: v.float() for k, v in state.items()}, strict=True, assign=True)
    return net.to(device).eval()


def reference_on(config: dict, seed: int, device, num: Numerics = Numerics()) -> dict:
    """The reference's networks with the run's seeded weights, fp32."""
    nets = reference_networks(config, num)
    return {n: materialize(nets[n], seeded_state(
        [(k, p.shape) for k, p in nets[n].named_parameters()], seed, i, device), device)
        for i, n in enumerate(NETWORKS)}
