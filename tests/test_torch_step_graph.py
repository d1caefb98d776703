"""One DDIM step as one CUDA graph (`sampling.step_graph`).

On the CPU: the samplers' steps, which read t, the DDIM coefficients and
the window offset from the request's tables, give the bits of the same
steps with host scalars, eagerly and on the graph path (static input
buffers, the latents updated in place, the step run eagerly in place of the
replay), for the image and the video sampler (and SDXL's added vectors), at
DDIM-2 and DDIM-50; the dispatch declines, and `STEP_GRAPHS` counts, each
reason the path is not taken; the capture's increments of `LAUNCHES` and
`GN_SITES` are added at every replay; `release` drops the captured steps.

On the card (skipped without one): requests replayed from captured graphs
give the eager requests' bits, and those the host-scalar steps', on the
narrow SD1.5, video and SDXL models, a second request with new inputs (its
pose maps from the host) and a request with a new shape (a new capture)
included, and `LAUNCHES` counts what the eager requests launch.
This file imports neither jax nor the JAX package; on a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_step_graph.py
"""

import contextlib
import copy
import dataclasses
import json
import os
from collections import Counter

import pytest
import torch

from magicdance_tpu_torch import config as T
from magicdance_tpu_torch.models import layers
from magicdance_tpu_torch.ops import attention
from magicdance_tpu_torch.ops.kernels import LAUNCHES
from magicdance_tpu_torch.ops.schedules import make_ddim_schedule, make_schedule
from magicdance_tpu_torch.pipeline import MagicPosePipeline
from magicdance_tpu_torch.sampling import step_graph as SG
from magicdance_tpu_torch.sampling.ddim import ddim_sample, ddim_step
from magicdance_tpu_torch.sampling.overlap import ddim_sample_video, scatter_mean, window_starts

NARROW = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
              attention_resolutions=(1, 2), num_heads=2, context_dim=16)
SDXL_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "port_bench", "configs", "magicpose-sdxl.json")


@pytest.fixture(scope="module", autouse=True)
def torch_single_thread():
    """One intra-op thread: the narrow models gain nothing from more, and the
    other test processes share the machine. Restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def narrow_cfg(kind: str, latent: int, dtype: str = "float32") -> T.ModelConfig:
    """The narrow image ("sd15") or temporal ("video") model, or SDXL
    ("sdxl": the configuration file's model cut to channels 32 x [1, 2, 4],
    depth [1, 2, 3], 8-wide heads, two 2-layer towers)."""
    if kind == "sdxl":
        with open(SDXL_CONFIG) as f:
            m = copy.deepcopy(json.load(f)["model"])
        tiny = dict(model_channels=32, channel_mult=[1, 2, 4], transformer_depth=[1, 2, 3],
                    num_head_channels=8, context_dim=32, adm_in_channels=16 + 6 * 256)
        m["unet"].update(tiny)
        m["pose_control"].update(tiny)
        m["clip"].update(hidden_size=16, num_layers=2, num_heads=2)
        m["clip_g"].update(hidden_size=16, num_layers=2, num_heads=2, projection_dim=16)
        m["vae"].update(base_channels=32, channel_mult=[1, 1, 2, 2], num_res_blocks=1)
        m.update(latent_size=latent, dtype=dtype)
        return T.from_dict(T.ModelConfig, m)
    cfg = T.ModelConfig(unet=T.UNetConfig(**NARROW), pose_control=T.ControlNetConfig(**NARROW),
                        vae=T.VAEConfig(base_channels=32, channel_mult=(1, 1, 2, 2),
                                        num_res_blocks=1),
                        clip=T.CLIPTextConfig(hidden_size=16, num_layers=1, num_heads=2),
                        latent_size=latent, dtype=dtype)
    if kind == "video":
        cfg = dataclasses.replace(
            cfg, variant=T.ModelVariant.APPEARANCE_POSE_TEMPORAL,
            unet=T.UNetConfig(**NARROW, use_motion_modules=True, motion_num_heads=2))
    return cfg


def make_pipe(kind: str, latent: int, device: str, dtype: str = "float32"):
    pipe = MagicPosePipeline(narrow_cfg(kind, latent, dtype), device=device)
    pipe.init_params(seed=0, scale=0.1)
    return pipe


def request_inputs(pipe, kind: str, frames: int, latent: int, seed: int, steps: int) -> dict:
    """The sampler's keyword inputs of one request, drawn from `seed`."""
    dev = pipe.device
    g = torch.Generator(device=dev).manual_seed(seed)
    cfg = pipe.cfg
    ctx_dim = cfg.unet.context_dim
    kw = dict(x_T=torch.randn(1, latent, latent, 4, generator=g, device=dev)
              .expand(frames, -1, -1, -1).contiguous(),
              context=torch.randn(1, 77, ctx_dim, generator=g, device=dev),
              uncond_context=torch.randn(1, 77, ctx_dim, generator=g, device=dev),
              reference_latent=torch.randn(1, latent, latent, 4, generator=g, device=dev),
              pose_hint=torch.rand(frames, 8 * latent, 8 * latent, 3, generator=g, device=dev))
    if kind == "sdxl":
        adm = cfg.unet.adm_in_channels
        kw.update(y=torch.randn(1, adm, generator=g, device=dev),
                  uncond_y=torch.randn(1, adm, generator=g, device=dev))
    if kind == "video":
        kw["window_offsets"] = torch.randint(0, frames, (steps,), generator=g,
                                             device=dev).tolist()
    return kw


def sample(pipe, kind: str, steps: int, inputs: dict, **kw) -> torch.Tensor:
    ddim = make_ddim_schedule(pipe.sched, steps)
    scfg = T.SampleConfig(steps=steps, window=4, stride=3)
    x_T, ctx, uctx = inputs["x_T"], inputs["context"], inputs["uncond_context"]
    rest = {k: v for k, v in inputs.items() if k not in ("x_T", "context", "uncond_context")}
    fn = ddim_sample_video if kind == "video" else ddim_sample
    return fn(pipe.model, pipe.sched, ddim, scfg, x_T, ctx, uctx, **rest, **kw)


@torch.inference_mode()
def host_scalar_sample(pipe, kind: str, steps: int, inputs: dict) -> torch.Tensor:
    """The exact recipe's steps written out with host scalars: t from
    `torch.full` of the schedule's int, the window offset a Python int, the
    update `ddim_step` with the schedule's 0-dim host tensors (the samplers'
    arithmetic before their steps read device tables)."""
    model, ddim = pipe.model, make_ddim_schedule(pipe.sched, steps)
    scfg = T.SampleConfig(steps=steps, window=4, stride=3)
    x = inputs["x_T"].float()
    dev, F = x.device, x.shape[0]
    ref, hint = inputs["reference_latent"], inputs["pose_hint"]
    y, uy = inputs.get("y"), inputs.get("uncond_y")
    for i in range(steps):
        step = steps - 1 - i
        rows = torch.arange(F, device=dev)[None]
        vkw = {}
        if kind == "video":
            W = min(scfg.window, F)
            starts = torch.as_tensor(window_starts(F, scfg.window, scfg.stride), device=dev)
            rows = (starts[:, None] + inputs["window_offsets"][i]
                    + torch.arange(W, device=dev)[None]) % F
            vkw = dict(num_frames=W)
        flat = rows.reshape(-1)
        n = flat.shape[0]
        t = torch.full((n,), int(ddim.timesteps[step]), dtype=torch.int64, device=dev)
        ctx = inputs["context"].expand(n, -1, -1)
        uctx = inputs["uncond_context"].expand(n, -1, -1)
        ykw = {} if y is None else dict(y=y.expand(n, -1))
        uykw = {} if uy is None else dict(y=uy.expand(n, -1))
        bank = model.compute_bank(ref, t[:1], inputs["context"][:1],
                                  *(() if y is None else (y[:1],)))
        ec = model(x[flat], t, ctx, bank=bank, pose_hint=hint[flat], image_hint=None,
                   **ykw, **vkw)
        eu = model(x[flat], t, uctx, uc=True, **uykw, **vkw)
        eps = eu + scfg.cfg_scale * (ec - eu)
        if kind == "video":
            eps = scatter_mean(eps, rows, F)
        x, _ = ddim_step(x, eps, ddim.alphas[step], ddim.alphas_prev[step],
                         ddim.sqrt_one_minus_alphas[step], ddim.sigmas[step],
                         torch.zeros_like(x))
    return x


def replay_in_python(body, pool):
    """A capture stub: the 'replay' runs the step's Python body again, on the
    static buffers as the graph would (a capture itself runs nothing)."""
    return body


# --------------------------------------------------------------------------
# CPU
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind,frames,steps", [
    ("sd15", 2, 2), ("sd15", 2, 50), ("video", 6, 2), ("video", 6, 50), ("sdxl", 2, 2)])
def test_table_step_is_bit_equal_to_the_host_scalar_step(monkeypatch, kind, frames, steps):
    """The samplers' steps, which read t, the DDIM coefficients and the
    window offset from device tables, against the same steps with host
    scalars: the same bits, eagerly and on the graph path (run eagerly
    where a card would replay it), over one warm-up step, one capture and
    replays (at DDIM-2 a second request with the same key replays every
    step)."""
    torch.manual_seed(0)
    latent = 8
    pipe = make_pipe(kind, latent, "cpu")
    pipe.model.__dict__["_step_graphs"] = SG.StepGraphs(capture=replay_in_python)
    real = SG.decline_reason
    monkeypatch.setattr(SG, "decline_reason",
                        lambda device, **kw: real(torch.device("cuda"), **kw))
    SG.STEP_GRAPHS.clear()
    seeds = (1, 2) if steps == 2 else (1,)
    for seed in seeds:
        inputs = request_inputs(pipe, kind, frames, latent, seed, steps)
        want = host_scalar_sample(pipe, kind, steps, inputs)
        eager = sample(pipe, kind, steps, inputs, step_graph=False)
        got = sample(pipe, kind, steps, inputs)
        assert torch.equal(eager, want), (kind, steps, seed, (eager - want).abs().max().item())
        assert torch.equal(got, want), (kind, steps, seed, (got - want).abs().max().item())
    n = len(seeds) * steps
    assert SG.STEP_GRAPHS == Counter({"eager.off": n, "eager.warmup": 1, "captures": 1,
                                      "replays": n - 1})


def test_table_update_is_bit_equal_to_ddim_step():
    """Every row of `ddim_coefficients` gives `ddim_step`'s x_prev to the
    bit on the CPU, at DDIM-50 with eta 0 and 1."""
    sched = make_schedule(T.DiffusionConfig())
    g = torch.Generator().manual_seed(0)
    x, eps, noise = (torch.randn(2, 8, 8, 4, generator=g) for _ in range(3))
    for eta in (0.0, 1.0):
        ddim = make_ddim_schedule(sched, 50, eta=eta)
        coef = SG.ddim_coefficients(ddim)
        for i in range(50):
            step = 49 - i
            want, _ = ddim_step(x, eps, ddim.alphas[step], ddim.alphas_prev[step],
                                ddim.sqrt_one_minus_alphas[step], ddim.sigmas[step], noise)
            assert torch.equal(SG.ddim_step_table(x, eps, coef[i], noise), want), (eta, i)


def switched(monkeypatch, switch: str):
    """A context under which the port picks other kernels at some sites."""
    if switch == "attention_impl":
        return attention.attention_impl("xla")
    monkeypatch.setenv(*{"fused_gn": ("MAGICDANCE_FUSED_GN", "0"),
                         "grouped": ("MD_DISABLE_GROUPED_ATTN", "1")}[switch])
    return contextlib.nullcontext()


@pytest.mark.parametrize("switch", ["attention_impl", "fused_gn", "grouped"])
def test_a_kernel_dispatch_switch_makes_a_new_key(monkeypatch, switch):
    """A capture bakes in which kernel each site launches: a request under a
    switch of the dispatch (the attention override, the plain-GroupNorm or
    the no-grouped-attention switch) does not replay a graph captured
    without it; it warms up and captures its own, and is exact."""
    latent, steps = 8, 2
    pipe = make_pipe("sd15", latent, "cpu")
    pipe.model.__dict__["_step_graphs"] = SG.StepGraphs(capture=replay_in_python)
    real = SG.decline_reason
    monkeypatch.setattr(SG, "decline_reason",
                        lambda device, **kw: real(torch.device("cuda"), **kw))
    inputs = request_inputs(pipe, "sd15", 2, latent, 4, steps)
    SG.STEP_GRAPHS.clear()
    sample(pipe, "sd15", steps, inputs)
    with switched(monkeypatch, switch):
        want = sample(pipe, "sd15", steps, inputs, step_graph=False)
        got = sample(pipe, "sd15", steps, inputs)
    assert torch.equal(got, want)
    assert SG.STEP_GRAPHS["eager.warmup"] == 2 and SG.STEP_GRAPHS["captures"] == 2
    assert len(pipe.model.__dict__["_step_graphs"].entries) == 2


def test_release_drops_the_models_captured_steps(monkeypatch):
    """After `release` the model holds no captured step: its next request
    warms up and captures anew, and gives the eager request's bits."""
    latent, steps = 8, 2
    pipe = make_pipe("sd15", latent, "cpu")
    inputs = request_inputs(pipe, "sd15", 2, latent, 5, steps)
    real = SG.decline_reason
    monkeypatch.setattr(SG, "decline_reason",
                        lambda device, **kw: real(torch.device("cuda"), **kw))
    SG.STEP_GRAPHS.clear()
    want = sample(pipe, "sd15", steps, inputs, step_graph=False)
    for _ in range(2):
        pipe.model.__dict__["_step_graphs"] = SG.StepGraphs(capture=replay_in_python)
        assert torch.equal(sample(pipe, "sd15", steps, inputs), want)
        SG.release(pipe.model)
        assert "_step_graphs" not in pipe.model.__dict__
    assert SG.STEP_GRAPHS["captures"] == 2 and SG.STEP_GRAPHS["eager.warmup"] == 2


REASONS = ("cpu", "grad", "profiler", "turbo", "noise", "sharded")


@pytest.mark.parametrize("reason", REASONS)
def test_the_dispatch_declines_and_counts_each_reason(monkeypatch, reason):
    """Each condition under which the samplers step eagerly: `decline_reason`
    names it (on a CUDA device, where nothing else declines), and a request
    on the CPU, with the device check answered as on the card, counts its
    steps under it."""
    cuda = torch.device("cuda")
    flags = dict(turbo=reason == "turbo", noise=reason == "noise", sharded=reason == "sharded")
    profiling = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    around = {"grad": torch.enable_grad(), "profiler": profiling}.get(
        reason, contextlib.nullcontext())
    with around, torch.inference_mode(reason != "grad"):
        device = torch.device("cpu") if reason == "cpu" else cuda
        assert SG.decline_reason(device, **flags) == reason
    with torch.inference_mode():
        assert SG.decline_reason(cuda, turbo=False, noise=False, sharded=False) is None

    latent, steps = 8, 2
    pipe = make_pipe("sd15", latent, "cpu")
    if reason != "cpu":
        real = SG.decline_reason
        monkeypatch.setattr(SG, "decline_reason",
                            lambda device, **kw: real(torch.device("cuda"), **kw))
    inputs = request_inputs(pipe, "sd15", 2, latent, 3, steps)
    eta = 1.0 if reason == "noise" else 0.0
    ddim = make_ddim_schedule(pipe.sched, steps, eta=eta)
    scfg = T.SampleConfig(steps=steps, eta=eta, uncond_every=2 if reason == "turbo" else 1)
    x_T, ctx, uctx = inputs.pop("x_T"), inputs.pop("context"), inputs.pop("uncond_context")
    kw = dict(rows=(0, 4)) if reason == "sharded" else {}
    # ddim_sample runs in inference mode: its undecorated body sees grad mode
    run = ddim_sample.__wrapped__ if reason == "grad" else ddim_sample
    SG.STEP_GRAPHS.clear()
    around = {"grad": torch.enable_grad(), "profiler": profiling}.get(
        reason, contextlib.nullcontext())
    with around:
        out = run(pipe.model, pipe.sched, ddim, scfg, x_T, ctx, uctx,
                  generator=torch.Generator().manual_seed(0), **inputs, **kw)
    assert torch.isfinite(out).all()
    assert SG.STEP_GRAPHS == Counter({f"eager.{reason}": steps})


def test_replays_count_the_captured_launches_and_gn_sites():
    """On a stub capture that runs the step's host code once and replays
    nothing: the warm-up step counts as an eager step does, the capture's
    increments come off the counters, and every replay adds them again, so
    after N steps `LAUNCHES` and `GN_SITES` read N steps' worth. Past the
    capacity the least recently used key is evicted."""
    def body():
        LAUNCHES["self_attention"] += 3
        LAUNCHES["groupnorm_silu"] += 4
        layers.GN_SITES["k8"] += 2

    def capture(body, pool):
        body()
        return lambda: None

    launches, gn = dict(LAUNCHES), Counter(layers.GN_SITES)
    SG.STEP_GRAPHS.clear()
    graphs = SG.StepGraphs(capacity=2, capture=capture)
    sched = make_schedule(T.DiffusionConfig())
    tables = SG.StepTables.upload(make_ddim_schedule(sched, 5), "cpu", 2)
    x = torch.zeros(2, 3)
    try:
        entry = graphs.request("a", dict(x=x), 2, "cpu", sched)
        for i in range(5):
            graphs.step(entry, tables, i, body)
            assert LAUNCHES["self_attention"] - launches["self_attention"] == 3 * (i + 1)
            assert LAUNCHES["groupnorm_silu"] - launches["groupnorm_silu"] == 4 * (i + 1)
            assert layers.GN_SITES["k8"] - gn["k8"] == 2 * (i + 1)
            assert torch.equal(entry.values.t, tables.t[i])
            assert torch.equal(entry.values.coef, tables.coef[i])
        assert entry.launches == {"self_attention": 3, "groupnorm_silu": 4}
        assert entry.gn_sites == Counter({"k8": 2})
        for key in ("b", "c", "a"):
            graphs.request(key, dict(x=x), 2, "cpu", sched)
        assert list(graphs.entries) == ["c", "a"]
        assert SG.STEP_GRAPHS == Counter({"eager.warmup": 1, "captures": 1, "replays": 4,
                                          "evictions": 2})
    finally:
        LAUNCHES.update(launches)
        layers.GN_SITES.clear()
        layers.GN_SITES.update(gn)


# --------------------------------------------------------------------------
# the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def test_card_table_update_is_bit_equal_to_ddim_step(cuda):
    """On the card `ddim_step` divides by a host scalar, which CUDA computes
    as a product with the host's reciprocal: the table's update, with the
    scalars on the card, gives its bits at every DDIM-50 step."""
    sched = make_schedule(T.DiffusionConfig())
    g = torch.Generator(device=cuda).manual_seed(0)
    x, eps, noise = (torch.randn(16, 64, 64, 4, generator=g, device=cuda) for _ in range(3))
    for eta in (0.0, 1.0):
        ddim = make_ddim_schedule(sched, 50, eta=eta)
        coef = SG.ddim_coefficients(ddim).to(cuda)
        for i in range(50):
            step = 49 - i
            want, _ = ddim_step(x, eps, ddim.alphas[step], ddim.alphas_prev[step],
                                ddim.sqrt_one_minus_alphas[step], ddim.sigmas[step], noise)
            assert torch.equal(SG.ddim_step_table(x, eps, coef[i], noise), want), (eta, i)


@pytest.mark.parametrize("kind,frames", [("sd15", 4), ("video", 6), ("sdxl", 2)])
def test_card_replayed_requests_are_bit_equal_to_eager_ones(cuda, kind, frames):
    """bf16 narrow models at 128x128 (the first level's 256 positions take
    kernels A and B, the motion modules G, the norms K8): a request replayed
    from a captured step against the same request run eagerly, to the bit,
    with the kernels' launches counted alike; a second request with new
    inputs replays the same graph; a request at another latent size is a new
    key, captured anew, and exact too."""
    steps = 4
    pipe = make_pipe(kind, 16, "cuda", dtype="bfloat16")
    SG.STEP_GRAPHS.clear()
    captures = 0
    for seed, latent in ((1, 16), (2, 16), (3, 8)):
        inputs = request_inputs(pipe, kind, frames, latent, seed, steps)
        host = host_scalar_sample(pipe, kind, steps, inputs)
        if seed == 2:  # maps from the host go straight into the static buffer
            inputs["pose_hint"] = inputs["pose_hint"].cpu()
        before = dict(LAUNCHES)
        gn = Counter(layers.GN_SITES)
        want = sample(pipe, kind, steps, inputs, step_graph=False)
        assert torch.equal(want, host), (kind, seed, latent)
        torch.cuda.synchronize()
        eager_launches = {k: n - before[k] for k, n in LAUNCHES.items()}
        eager_gn = Counter(layers.GN_SITES)
        eager_gn.subtract(gn)
        before = dict(LAUNCHES)
        gn = Counter(layers.GN_SITES)
        got = sample(pipe, kind, steps, inputs)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (kind, seed, latent,
                                        (got.float() - want.float()).abs().max().item())
        assert {k: n - before[k] for k, n in LAUNCHES.items()} == eager_launches
        graph_gn = Counter(layers.GN_SITES)
        graph_gn.subtract(gn)
        assert +graph_gn == +eager_gn
        assert sum(eager_launches.values()) > 0
        captures += seed != 2
        assert SG.STEP_GRAPHS["captures"] == captures
    assert SG.STEP_GRAPHS["replays"] == 3 * steps - 2
    assert SG.STEP_GRAPHS["eager.warmup"] == 2
