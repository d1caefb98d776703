"""DDIM sampling (PyTorch), the exact recipe and the turbo levers.

Counterpart of `magicdance_tpu.sampling.ddim`: the JAX `lax.scan` becomes a
Python loop over the steps. Per step, in order: the appearance-UNet write
pass on the (batch-1) reference latent, the pose ControlNet, the main-UNet
cond pass reading the bank, the CFG uncond pass and the DDIM update. All
frames of a request are one batch and the bank is computed once per step for
the whole batch. Reference quirks kept: `wonoise=True` feeds the clean
reference latent to the write pass every step; `controlnet_important` makes
the uncond pass a vanilla SD forward.

`SampleConfig.fused_cfg` runs the cond and uncond passes as one batch
(`MagicPoseModel.cfg_fused_eps`). The turbo levers (`cfg_interval`,
`uncond_every`, `pose_every`, `deepcache_every`, `bank_every`, with
`reuse_exact_first`/`_last`) follow per-step masks computed on the host
(`build_turbo_schedules`); where JAX gates a pass with `lax.cond`, the loop
branches on the mask, so a skipped pass costs nothing. `bank_downsample`
pools the bank entries (`downsample_bank`) and `self_kv_downsample` the self
keys/values of the read and plain passes. JAX's quirks hold: with
`fused_cfg` the turbo flags are ignored; with `cfg_scale == 1` there is no
CFG, so `fused_cfg` and `cfg_interval` do nothing; `fused_cfg` with
`self_kv_downsample > 1` is refused. Under DUAL_CONTROL an `image_hint`
feeds the second ControlNet in every branch; the `pose_every` cache holds
the summed residuals of both ControlNets.

An SDXL configuration's added vectors (`y` with the context, `uncond_y`
with the uncond context) reach every pass of the exact recipe; the turbo
levers and fused CFG do not carry them and refuse such a configuration.

`make_eps_fn` is the per-step conditioning of the exact path (bank write
pass, control branches, cond pass, CFG against a vanilla-SD uncond pass)
as one eps closure: the PLMS and DPM-Solver++ samplers build on it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from magicdance_tpu_torch.config import Parameterization, SampleConfig
from magicdance_tpu_torch.models.diffusion import output_to_eps
from magicdance_tpu_torch.models.magicpose import refuse_vector
from magicdance_tpu_torch.ops.schedules import DDIMSchedule, DiffusionSchedule, q_sample
from magicdance_tpu_torch.sampling import step_graph as SG
from magicdance_tpu_torch.utils.profiling import span


def ddim_step(x: torch.Tensor, eps: torch.Tensor, alpha: torch.Tensor,
              alpha_prev: torch.Tensor, sqrt_one_minus_alpha: torch.Tensor,
              sigma: torch.Tensor, noise: torch.Tensor):
    """One DDIM update x_t -> x_{t-1} (ref ddim.py:633-645); the schedule
    scalars are 0-dim fp32 tensors. Returns (x_prev, pred_x0)."""
    pred_x0 = (x - sqrt_one_minus_alpha * eps) / torch.sqrt(alpha)
    dir_xt = torch.sqrt(torch.clamp(1.0 - alpha_prev - sigma**2, min=0.0)) * eps
    x_prev = torch.sqrt(alpha_prev) * pred_x0 + dir_xt + sigma * noise
    return x_prev, pred_x0


def check_control_mode(scfg: SampleConfig) -> None:
    if scfg.control_mode not in ("controlnet_important", "balance"):
        raise ValueError(f"unknown control_mode {scfg.control_mode!r}")


def build_turbo_schedules(scfg: SampleConfig, num_train_timesteps: int, timesteps,
                          use_cfg: bool):
    """Host-side per-step masks of the turbo loop, numpy bool arrays of shape
    (S,) indexed by SCHEDULE position (``step``; the loop executes steps in
    descending order, ``step = S-1-i``); a copy of the JAX package's:

      active   -- CFG is applied this step (cfg_interval gate, inclusive
                  ``[lo, hi]`` over t/num_train_timesteps)
      refresh  -- the uncond eps is freshly computed (every ``uncond_every``-th
                  CFG-active step)
      pose_refresh -- pose-ControlNet residuals recomputed (every
                  ``pose_every``-th executed step)
      deep_refresh -- cond-pass DeepCache deep levels recomputed (every
                  ``deepcache_every``-th executed step)
      udeep_refresh -- uncond-pass DeepCache deep levels recomputed, scheduled
                  over REFRESH-step ordinals (every
                  ceil(deepcache_every/uncond_every)-th refresh step), not as
                  ``refresh & deep_refresh``: the first fresh-uncond step is
                  always a full pass.
      bank_refresh -- the appearance bank recomputed (every ``bank_every``-th
                  executed step).
    """
    S = len(timesteps)
    ts = np.asarray(timesteps, dtype=np.float64)
    frac = ts / float(num_train_timesteps)
    lo, hi = scfg.cfg_interval if scfg.cfg_interval is not None else (0.0, 1.0)
    active = (frac >= lo) & (frac <= hi)
    if not use_cfg:
        active[:] = False
    refresh = np.zeros(S, dtype=bool)
    pose_refresh = np.zeros(S, dtype=bool)
    n_active = 0
    for i_exec in range(S):  # execution order: descending t
        step_exec = S - 1 - i_exec
        if active[step_exec]:
            if n_active % max(scfg.uncond_every, 1) == 0:
                refresh[step_exec] = True
            n_active += 1
        if i_exec % max(scfg.pose_every, 1) == 0:
            pose_refresh[step_exec] = True
    deep_refresh = np.zeros(S, dtype=bool)
    for i_exec in range(S):
        if i_exec % max(scfg.deepcache_every, 1) == 0:
            deep_refresh[S - 1 - i_exec] = True
    udeep_refresh = np.zeros(S, dtype=bool)
    u_stride = max(-(-scfg.deepcache_every // max(scfg.uncond_every, 1)), 1)  # ceil
    n_refresh = 0
    for i_exec in range(S):
        step_exec = S - 1 - i_exec
        if refresh[step_exec]:
            if n_refresh % u_stride == 0:
                udeep_refresh[step_exec] = True
            n_refresh += 1
    bank_refresh = np.zeros(S, dtype=bool)
    for i_exec in range(S):
        if i_exec % max(scfg.bank_every, 1) == 0:
            bank_refresh[S - 1 - i_exec] = True
    # exact endpoints: every cache refreshes on the first/last N executed steps
    if scfg.reuse_exact_first > 0 or scfg.reuse_exact_last > 0:
        for i_exec in range(S):
            if i_exec < scfg.reuse_exact_first or i_exec >= S - scfg.reuse_exact_last:
                step_exec = S - 1 - i_exec
                pose_refresh[step_exec] = True
                deep_refresh[step_exec] = True
                bank_refresh[step_exec] = True
                if active[step_exec]:
                    refresh[step_exec] = True
                    udeep_refresh[step_exec] = True
    return active, refresh, pose_refresh, deep_refresh, udeep_refresh, bank_refresh


def downsample_bank(bank, factor: int, min_seq: int = 4096):
    """Average-pool each (B, S, C) bank entry ``factor x factor`` over its
    site's (sqrt(S), sqrt(S)) grid (tokens row-major over (h, w)), in fp32,
    cast back. Entries with fewer than ``min_seq`` tokens, or whose site is
    not a square grid divisible by ``factor``, pass through exact."""
    if bank is None or factor <= 1:
        return bank

    def pool(e):
        b, s, c = e.shape
        h = int(round(s ** 0.5))
        if h * h != s or s < min_seq or h % factor:
            return e
        hp = h // factor
        x = e.reshape(b, hp, factor, hp, factor, c).float()
        return x.mean(dim=(2, 4)).reshape(b, hp * hp, c).to(e.dtype)

    return tuple(pool(e) for e in bank)


class TurboPlan:
    """What the sampler runs at each step: the host masks of
    `build_turbo_schedules` when a turbo lever is on (`turbo`), else every
    pass fresh at every step; and which caches are in use. Shared by the
    image and the video samplers (the video sampler has no fused CFG)."""

    def __init__(self, scfg: SampleConfig, sched: DiffusionSchedule,
                 ddim: DDIMSchedule, use_cfg: bool, has_appearance: bool,
                 has_controls: bool, fused_cfg: bool):
        use_pose_reuse = scfg.pose_every > 1 and has_controls
        use_deepcache = scfg.deepcache_every > 1
        use_bank_reuse = scfg.bank_every > 1 and has_appearance
        self.turbo = not fused_cfg and (
            use_pose_reuse or use_deepcache or use_bank_reuse
            or (use_cfg and (scfg.cfg_interval is not None or scfg.uncond_every > 1)))
        S = ddim.num_steps
        if self.turbo:
            masks = build_turbo_schedules(scfg, sched.num_timesteps,
                                          ddim.timesteps.cpu().numpy(), use_cfg)
        else:
            masks = (np.full(S, use_cfg),) + tuple(np.ones(S, dtype=bool) for _ in range(5))
        (self.active, self.refresh, self.pose_refresh, self.deep_refresh,
         self.udeep_refresh, self.bank_refresh) = masks
        self.pose_reuse = self.turbo and use_pose_reuse
        self.deepcache = self.turbo and use_deepcache
        self.bank_reuse = self.turbo and use_bank_reuse
        self.uncond_deepcache = (self.deepcache and use_cfg
                                 and scfg.control_mode != "balance")
        self.deep_level = scfg.deepcache_level


def self_kv_kwargs(scfg: SampleConfig) -> dict:
    if scfg.self_kv_downsample > 1:
        return dict(self_kv_pool=scfg.self_kv_downsample,
                    self_kv_min_seq=scfg.self_kv_min_seq)
    return {}


@torch.inference_mode()
def ddim_sample(
    model,
    sched: DiffusionSchedule,
    ddim: DDIMSchedule,
    scfg: SampleConfig,
    x_T: torch.Tensor,
    context: torch.Tensor,
    uncond_context: Optional[torch.Tensor] = None,
    *,
    reference_latent: Optional[torch.Tensor] = None,
    pose_hint: Optional[torch.Tensor] = None,
    image_hint: Optional[torch.Tensor] = None,
    parameterization: Parameterization = Parameterization.EPS,
    generator: Optional[torch.Generator] = None,
    rows: Optional[tuple[int, int]] = None,
    y: Optional[torch.Tensor] = None,
    uncond_y: Optional[torch.Tensor] = None,
    step_graph: bool = True,
) -> torch.Tensor:
    """Sample latents x_0 from x_T.

    model: a MagicPoseModel. x_T: (B, h, w, 4); context / uncond_context:
    (1 or B, 77, context_dim); reference_latent: (Br, h, w, 4), Br in {1, B};
    pose_hint: (B, H, W, 3); image_hint: (B, H, W, 3), the DUAL_CONTROL
    image ControlNet's hint. `generator` supplies the noise when eta > 0 or
    wonoise is off; with the default recipe the sampler draws nothing.
    `rows` = (first row, total rows): x_T is that share of a larger batch
    (frame-parallel serving), and the per-step noise is drawn for the whole
    batch and cut to the share, as one device would draw it. y / uncond_y:
    (1 or B, adm_in_channels), the added vectors that go with context and
    uncond_context (SDXL); the bank write pass takes y's first row.

    On the card the exact recipe's steps replay one captured CUDA graph
    (`sampling.step_graph`: the same bits as the eager steps; a replay calls
    no Python forward hook); `step_graph=False` runs every step eagerly."""
    check_control_mode(scfg)
    if scfg.self_kv_downsample > 1 and scfg.fused_cfg:
        raise ValueError("self_kv_downsample needs separate cond/uncond passes (the "
                         "gated bank_mask kernel has no pooled variant), as in JAX")
    B = x_T.shape[0]
    use_cfg = scfg.cfg_scale != 1.0 and uncond_context is not None
    has_appearance = reference_latent is not None and model.cfg.has_appearance
    has_controls = (pose_hint is not None and model.cfg.has_pose) or (
        image_hint is not None and model.cfg.has_image_control)
    plan = TurboPlan(scfg, sched, ddim, use_cfg, has_appearance, has_controls, scfg.fused_cfg)
    kv_kw = self_kv_kwargs(scfg)
    fused = use_cfg and scfg.fused_cfg
    levers = fused or plan.turbo or bool(kv_kw) or scfg.bank_downsample > 1
    if levers:
        refuse_vector(model.cfg, "a turbo lever or fused CFG")

    run = SG.bind(model, sched, ddim, dict(
        x=x_T.float(), context=context, uncond_context=uncond_context,
        reference_latent=reference_latent if has_appearance else None,
        pose_hint=pose_hint, image_hint=image_hint, y=y, uncond_y=uncond_y), B,
        "image", scfg.cfg_scale, scfg.control_mode, parameterization, graph=step_graph,
        turbo=levers, noise=scfg.eta > 0 or (has_appearance and not scfg.wonoise),
        sharded=rows is not None and rows[1] != B)
    inp, sched = run.inputs, run.sched
    reference_latent, pose_hint, image_hint = (
        inp.get(k) for k in ("reference_latent", "pose_hint", "image_hint"))

    def tile(c):
        if c is None:
            return None
        return c.expand(B, *c.shape[1:]) if c.shape[0] == 1 else c

    def to_eps(out, x, t):
        return output_to_eps(parameterization, sched, out, x, t)

    ctx, uctx = tile(inp["context"]), tile(inp.get("uncond_context"))
    y, uncond_y = inp.get("y"), inp.get("uncond_y")
    ykw = {} if y is None else dict(y=tile(y))
    uykw = {} if uncond_y is None else dict(y=tile(uncond_y))
    ref_ctx = inp["context"][:1]
    ref_y = None if y is None else y[:1]
    # caches: each is refreshed by the schedules at its first use (JAX
    # carries zeros before that and never reads them)
    eps_u = torch.zeros_like(run.x)
    bank = pose_res = deep = deep_u = None

    def one_step(x, step, v: SG.StepValues):
        """The step at schedule position `step` from x, with its t and DDIM
        coefficients from `v`."""
        nonlocal eps_u, bank, pose_res, deep, deep_u
        t = v.t
        if has_appearance and plan.bank_refresh[step]:
            t_ref = t[:reference_latent.shape[0]]
            if scfg.wonoise:
                ref_noisy = reference_latent
            else:
                ref_noise = torch.randn(reference_latent.shape, generator=generator,
                                        device=x.device, dtype=reference_latent.dtype)
                ref_noisy = q_sample(sched, reference_latent, t_ref, ref_noise)
            bank = downsample_bank(model.compute_bank(ref_noisy, t_ref, ref_ctx, ref_y),
                                   scfg.bank_downsample, scfg.bank_downsample_min_seq)

        if fused:
            out_c, out_u = model.cfg_fused_eps(x, t, ctx, uctx, bank=bank,
                                               pose_hint=pose_hint, image_hint=image_hint)
            eps_c, eps_u = to_eps(out_c, x, t), to_eps(out_u, x, t)
            eps = eps_u + scfg.cfg_scale * (eps_c - eps_u)
        else:
            pose_kw = {}
            if plan.pose_reuse:
                if plan.pose_refresh[step]:
                    pose_res = model.compute_control_residuals(x, pose_hint, t, ctx,
                                                               image_hint=image_hint, **kv_kw)
                pose_kw = dict(pose_residuals=pose_res)
            cond_kw = dict(bank=bank, pose_hint=pose_hint, image_hint=image_hint, **pose_kw,
                           **kv_kw, **ykw)
            if plan.deepcache and plan.deep_refresh[step]:
                out_c, deep = model(x, t, ctx, collect_deep=True,
                                    deep_level=plan.deep_level, **cond_kw)
            elif plan.deepcache:
                out_c = model(x, t, ctx, deep_cache_in=deep, deep_level=plan.deep_level,
                              **cond_kw)
            else:
                out_c = model(x, t, ctx, **cond_kw)
            eps_c = to_eps(out_c, x, t)
            if use_cfg and plan.refresh[step]:
                if scfg.control_mode == "balance":
                    # the uncond pass keeps both control branches and swaps
                    # only the text conditioning
                    out_u = model(x, t, uctx, **{**cond_kw, **uykw})
                elif plan.uncond_deepcache and plan.udeep_refresh[step]:
                    out_u, deep_u = model(x, t, uctx, uc=True, collect_deep=True,
                                          deep_level=plan.deep_level, **kv_kw)
                elif plan.uncond_deepcache:
                    out_u = model(x, t, uctx, uc=True, deep_cache_in=deep_u,
                                  deep_level=plan.deep_level, **kv_kw)
                else:  # controlnet_important: vanilla SD uncond
                    out_u = model(x, t, uctx, uc=True, **kv_kw, **uykw)
                eps_u = to_eps(out_u, x, t)
            if plan.active[step]:
                eps = eps_u + scfg.cfg_scale * (eps_c - eps_u)
            else:
                eps = eps_c

        if scfg.eta > 0:
            first, total = rows if rows is not None else (0, B)
            noise = torch.randn((total,) + tuple(x.shape[1:]), generator=generator,
                                device=x.device, dtype=x.dtype)[first:first + B]
        else:
            noise = torch.zeros_like(x)
        return SG.ddim_step_table(x, eps, v.coef, noise)

    S = ddim.num_steps
    for i in range(S):
        with span("md.ddim.step", " i={}".format, i):
            step = S - 1 - i  # descending t
            run.step(i, lambda x, v: one_step(x, step, v))
    return run.result()


def make_eps_fn(model, sched: DiffusionSchedule, scfg: SampleConfig, batch: int,
                context: torch.Tensor, uncond_context: Optional[torch.Tensor],
                reference_latent: Optional[torch.Tensor], pose_hint: Optional[torch.Tensor],
                parameterization: Parameterization,
                generator: Optional[torch.Generator]):
    """eps(x, t_scalar) of the exact recipe at one timestep: the bank write
    pass on the reference (clean under `wonoise`, else noised to t with a
    draw from `generator`), the cond pass with the control branches, and,
    with CFG, the vanilla-SD uncond pass combined as eu + s (ec - eu). The
    model outputs are turned into eps for V-parameterized models. One
    function for the PLMS and DPM-Solver++ samplers, as the JAX package's
    `eps_at` / `x0_at` closures are one recipe."""
    refuse_vector(model.cfg, "the PLMS and DPM-Solver++ samplers")
    use_cfg = scfg.cfg_scale != 1.0 and uncond_context is not None
    has_appearance = reference_latent is not None and model.cfg.has_appearance

    def tile(c):
        if c is None:
            return None
        return c.expand(batch, *c.shape[1:]) if c.shape[0] == 1 else c

    ctx, uctx = tile(context), tile(uncond_context)
    ref_ctx = context[:1]

    def eps_at(x: torch.Tensor, t_scalar: int) -> torch.Tensor:
        t = torch.full((batch,), t_scalar, dtype=torch.int64, device=x.device)
        bank = None
        if has_appearance:
            t_ref = torch.full((reference_latent.shape[0],), t_scalar, dtype=torch.int64,
                               device=x.device)
            ref_noisy = reference_latent
            if not scfg.wonoise:
                noise = torch.randn(reference_latent.shape, generator=generator,
                                    device=x.device, dtype=reference_latent.dtype)
                ref_noisy = q_sample(sched, reference_latent, t_ref, noise)
            bank = model.compute_bank(ref_noisy, t_ref, ref_ctx)
        e = output_to_eps(parameterization, sched, model(x, t, ctx, bank=bank,
                                                         pose_hint=pose_hint), x, t)
        if use_cfg:
            eu = output_to_eps(parameterization, sched, model(x, t, uctx, uc=True), x, t)
            e = eu + scfg.cfg_scale * (e - eu)
        return e

    return eps_at
