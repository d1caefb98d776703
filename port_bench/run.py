"""Run one cell of the benchmark of `magicdance_tpu_torch` once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the program with weights and inputs made on the card from the seed,
warms up the cell's shapes (set-up), measures for `--seconds` (the request
or step in flight then finishes), and with `--trace 1` also runs a short
profiled segment. After the window it frees the program and checks a sample
of what the window produced against the plain reference
(`port_bench/reference`). The last line of standard output is one JSON
object (`correct`, `attempted`, `failed`, `metrics`, `device`, with
`--trace 1` `breakdown`, and last `check`: each compared number with its
limit); the compared numbers are also the last lines of standard error.
Exits non-zero, printing no result, without enough CUDA cards or when JAX
or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "magicdance_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_START = process_age_s()


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port may not load,
    compared whole (`magicdance_tpu_torch` is not `magicdance_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def cached_flops(cell, count) -> float:
    """The model FLOPs of one request or step of `cell`: `count()` (on the
    reference, meta device) the first time in a checkout, then read back
    from `.bench_cache/flops/`, keyed by the configuration and traffic."""
    key = hashlib.sha256(json.dumps([cell.config, cell.traffic], sort_keys=True)
                         .encode()).hexdigest()[:16]
    path = CACHE / "flops" / f"{key}.json"
    if path.is_file():
        return float(json.loads(path.read_text())["flops"])
    flops = count()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}")
    tmp.write_text(json.dumps({"cell": cell.name, "flops": flops}))
    tmp.replace(path)
    return flops


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def measure(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
            parts: dict | None = None) -> dict:
    """One run of `cell` (a `harness.spec.Cell`); returns the result line
    as a dict. device="cpu" runs the same steps on the CPU (tests only);
    `parts` are set-up times measured before the call."""
    import torch

    from port_bench.harness import check
    from port_bench.harness.serve import ServeCell
    from port_bench.harness.spec import metric_reader
    from port_bench.harness.train import TrainCell
    from port_bench.reference.model import Numerics

    cuda = torch.device(device).type == "cuda"
    kind = cell.traffic["kind"]
    drv = (ServeCell if kind == "serve" else TrainCell)(cell.config, cell.traffic, seed, device)
    drv.cache_dir = CACHE if cuda else None
    drv.setup_parts.update(parts or {})
    drv.setup_parts["before_build_s"] = AGE_AT_START + time.perf_counter() - T_START
    drv.setup()
    setup_s = AGE_AT_START + time.perf_counter() - T_START
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    window_s = drv.window(seconds, timing=trace and cuda)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    vae_ms = drv.spans.vae_ms_per_frame() if trace and cuda else None
    segment = drv.segment() if trace and cuda else None
    done = len(drv.records)
    frames = sum(n for _, n in drv.records)
    log(f"window {window_s:.3f} s, {done} {'requests' if kind == 'serve' else 'steps'}, "
        f"{frames} frames; set-up {setup_s:.3f} s {drv.setup_parts}")
    if kind == "serve":
        log("request seconds " + " ".join(f"{s:.4f}" for s, _ in drv.records))
    drv.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    unit = "request" if kind == "serve" else "step"
    count = drv.flops_per_request if kind == "serve" else drv.flops_per_step
    per = cached_flops(cell, count) if cuda else count()
    flops = per * done
    if kind == "serve":
        items = []
        for i in drv.check_sample(done):
            images, latents = drv.outputs[i]
            items.append((images, latents, *drv.reference(i, Numerics(), latents)))
        numbers = check.serve_numbers(items)
    else:
        numbers = check.train_numbers(drv.readings, drv.reference(Numerics(remat=True)))
    log(f"check and FLOP count {time.perf_counter() - t0:.3f} s; {per:.6e} FLOP a {unit}")
    correct, compared = check.judge(numbers, cell.traffic["limits"])
    run = SimpleNamespace(kind=kind, window_s=window_s, setup_s=setup_s, units=done,
                          frames=frames, flops=flops, peak_bytes=window_peak,
                          vae_ms_per_frame=vae_ms, segment=segment)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": max(setup_peak, window_peak)}
    out = {"correct": correct, "attempted": done, "failed": 0, "metrics": metrics,
           "device": dev}
    if segment is not None:
        dev["busy_s"], dev["window_s"] = segment.busy_s, segment.span_s
        out["breakdown"] = {"device_ops": segment.device_ops, "idle_gaps": segment.idle_gaps}
        log(f"segment {segment.wall_s:.3f} s wall, busy {segment.busy_s:.6f} of "
            f"{segment.span_s:.6f} s, attention {segment.attn_calls} calls, bound "
            f"{segment.attn_bound_s:.6f} s, device {segment.attn_device_s:.6f} s")
    out["check"] = compared
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench.harness.spec import load_cell

    parts = {"torch_import_s": AGE_AT_START + time.perf_counter() - T_START}
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.zeros(1, device="cuda")
    parts["cuda_init_s"] = AGE_AT_START + time.perf_counter() - T_START - parts["torch_import_s"]
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    out = measure(cell, args.seed, args.seconds, bool(args.trace), parts=parts)
    loaded = forbidden_modules()
    if loaded:
        log(f"modules that the port may not load were loaded: {loaded}")
        return 3
    for name, c in out["check"].items():
        log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
