"""Read the program's own spans in a cell's profiled segment, on a card.

    python3 port_bench/trace_spans.py --workload <cell> --seed <n> [--segments 2]
        [--seconds 0] [--json PATH]

Builds and warms up the cell as `run.py` does (same set-up, no check), logs
the kernel libraries built and loaded in set-up (`ops.kernels.build.BUILDS`),
runs an untraced window of `--seconds` when given (a build inside it is
logged as a fault), then profiles the cell's segment
(`harness.tracing.profile_segment`) `--segments` times. Each segment is
reduced twice from the same raw events: by `tracing.reduce_trace` (the
benchmark's result-line numbers: idle share, attention by the `pb.` hooks,
idle gaps by `pb.` span) and by `harness.program_spans.reduce` (the
program's `md.` spans: launches a step, attention by `md.attn` /
`md.attn.bwd`, idle gaps by the innermost program span or its backward
link, each span kind's host time, device time and launches). Logs a table
per segment on standard error and prints one JSON object per segment on
standard output (also written to `--json`). A build inside a segment is
logged as a fault. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def builds_line(builds: dict) -> str:
    built = {k: round(v["build_s"], 3) for k, v in builds.items() if v["builds"]}
    loaded = sorted(k for k, v in builds.items() if v["loaded"])
    return f"built {built or 'nothing'} (s); loaded {loaded}"


def fault_if_built(builds: dict, before: dict, where: str) -> None:
    for k, v in builds.items():
        if v["builds"] != before.get(k, 0):
            log(f"FAULT: kernel library {k} was built inside {where}")


def report(seg, prog) -> list:
    """The stderr lines of one segment."""
    idle = seg.span_s - seg.busy_s
    lines = [f"segment {seg.wall_s:.6f} s wall, busy {seg.busy_s:.6f} of {seg.span_s:.6f} s "
             f"(idle {100 * idle / seg.span_s:.3f}%); pb. attention "
             f"{100 * seg.attn_bound_s / seg.attn_device_s if seg.attn_device_s else 0:.3f}% "
             f"over {seg.attn_calls} calls",
             f"program spans: {prog.steps} steps, {prog.launches_per_step} launches a step; "
             f"md. attention {prog.attention_roofline} % over {prog.attn_calls} calls "
             f"(bound {prog.attn_bound_s:.6f} s, device {prog.attn_device_s:.6f} s); idle "
             f"{prog.idle_s:.6f} s, unnamed {prog.unnamed_idle_s:.6f} s "
             f"({100 * prog.unnamed_idle_s / prog.idle_s if prog.idle_s else 0:.3f}%); "
             f"{prog.linked_ops} operations named by a .bwd link; spans off the root's "
             f"thread {prog.threads}"]
    steps = max(prog.steps, 1)
    lines.append(f"{'span kind':<24} {'spans':>6} {'host ms':>10} {'device ms':>10} "
                 f"{'launches':>9}   (per step of {steps})")
    for k, v in sorted(prog.per_kind.items(), key=lambda kv: -kv[1]["host_s"]):
        lines.append(f"{k:<24} {v['spans'] / steps:>6.1f} {1e3 * v['host_s'] / steps:>10.3f} "
                     f"{1e3 * v['device_s'] / steps:>10.3f} {v['launches'] / steps:>9.1f}")
    lines.append("idle gaps by program span: " + ", ".join(
        f"{k} {1e3 * v:.3f} ms" for k, v in prog.idle_gaps[:12]))
    lines.append("idle gaps by pb. span: " + ", ".join(
        f"{k} {1e3 * v:.3f} ms" for k, v in seg.idle_gaps))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--segments", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=0.0, help="an untraced window first")
    ap.add_argument("--json", default=None, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    cache = ROOT / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    from magicdance_tpu_torch.ops.kernels import build
    from port_bench.harness import program_spans, tracing
    from port_bench.harness.serve import ServeCell
    from port_bench.harness.spec import load_cell
    from port_bench.harness.train import TrainCell
    from port_bench.run import card_line

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s)")
        return 2
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    kind = cell.traffic["kind"]
    drv = (ServeCell if kind == "serve" else TrainCell)(cell.config, cell.traffic, args.seed,
                                                        "cuda")
    drv.cache_dir = cache
    builds = getattr(build, "BUILDS", {})   # a program without the record reads as empty
    drv.setup()
    log(f"set-up {time.perf_counter() - T_START:.3f} s {drv.setup_parts}; kernel libraries: "
        f"{builds_line(builds)}")
    if args.seconds > 0:
        before = {k: v["builds"] for k, v in builds.items()}
        window = drv.window(args.seconds, timing=False)
        unit = "requests" if kind == "serve" else "steps"
        log(f"window {window:.3f} s, {len(drv.records)} {unit}; kernel libraries: "
            f"{builds_line(builds)}")
        fault_if_built(builds, before, "the window")
    reduce_trace, raw = tracing.reduce_trace, {}

    def keep(events, bounds):
        raw["events"] = events
        return reduce_trace(events, bounds)

    tracing.reduce_trace = keep   # profile_segment reduces through the module's name
    out = []
    for i in range(args.segments):
        before = {k: v["builds"] for k, v in builds.items()}
        seg = drv.segment()
        prog = program_spans.reduce(raw.pop("events"))
        fault_if_built(builds, before, f"segment {i}")
        log(f"== segment {i}")
        for line in report(seg, prog):
            log(line)
        out.append({"workload": args.workload, "seed": args.seed, "segment": i,
                    "card": card_line(), "reduce_trace": dataclasses.asdict(seg),
                    "program": dict(dataclasses.asdict(prog),
                                    launches_per_step=prog.launches_per_step,
                                    attention_roofline=prog.attention_roofline),
                    "builds": builds})
    tracing.reduce_trace = reduce_trace
    lines = [json.dumps(o) for o in out]
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        with open(args.json, "a") as f:
            f.write("\n".join(lines) + "\n")
    print("\n".join(lines), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
