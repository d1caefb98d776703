"""What a run measures, found by name: the cell in `BENCHMARK.json`, its
configuration (`port_bench/configs/<config>.json`), the plain reference
that configuration names (`port_bench/reference/<family>.py`), its traffic
mix (`port_bench/traffic/<traffic>.json`) and one reader per metric
(`port_bench/metrics/<metric>.py`). A cell, mix, metric or reference family
is added by adding files and entries; nothing here names one."""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict    # the configuration file: {"model": ModelConfig dict, "train": ..., ...}
    traffic: dict   # the traffic mix's parameters
    end_to_end: list  # metric entries of BENCHMARK.json this cell reports (--trace 0)
    per_layer: list   # ... and with --trace 1


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = load_json(bench_path)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {name!r} in {bench_path.name} (has: {known})")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name, config_name=entry["config"], traffic_name=entry["traffic"],
        chips=int(entry["chips"]),
        config=load_json(ROOT / conf["file"]),
        traffic=load_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
    )


def metric_reader(name: str) -> ModuleType:
    """The reader module `port_bench/metrics/<name>.py`: `read(run)` gives
    the metric's value, or None when the run has nothing to read."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


DEFAULT_FAMILY = "sd15"
FAMILY_API = ("networks", "sample", "decode", "ReferenceTrainer")


def _family(name) -> ModuleType | None:
    """The module `port_bench.reference.<name>` if it offers `FAMILY_API`."""
    if not isinstance(name, str) or not re.fullmatch(r"[a-z0-9_]+", name):
        return None
    module = f"port_bench.reference.{name}"
    try:
        mod = importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        return None
    return mod if all(hasattr(mod, a) for a in FAMILY_API) else None


def reference_family(config: dict) -> ModuleType:
    """The plain reference a configuration file is held to: the module
    `port_bench/reference/<config["reference"]>.py`, by default `sd15`
    (the SD1.5 MagicPose networks). It offers `networks(model_cfg, num)`
    ({"model", "vae", "clip"} on the meta device, named by the program's
    state-dict keys), `sample(nets, model_cfg, pose, ref_image, x_T, steps,
    scale, num, video=, offsets=, window=, stride=)`, `decode(vae, latents,
    model_cfg, num)` and `ReferenceTrainer`."""
    name = config.get("reference", DEFAULT_FAMILY)
    mod = _family(name)
    if mod is None:
        known = [p.stem for p in sorted((BENCH_DIR / "reference").glob("*.py"))
                 if _family(p.stem) is not None]
        raise KeyError(f"no reference family {name!r} under port_bench/reference "
                       f"(has: {', '.join(known)})")
    return mod
