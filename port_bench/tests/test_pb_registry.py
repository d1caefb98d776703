"""The harness finds every cell, configuration, traffic mix and metric of
`BENCHMARK.json` by name, and the files agree with it."""

from __future__ import annotations

import json
import re

import pytest

from port_bench.harness import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads(cell):
    c = spec.load_cell(cell)
    assert c.traffic["kind"] in ("serve", "train")
    assert set(c.traffic["limits"]) == (
        {"latent_gap", "decode_gap"} if c.traffic["kind"] == "serve"
        else {"loss_gap", "grad_gap", "change_gap"})
    assert "model" in c.config and "train" in c.config
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2, "setup_s and one more end-to-end metric"
    assert c.per_layer, "at least one per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in e2e, f"{m['name']} moves a metric the cell does not report"


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_every_configuration_names_a_reference_family_that_resolves(conf):
    config = spec.load_json(spec.ROOT / conf["file"])
    family = spec.reference_family(config)
    assert all(callable(getattr(family, a)) for a in spec.FAMILY_API)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    mod = spec.metric_reader(metric["name"])
    assert callable(mod.read)
    assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (metric["unit"], metric["better"],
                                                   metric["source"])
    assert mod.MOVES == metric.get("moves")


def test_names_units_and_paths_keep_the_contract():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names), names
    assert len(set(names)) == len(names)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert BENCH["paths"] == ["port_bench"]
    for c in BENCH["configs"]:
        assert c["file"].startswith("port_bench/") and (spec.ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert (spec.BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert 1 <= BENCH["run_seconds"] <= 51


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError, match="no workload"):
        spec.load_cell("no-such-cell")
