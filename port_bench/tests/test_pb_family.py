"""A configuration names its plain reference family (`"reference"`, by
default `sd15`), and every reference call of `ServeCell`, `TrainCell` and
the control goes through that family; an image traffic may check a subset
of frames."""

from __future__ import annotations

import ast
import copy
import sys
import types

import pytest
import torch

from port_bench import control
from port_bench.harness import check, spec
from port_bench.harness import weights as W
from port_bench.harness.serve import ServeCell
from port_bench.harness.train import TrainCell
from port_bench.reference import sd15
from port_bench.reference.model import Numerics
from port_bench.tests.tiny import tiny_cell

SEED = 2**31 + 4242


@pytest.fixture(autouse=True, scope="module")
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def named(cell, family="sd15", **traffic):
    c = copy.deepcopy(cell)
    c.config["reference"] = family
    c.traffic.update(traffic)
    return c


@pytest.fixture(scope="module")
def image_cell():
    return tiny_cell("sd15-pose.serve-f16", frames=3, steps=2)


@pytest.fixture(scope="module")
def full_reference(image_cell):
    """The reference's latents of request 0, every frame, no family named."""
    lat, _, rows = ServeCell(image_cell.config, image_cell.traffic, SEED, "cpu").reference(
        0, Numerics())
    assert rows is None
    return lat


def test_naming_sd15_changes_nothing_but_the_layout_key(image_cell, full_reference):
    c = named(image_cell)
    drv = ServeCell(c.config, c.traffic, SEED, "cpu")
    assert drv.family is sd15
    lat, _, _ = drv.reference(0, Numerics())
    assert torch.equal(lat, full_reference)
    assert W.layout(c.config) == W.layout(image_cell.config)
    # the cache key of a file that names no family is the model configuration's, as before
    assert W.layout_key(image_cell.config) == W.layout_key({"model": image_cell.config["model"]})
    assert W.layout_key(c.config) != W.layout_key(image_cell.config)
    train = tiny_cell("sd15-pose-mm.train-stage3")
    flops = [TrainCell(t.config, t.traffic, SEED, "cpu").flops_per_step()
             for t in (train, named(train))]
    assert flops[0] == flops[1] > 0


@pytest.mark.parametrize("name", ["no_such_family", "model", "../run", 7])
def test_an_unknown_family_is_refused(image_cell, name):
    c = named(image_cell, name)
    with pytest.raises(KeyError, match=r"no reference family .*\(has: sd15\)"):
        ServeCell(c.config, c.traffic, SEED, "cpu")


def spy_family(calls: list) -> types.ModuleType:
    """A family module that records each call of its interface: real
    networks (the weights are drawn on their layout), stand-in results for
    the rest."""
    spy = types.ModuleType("port_bench.reference.spy")

    def networks(model_cfg, num=Numerics()):
        calls.append("networks")
        return sd15.networks(model_cfg, num)

    def sample(nets, model_cfg, pose, ref_image, x_T, *a, **kw):
        calls.append("sample")
        return torch.zeros(x_T.shape, device=x_T.device)

    def decode(vae, latents, model_cfg, num):
        calls.append("decode")
        n, h, w, _ = latents.shape
        return torch.zeros(n, 8 * h, 8 * w, 3, device=latents.device)

    class ReferenceTrainer:
        def __init__(self, model, vae, clip, cfg, train, num):
            calls.append("ReferenceTrainer")
            self.params = {}

        def loss_and_grads(self, batch, draws):
            return torch.zeros(()), {}

        def update(self, grads):
            return {"leaf": torch.zeros(())}

    spy.networks, spy.sample, spy.decode = networks, sample, decode
    spy.ReferenceTrainer = ReferenceTrainer
    return spy


def test_every_reference_call_goes_through_the_family(monkeypatch):
    """A family added as a module under `port_bench.reference` (here put
    into `sys.modules`) and named by the configuration serves every
    reference call of `ServeCell`, `TrainCell` and the control."""
    calls = []
    spy = spy_family(calls)
    monkeypatch.setitem(sys.modules, spy.__name__, spy)

    def seen(fn, *a):
        calls.clear()
        fn(*a)
        return set(calls)

    serve = named(tiny_cell("sd15-pose.serve-f16", frames=1, steps=1), "spy")
    drv = ServeCell(serve.config, serve.traffic, SEED, "cpu")
    assert drv.family is spy
    want = {"networks", "sample", "decode"}
    assert seen(drv.reference, 0, Numerics(), torch.zeros(1, 8, 8, 4)) == want
    assert seen(drv.flops_per_request) == want
    train = named(tiny_cell("sd15-pose-mm.train-stage3"), "spy", check_steps=1)
    tdrv = TrainCell(train.config, train.traffic, SEED, "cpu")
    assert seen(tdrv.reference, Numerics()) == {"networks", "ReferenceTrainer"}
    assert seen(tdrv.flops_per_step) == {"networks", "ReferenceTrainer"}

    # the control, with the program's set-up and request left out
    def request(self, i, steps):
        self._latents = torch.zeros(self.frames, 8, 8, 4)
        return torch.zeros(self.frames, 64, 64, 3)

    monkeypatch.setattr(ServeCell, "setup", lambda self: None)
    monkeypatch.setattr(ServeCell, "request", request)
    monkeypatch.setattr(ServeCell, "release", lambda self: None)
    assert seen(control.serve_readings, serve, SEED, "cpu") == want
    monkeypatch.setattr(TrainCell, "setup", lambda self: setattr(self, "readings", {}))
    monkeypatch.setattr(TrainCell, "release", lambda self: None)
    monkeypatch.setattr(check, "train_numbers", lambda got, want: {})
    assert seen(control.train_readings, train, SEED, "cpu", "half_batch") == {
        "networks", "ReferenceTrainer"}


HARNESS = [p for p in spec.BENCH_DIR.rglob("*.py")
           if p.parent.name not in ("reference", "tests")]


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: str(p.relative_to(spec.BENCH_DIR)))
def test_the_harness_reaches_the_reference_only_through_its_family(path):
    """Outside `port_bench/reference/` only the precision policy
    (`Numerics`) and the empty prompt's ids (an input) are imported from a
    reference module by name; networks, samplers and trainers come from
    `spec.reference_family`."""
    allowed = {("port_bench.reference.model", "Numerics"),
               ("port_bench.reference.sample", "empty_ids")}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith(
                "port_bench.reference"):
            for a in node.names:
                assert (node.module, a.name) in allowed, (node.module, a.name)
        elif isinstance(node, ast.Import):
            assert not any(a.name.startswith("port_bench.reference") for a in node.names)


def test_a_subset_of_frames_reproduces_those_rows(image_cell, full_reference):
    c = named(image_cell, check_frames=1)
    drv = ServeCell(c.config, c.traffic, SEED, "cpu")
    rows = drv.check_rows(0)
    assert len(rows) == 1 and rows == drv.check_rows(0)
    latents = full_reference + 0.01
    lat, images, got_rows = drv.reference(0, Numerics(), latents)
    assert got_rows == rows and lat.shape[0] == 1 and images.shape[0] == 1
    gap = (lat - full_reference[rows]).abs().max() / full_reference[rows].abs().max()
    assert float(gap) < 1e-6
    # the check compares the program's rows `rows` with the reference's
    numbers = check.serve_numbers([(torch.zeros(3, 64, 64, 3), full_reference, lat, images,
                                    rows)])
    assert numbers["latent_gap"] < 1e-6


@pytest.mark.parametrize("cell,k", [("sd15-pose-mm.serve-video16", 1),
                                    ("sd15-pose.serve-f16", 0), ("sd15-pose.serve-f16", 4)])
def test_check_frames_is_refused_where_it_cannot_hold(cell, k):
    c = tiny_cell(cell, frames=3)
    c.traffic["check_frames"] = k
    with pytest.raises(ValueError, match="check_frames"):
        ServeCell(c.config, c.traffic, SEED, "cpu")
