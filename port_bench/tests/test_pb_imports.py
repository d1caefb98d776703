"""No module under port_bench/ imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level names are compared
whole: `magicdance_tpu_torch` begins with `magicdance_tpu`."""

from __future__ import annotations

import ast

import pytest

from port_bench.harness.spec import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "magicdance_tpu"}
SOURCES = sorted(BENCH_DIR.rglob("*.py"))


def imported_roots(path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax_anywhere(path):
    assert not imported_roots(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent_of_the_program(path):
    assert "magicdance_tpu_torch" not in imported_roots(path)
    assert imported_roots(path) <= {"__future__", "contextlib", "math", "typing", "numpy",
                                    "torch", "port_bench"}


def test_the_guard_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom magicdance_tpu.models import unet\n")
    good = tmp_path / "good.py"
    good.write_text("import magicdance_tpu_torch\n")
    assert imported_roots(bad) & FORBIDDEN == {"jax", "magicdance_tpu"}
    assert not imported_roots(good) & FORBIDDEN
