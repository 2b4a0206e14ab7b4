"""No module of the benchmark imports JAX, jaxlib, flax or the JAX
package (tpudf), by top-level name compared whole: tpudf_torch is the
port and is allowed, except in reference/, which imports nothing of the
program either."""

import ast
import sys

import pytest

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "tpudf"}


def imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_bench_no_jax_import(path):
    assert not set(imported_tops(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_bench_reference_imports_nothing_of_the_program(path):
    tops = set(imported_tops(path))
    assert "tpudf_torch" not in tops and not tops & FORBIDDEN
    assert tops <= {"__future__", "benchmark", "contextlib", "dataclasses",
                    "math", "numpy", "torch"}


def test_bench_module_check_compares_whole_names(monkeypatch):
    sys.path.insert(0, str(BENCH))
    import run
    monkeypatch.setitem(sys.modules, "tpudf_torch_probe", object())
    assert "tpudf_torch_probe" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpudf.ops", object())
    assert run.forbidden_modules() == ["tpudf"]
