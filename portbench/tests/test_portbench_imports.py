"""What the benchmark's modules import: never JAX nor the JAX package
(top-level names compared whole: ``repro_torch`` is not ``repro``), and
the reference nothing of the program."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_nor_the_jax_package(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & {"repro_torch", "portbench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.level == 1 and node.module in (None, "dense_lm")


def test_nothing_reads_the_jax_benchmarks():
    for path in SOURCES:
        assert "benchmarks" not in _imports(path)
        assert "BENCH_" not in path.read_text()


def test_run_refuses_jax_by_whole_names(monkeypatch):
    import sys
    from portbench import run
    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.sub", sys)
    assert "repro" in run.forbidden_modules()
