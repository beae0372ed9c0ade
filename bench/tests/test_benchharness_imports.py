"""Nothing the harness runs imports JAX or the JAX package ``repro``; the
reference imports nothing of the program either. Top-level module names
are compared whole: ``repro_torch`` is not ``repro``."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


SOURCES = sorted(p for p in BENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert _imports(path) <= {"__future__", "math", "numpy", "torch"}, \
            path


def test_nothing_reads_the_old_benchmarks_folder():
    for path in SOURCES:
        assert "benchmarks" not in _imports(path), path
        if path != Path(__file__).resolve():
            assert "benchmarks/" not in path.read_text(), path
