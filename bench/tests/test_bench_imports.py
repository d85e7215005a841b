"""Nothing under ``bench/`` imports JAX or the JAX package, compared by whole
top-level names (``repro_torch`` begins with ``repro``), and the reference
imports nothing of the port either."""
import ast
import pathlib

import pytest

from bench_cells import ROOT

BENCH = pathlib.Path(ROOT) / "bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _top(name):
    return name.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=str)
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not {_top(n) for n in _imports(path)} & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")), ids=str)
def test_the_reference_imports_nothing_of_the_port(path):
    names = set(_imports(path))
    assert "repro_torch" not in {_top(n) for n in names}
    # within the benchmark, only the weights and the stream
    assert {n for n in names if _top(n) == "bench"} <= {"bench"}


def test_whole_names_tell_the_port_from_the_jax_package():
    import sys
    sys.path.insert(0, str(BENCH))
    import run
    assert _top("repro_torch.core") not in run.FORBIDDEN
    assert _top("repro.core") in run.FORBIDDEN
