"""Finds what ``BENCHMARK.json`` names, each in a file of its own:
``configs/<config>.json`` (through the configuration's ``file``),
``traffic/<mix>.json``, ``limits/<cell>.json``, ``metrics/<metric>.py``,
``drivers/<driver>.py`` (named by the mix) and ``reference/<name>.py``
(named by the configuration)."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(ROOT / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json(BENCH / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    return _json(BENCH / "limits" / f"{cell_name}.json")


def metrics_for(bench: dict, cell_name: str, traced: bool) -> List[dict]:
    """The cell's end-to-end metrics (untraced) or per-layer ones (traced):
    those without a ``workloads`` list, and those whose list names it."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def _file_module(path: Path) -> ModuleType:
    name = f"bench_{path.parent.name}_{path.stem.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str) -> ModuleType:
    return _file_module(BENCH / "metrics" / f"{metric}.py")


def driver(name: str) -> ModuleType:
    return importlib.import_module(f"bench.drivers.{name}")


def reference(name: str) -> ModuleType:
    return importlib.import_module(f"bench.reference.{name}")
