"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is ``configs/<config>.json``, a traffic mix
``traffic/<traffic>.json`` (its ``kind`` names the module that runs it,
``<kind>.py``), a metric's reader ``metrics/<metric>.py``, a cell's limits
``limits/<workload>.json``. Adding any of them takes new files and new
entries only.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parent


def load(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, base: Path = HERE) -> dict:
    return json.loads((base / "traffic" / f"{name}.json").read_text())


def runner(mix: dict) -> ModuleType:
    """The module that runs a mix of this kind: ``perfbench/<kind>.py``."""
    return importlib.import_module(f"perfbench.{mix['kind']}")


def metrics_for(bench: dict, wl: str, trace: bool) -> List[dict]:
    """The metrics a run of ``wl`` reports: its end-to-end ones without the
    trace, its per-layer ones with it."""
    pool = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in pool if "workloads" not in m or wl in m["workloads"]]


def reader(name: str, base: Path = HERE) -> ModuleType:
    """The reader of metric ``name``: ``metrics/<name>.py``, whose
    ``read(run)`` returns the number or None when it finds nothing to read."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
