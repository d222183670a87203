"""The benchmark's data, found by name: ``BENCHMARK.json`` at the checkout's
root, and beside this file one JSON per configuration (``configs/``), per
traffic mix (``traffic/``) and per cell (``cells/``), and one reader per
metric (``metrics/<name>.py``, a ``read(ctx)`` that returns a number or
``None``). A new cell, mix or metric is a new file; no file here lists
them."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

__all__ = ["HERE", "ROOT", "benchmark", "Cell", "cell", "metric_reader",
           "metrics_for"]


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    """``BENCHMARK.json`` of the checkout (a missing file raises)."""
    return _load(ROOT / "BENCHMARK.json")


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic
    mix and cell file, each read from its own file."""

    def __init__(self, bench: dict, name: str):
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            known = ", ".join(w["name"] for w in bench["workloads"])
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(known: {known})")
        self.workload = found[0]
        self.name = name
        conf = [c for c in bench["configs"]
                if c["name"] == self.workload["config"]]
        if not conf:
            raise KeyError(f"workload {name!r} names config "
                           f"{self.workload['config']!r}, which "
                           f"BENCHMARK.json does not list")
        self.config = _load(ROOT / conf[0]["file"])
        self.traffic = _load(HERE / "traffic"
                             / f"{self.workload['traffic']}.json")
        self.cell = _load(HERE / "cells" / f"{name}.json")
        self.chips = int(self.workload["chips"])
        self.bench = bench


def cell(name: str) -> Cell:
    return Cell(benchmark(), name)


def metrics_for(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metric entries a run of ``cell_name`` reports: the end-to-end
    ones without ``--trace``, the per-layer ones with it; an entry with a
    ``workloads`` key only in the cells it lists."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or cell_name in m["workloads"]]


def metric_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"pb_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
