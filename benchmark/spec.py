"""What one cell is, read from ``BENCHMARK.json`` and the files it names.

A cell (a ``workloads`` entry) names a configuration and a traffic mix;
each is found by name: the configuration's ``file``, the mix at
``benchmark/traffic/<traffic>.json``, the cell's correctness limits at
``benchmark/limits/<workload>.json``, each per-layer metric's reader at
``benchmark/metrics/<name>.py``. Adding a cell, a configuration, a mix or
a metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic,
    limits and metrics resolved."""

    def __init__(self, name: str, bench: dict = None):
        bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(ROOT / self.config_entry["file"])
        self.traffic = load_json(BENCH_DIR / "traffic" / (self.entry["traffic"] + ".json"))
        self.limits = load_json(BENCH_DIR / "limits" / (name + ".json"))
        self.chips = self.entry["chips"]
        self.end_to_end = [m for m in bench["end_to_end"] if reports(m, name)]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if m["moves"] in moved and reports(m, name)]


def reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric_name: str):
    """The ``read(ctx)`` of ``benchmark/metrics/<metric_name>.py``."""
    path = BENCH_DIR / "metrics" / (metric_name + ".py")
    return load_module(path, "benchmark_metric_" + metric_name.replace(".", "_")).read


def family(config: dict):
    """The module that builds and references a configuration's model
    family: ``benchmark/families/<family>.py``."""
    return importlib.import_module("benchmark.families." + config["family"])
