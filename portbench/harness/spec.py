"""The benchmark's data files, found by the names in ``BENCHMARK.json``.

A cell names a configuration (``configs/<name>.json`` through the
entry's ``file``) and a traffic mix (``traffic/<mix>.json``); a metric's
reader is ``metrics/<metric name>.py``. Nothing here names a cell,
configuration, mix or metric: a new one is a new file and a new entry.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic
    mix and the metrics it reports."""

    def __init__(self, name: str, bench: dict | None = None):
        bench = bench or benchmark()
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; known: "
                             f"{sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        cfgs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = cfgs[self.entry["config"]]
        self.config = load_json(os.path.join(ROOT,
                                             self.config_entry["file"]))
        self.traffic = load_json(os.path.join(
            BENCH_DIR, "traffic", self.entry["traffic"] + ".json"))
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._has(m)]

    def _has(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]


def metric_reader(name: str):
    """``read(run) -> float | None`` of ``metrics/<name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
