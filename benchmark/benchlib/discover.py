"""Finding a cell's pieces by name, so that a cell, a configuration, a
traffic mix or a metric is added as files and ``BENCHMARK.json`` entries
with no edit to code that is there:

- ``BENCHMARK.json`` at the checkout's root names the cell, its
  configuration (and the configuration's file), its traffic and the
  metrics it reports;
- ``cells/<cell>.json``: the kind of traffic code that runs it
  (``kinds/<kind>.py``), the end-to-end metric's form and the limits of the
  correctness check;
- ``traffic/<traffic>.json``: the mix's parameters, read by the kind;
- ``metrics/<metric>.py``: one reader per per-layer metric, ``read(ctx)``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import the Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise ImportError(f"cannot import {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """Everything one workload of ``BENCHMARK.json`` needs, found by name
    under ``bench_dir`` (the benchmark's folder; its parent holds
    ``BENCHMARK.json``)."""

    def __init__(self, workload: str, bench_dir: str = BENCH_DIR):
        self.bench_dir = bench_dir
        root = os.path.dirname(bench_dir)
        self.spec = _load_json(os.path.join(root, "BENCHMARK.json"))
        by_name = {w["name"]: w for w in self.spec["workloads"]}
        if workload not in by_name:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(there are {sorted(by_name)})")
        self.name = workload
        self.workload = by_name[workload]
        self.chips = int(self.workload["chips"])
        cfg = {c["name"]: c for c in self.spec["configs"]}[self.workload["config"]]
        self.config = _load_json(os.path.join(root, cfg["file"]))
        self.traffic = _load_json(os.path.join(bench_dir, "traffic",
                                               self.workload["traffic"] + ".json"))
        self.cell = _load_json(os.path.join(bench_dir, "cells", workload + ".json"))
        self.kind = load_module(os.path.join(bench_dir, "kinds", self.cell["kind"] + ".py"),
                                "bench_kind_" + re.sub(r"\W", "_", self.cell["kind"]))

    def _applies(self, metric) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    @property
    def end_to_end(self):
        """The end-to-end metrics this cell reports, in ``BENCHMARK.json``'s
        order."""
        return [m for m in self.spec["end_to_end"] if self._applies(m)]

    @property
    def per_layer(self):
        """The per-layer metrics this cell reports: those that list it, and
        those that list no cells and move an end-to-end metric it reports."""
        mine = {m["name"] for m in self.end_to_end}
        return [m for m in self.spec["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in mine)]

    def reader(self, metric_name: str):
        """The ``read(ctx)`` of ``metrics/<metric_name>.py``."""
        path = os.path.join(self.bench_dir, "metrics", metric_name + ".py")
        return load_module(path, "bench_metric_" + re.sub(r"\W", "_", metric_name)).read
