"""The benchmark's data, found by name.

``BENCHMARK.json`` at the root of the checkout names the cells, the
configurations and the metrics.  Everything that belongs to one of them
sits in a file of its own, which the harness finds by that name:

- a configuration: the file its entry names (``bench/configs/<name>.json``),
- a traffic mix: ``bench/mixes/<traffic>.json``,
- a cell's own settings: ``bench/cells/<cell>.json``, the ``limits`` of the
  numbers its correctness check compares (each read at the cell's own load)
  and the runtime's ``commit_policy`` where the cell's deployment sets one,
- a per-layer metric's reader: ``bench/metrics/<metric>.py``, a module
  with ``read(run) -> float | None``.

So a later change adds a cell, a mix or a metric as new files and new
entries, and edits none that are here.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


class Spec:
    def __init__(self, root: Path = ROOT, bench: Path = None):
        self.root = Path(root)
        self.bench = Path(bench) if bench is not None else self.root / "bench"
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self._readers: Dict[str, object] = {}

    def cell(self, name: str) -> dict:
        for c in self.data["workloads"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{[c['name'] for c in self.data['workloads']]}")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                conf = json.loads((self.root / c["file"]).read_text())
                conf.setdefault("name", name)
                return conf
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def settings(self, cell: str) -> dict:
        return json.loads((self.bench / "cells" / f"{cell}.json").read_text())

    def mix(self, traffic: str) -> dict:
        mix = json.loads((self.bench / "mixes" / f"{traffic}.json").read_text())
        mix.setdefault("name", traffic)
        return mix

    @staticmethod
    def _applies(metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.data["end_to_end"] if self._applies(m, cell)]

    def per_layer(self, cell: str) -> List[dict]:
        return [m for m in self.data["per_layer"] if self._applies(m, cell)]

    def reader(self, metric: str):
        """The module ``bench/metrics/<metric>.py``, loaded by path (a
        metric's name may hold dots)."""
        mod = self._readers.get(metric)
        if mod is None:
            path = self.bench / "metrics" / f"{metric}.py"
            spec = importlib.util.spec_from_file_location(
                "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._readers[metric] = mod
        return mod
