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
  with ``read(run) -> float | None``,
- a model family (a configuration's ``family``): ``bench/families/<family>.py``,
  what the harness needs to know of the port's models of that family, and
  ``bench/reference/<family>.py``, the plain reference that judges them.

So a later change adds a family, a configuration, a cell, a mix or a
metric as new files and new entries, and edits none that are here.
"""
from __future__ import annotations

import hashlib
import importlib
import importlib.machinery
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load(bench, kind: str, name: str):
    """``<bench>/<kind>/<name>.py``, imported as a module of a package made
    for the directory ``<bench>/<kind>`` and named after its path (so its
    relative imports find the files beside it), once a process."""
    directory = (Path(bench) / kind).resolve()
    package = f"_bench_{kind}_{hashlib.sha1(str(directory).encode()).hexdigest()[:12]}"
    if package not in sys.modules:
        made = importlib.machinery.ModuleSpec(package, None, is_package=True)
        made.submodule_search_locations = [str(directory)]
        sys.modules[package] = importlib.util.module_from_spec(made)
    return importlib.import_module(f"{package}.{name}")


def family(conf: dict):
    """``families/<family>.py`` of the configuration's family, from the
    bench directory of the ``Spec`` that runs it (``Spec.bind``), else this
    one: ``model_config``, ``rule``, ``kernel_calls``, ``prefill_flops``,
    ``decode_flops``, ``SMOKE`` and ``ROWS_INDEPENDENT``."""
    return load(conf.get("_bench", BENCH), "families", conf["family"])


def reference(conf: dict):
    """``reference/<family>.py`` of the configuration's family, found as
    ``family`` finds its module: the plain model, ``logits(...)``."""
    return load(conf.get("_bench", BENCH), "reference", conf["family"])


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

    def bind(self, conf: dict) -> dict:
        """``conf`` whose family's modules come from this Spec's bench
        directory (under ``_bench``, which ``family`` and ``reference`` read)."""
        return {**conf, "_bench": str(self.bench)}

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
