"""The port's dry-run tooling against the reference's, on the CPU.

- ``batch_specs`` and ``cache_specs`` give FakeTensors with the reference's
  shapes and dtypes for every arch × shape (exact).
- ``model_attention_flops`` equals the reference's for every arch × shape,
  and the hill-climb ``CELLS`` keep the reference's cells, variants,
  overrides, patches and step knobs.  The reference's ``launch.dryrun``
  sets ``XLA_FLAGS`` in its first lines, so it is imported only in a
  process of its own.
- ``dryrun_cell("llama3.2-3b", "train_4k")`` at 2 of 28 layers, in a
  process of its own (its fake group of 512 ranks owns that interpreter):
  status ok on 256 ranks, FSDP all-gathers in the graph, and a
  ``useful_flops_ratio`` between 0.1 and 1: above 1 the graph would hold
  fewer FLOPs than the model needs; the port repeats work the model's
  6·N·D does not count (the recompute of remat, attention on 24 heads
  that a 16-way model axis cannot split, so each of its ranks runs every
  head), so the ratio stays under 1.
- ``analyze_cell``'s extrapolation is exact on probe results linear in the
  depth.
- The cells the port cannot shard yet end ``status: "failed"`` with the op
  that lacks a DTensor sharding strategy in ``error`` (ROADMAP.md §3), at 2
  layers, in a process of their own; none runs unsharded.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import specs as jax_specs
from repro.models import unbox
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import dryrun, hillclimb, specs

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _same(fake, sds, what):
    from torch._subclasses.fake_tensor import FakeTensor

    assert isinstance(fake, FakeTensor), what
    assert tuple(fake.shape) == tuple(sds.shape), what
    want = {"int32": torch.int32, "bfloat16": torch.bfloat16,
            "float32": torch.float32}[str(sds.dtype)]
    assert fake.dtype == want, what


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for shape in SHAPES:
        got, want = specs.batch_specs(cfg, shape), jax_specs.batch_specs(jcfg, shape)
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k], (shape, k))
        got = specs.cache_specs(cfg, shape)
        want = unbox(jax_specs.cache_specs(jcfg, shape))
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k], (shape, "cache", k))
        ins = specs.input_specs(cfg, shape)
        assert ins["kind"] == SHAPES[shape]["kind"]
        assert ("cache" in ins) == (ins["kind"] == "decode")


_REFERENCE = r"""
import json
from repro.configs import ARCHS, SHAPES, get_config
from repro.launch import dryrun, hillclimb
print(json.dumps({
    "flops": {f"{a}|{s}": dryrun.model_attention_flops(get_config(a), s)
              for a in ARCHS for s in SHAPES},
    "probe_points": dryrun.PROBE_POINTS,
    "cells": {k: {"arch": c["arch"], "shape": c["shape"],
                  "variants": [[n, o, p, pp, acc] for n, _, o, p, pp, acc in c["variants"]]}
              for k, c in hillclimb.CELLS.items()}}))
"""


@pytest.fixture(scope="module")
def reference():
    out = subprocess.run([sys.executable, "-c", _REFERENCE], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu"),
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_model_attention_flops_match_reference(reference):
    for key, want in reference["flops"].items():
        arch, shape = key.split("|")
        assert dryrun.model_attention_flops(get_config(arch), shape) == want, key
    assert {k: list(v) for k, v in dryrun.PROBE_POINTS.items()} == reference["probe_points"]


def test_hillclimb_cells_match_reference(reference):
    def plain(x):   # tuples → lists, as JSON holds them
        return json.loads(json.dumps(x))

    got = {k: {"arch": c["arch"], "shape": c["shape"],
               "variants": plain([[n, o, p, pp, acc] for n, _, o, p, pp, acc in c["variants"]])}
           for k, c in hillclimb.CELLS.items()}
    assert got == reference["cells"]
    assert hillclimb.HILL_DIR.replace(os.sep, "/").endswith("results/torch/hillclimb")


_CELL = r"""
import json
from repro_torch.launch import dryrun
res = dryrun.dryrun_cell("llama3.2-3b", "train_4k", config_patch={"n_layers": 2})
print(json.dumps(res))
"""


def test_dryrun_cell_traces_a_sharded_train_step():
    out = subprocess.run([sys.executable, "-c", _CELL], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=SRC), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["status"] == "ok", res
    assert res["n_devices"] == 256 and res["kind"] == "train" and res["n_layers"] == 2
    assert res["collectives"]["count_all-gather"] > 0
    assert res["collectives"]["bytes_total"] > 0
    assert 0.1 < res["useful_flops_ratio"] < 1.0, res["useful_flops_ratio"]
    mem = res["memory"]
    assert mem["peak_est_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                     + mem["temp_bytes"])
    assert res["dominant"] in ("t_compute", "t_memory", "t_collective")


def test_analyze_cell_extrapolates_linear_probes_exactly(monkeypatch):
    per_layer = {"flops_per_device": 3e12, "bytes_per_device": 5e9,
                 "collective_bytes_per_device": 7e8}
    fixed = {"flops_per_device": 1e12, "bytes_per_device": 2e9,
             "collective_bytes_per_device": 1e8}

    def fake_cell(arch, shape, multi_pod=False, overrides=None, config_patch=None,
                  accum_steps=1):
        L = (config_patch or {}).get("n_layers", get_config(arch).n_layers)
        roof = {k: fixed[k] + per_layer[k] * L for k in fixed}
        return {"status": "ok", "arch": arch, "shape": shape, "n_devices": 256,
                "model_flops": 1e15, "compile_s": 0.0, "roofline": roof,
                "dominant": "t_compute", "patch": config_patch}

    monkeypatch.setattr(dryrun, "dryrun_cell", fake_cell)
    res = dryrun.analyze_cell("deepseek-67b", "decode_32k")
    L = get_config("deepseek-67b").n_layers
    for k in fixed:
        assert res["roofline"][k] == pytest.approx(fixed[k] + per_layer[k] * L, rel=1e-12)
    assert res["probe_points"] == [2, 4]
    assert res["roofline"]["t_compute"] == pytest.approx(
        res["roofline"]["flops_per_device"] / dryrun.PEAK_FLOPS)
    assert res["useful_flops_ratio"] == pytest.approx(
        1e15 / (res["roofline"]["flops_per_device"] * 256))
    # the probes unroll attention; a failed probe is returned with its depth
    monkeypatch.setattr(dryrun, "dryrun_cell", lambda *a, config_patch=None, **k: (
        {"status": "failed", "error": "x"} if config_patch else fake_cell(*a, **k)))
    assert dryrun.analyze_cell("zamba2-1.2b", "train_4k")["probe_L"] == 14


# (arch, shape) → the op that has no sharding strategy there (ROADMAP.md §3)
UNSHARDABLE = {("xlstm-1.3b", "train_4k"): "log_sigmoid_forward",
               ("qwen2-vl-72b", "train_4k"): "index_put_",
               ("phi3.5-moe-42b-a6.6b", "decode_32k"): "bincount",
               ("deepseek-v2-236b", "train_4k"): "bincount"}

_FAILING = r"""
import json, sys
from repro_torch.launch import dryrun
cells = json.loads(sys.argv[1])
print(json.dumps([dryrun.dryrun_cell(a, s, config_patch={"n_layers": 2}) for a, s in cells]))
"""


def test_unshardable_cells_fail_with_the_op():
    cells = list(UNSHARDABLE)
    out = subprocess.run([sys.executable, "-c", _FAILING, json.dumps(cells)],
                         capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=SRC),
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    results = json.loads(out.stdout.strip().splitlines()[-1])
    for (arch, shape), res in zip(cells, results):
        assert res["status"] == "failed", (arch, shape, res)
        assert UNSHARDABLE[arch, shape] in res["error"], (arch, shape, res["error"][:500])
