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
- The cells of the xlstm, vlm, moe and mla_moe families that the dry-run
  once could not shard (ROADMAP.md §3) end ``status: "ok"`` at 2 layers,
  in a process of their own, with the FSDP all-gathers in their graphs;
  on the 2 × 16 × 16 mesh, zamba2 × long_500k and deepseek-v2 × train_4k
  (its dense layer 0) end ``status: "ok"`` too.
- ``slstm_steps`` and the sLSTM scan's step extrapolation: exact on a
  2-layer xlstm train step at a sequence of 64, against the trace that
  takes every step.
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


# the four families the dry-run once could not shard (ROADMAP.md §3, closed)
FAMILY_CELLS = [("xlstm-1.3b", "train_4k"), ("xlstm-1.3b", "decode_32k"),
                ("qwen2-vl-72b", "train_4k"),
                ("phi3.5-moe-42b-a6.6b", "train_4k"), ("phi3.5-moe-42b-a6.6b", "decode_32k"),
                ("deepseek-v2-236b", "train_4k"), ("deepseek-v2-236b", "decode_32k")]
# and, on the multi-pod mesh, the cells whose products DTensor could not
# propagate there: a Mamba2 decode (its state einsums; batch 1, which
# nothing splits) and MLA's projections (the backward of x @ wdkv), at
# (arch, shape, layers): deepseek-v2's layer 0, dense, holds its MLA
MULTI_POD_CELLS = [("zamba2-1.2b", "long_500k", 2), ("deepseek-v2-236b", "train_4k", 1)]

_CELLS = r"""
import json, sys
from repro_torch.launch import dryrun
cells, multi = json.loads(sys.argv[1]), sys.argv[2] == "multi"
print(json.dumps([dryrun.dryrun_cell(a, s, multi_pod=multi, config_patch={"n_layers": n})
                  for a, s, n in cells]))
"""


@pytest.fixture(scope="module")
def family_cells():
    """Every cell of ``FAMILY_CELLS`` at 2 layers, in one process of their
    own, and of ``MULTI_POD_CELLS`` in another → {(arch, shape): result},
    the multi-pod ones under (arch, shape, "multi")."""
    runs = [(cells, mesh, subprocess.Popen(
        [sys.executable, "-c", _CELLS, json.dumps(cells), mesh], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=dict(os.environ, PYTHONPATH=SRC)))
        for cells, mesh in (([(a, s, 2) for a, s in FAMILY_CELLS], "single"),
                            (MULTI_POD_CELLS, "multi"))]      # the two in parallel
    results = {}
    for cells, mesh, proc in runs:
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        for (a, s, _), res in zip(cells, json.loads(out.strip().splitlines()[-1])):
            results[(a, s) if mesh == "single" else (a, s, mesh)] = res
    return results


@pytest.mark.parametrize("arch,shape", FAMILY_CELLS)
def test_family_cell_traces_sharded(family_cells, arch, shape):
    """The cells whose ops once had no DTensor strategy (xlstm's
    log_sigmoid, vlm's patch scatter, the MoE's bincount) trace sharded on
    256 ranks at 2 layers, with the FSDP all-gathers in the graph; xlstm's
    train cell costs its sLSTM scan at all 4096 steps from traces of 1 and
    2 (``slstm_steps_extrapolated``), its decode cell takes one step."""
    res = family_cells[arch, shape]
    assert res["status"] == "ok", res
    assert res["n_devices"] == 256 and res["n_layers"] == 2
    assert res["kind"] == SHAPES[shape]["kind"]
    assert res["collectives"]["count_all-gather"] > 0
    assert res["collectives"]["bytes_total"] > 0
    mem = res["memory"]
    assert mem["peak_est_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                     + mem["temp_bytes"])
    assert 0 < res["useful_flops_ratio"] < 1.0, res["useful_flops_ratio"]
    steps = SHAPES[shape]["seq"] if (arch, shape) == ("xlstm-1.3b", "train_4k") else None
    assert res.get("slstm_steps_extrapolated") == steps


@pytest.mark.parametrize("arch,shape,layers", MULTI_POD_CELLS)
def test_multi_pod_cell_traces(family_cells, arch, shape, layers):
    """zamba2's long-context decode (batch 1) and deepseek-v2's MLA train
    step trace on the 2 × 16 × 16 mesh: the Mamba2 decode's state products
    and MLA's projections go through the mesh-aware einsum."""
    res = family_cells[arch, shape, "multi"]
    assert res["status"] == "ok", res
    assert res["n_devices"] == 512 and res["multi_pod"] and res["n_layers"] == layers
    assert res["kind"] == SHAPES[shape]["kind"]
    assert res["collectives"]["bytes_total"] > 0


_STEPS = r"""
import json
from repro_torch.configs import SHAPES
from repro_torch.launch import dryrun
SHAPES["train_4k"] = dict(SHAPES["train_4k"], seq=64)
patch = {"n_layers": 2}
got = dryrun.dryrun_cell("xlstm-1.3b", "train_4k", config_patch=patch)
dryrun.slstm_steps = lambda cfg, shape: 0
full = dryrun.dryrun_cell("xlstm-1.3b", "train_4k", config_patch=patch)
print(json.dumps([got, full]))
"""


def test_slstm_steps_extrapolate_exactly():
    """The sLSTM scan traced at 1 and 2 steps, extrapolated to a sequence
    of 64, against the trace that takes all 64: the same FLOPs, bytes,
    collectives and memory (each step adds the same ops)."""
    cfg = get_config("xlstm-1.3b")
    assert dryrun.slstm_steps(cfg, "train_4k") == 4096
    assert dryrun.slstm_steps(cfg, "prefill_32k") == 32768
    assert dryrun.slstm_steps(cfg, "decode_32k") == 0
    assert dryrun.slstm_steps(get_config("zamba2-1.2b"), "train_4k") == 0
    out = subprocess.run([sys.executable, "-c", _STEPS], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=SRC), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got, full = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["status"] == full["status"] == "ok"
    assert got["slstm_steps_extrapolated"] == 64 and "slstm_steps_extrapolated" not in full
    for key in ("flops_per_device", "bytes_per_device", "collective_bytes_per_device"):
        assert got["roofline"][key] == pytest.approx(full["roofline"][key], rel=1e-9), key
    assert got["memory"] == full["memory"]
