"""The harness on the CPU at small sizes: the idle share from a synthetic
timeline, the tail's definition and the drain, the import check, a cell,
a mix, a metric and a model family picked up from new files alone, the
check's whole batches where a family's rows depend on each other, and
``correct`` failing when the timed path is broken."""
import ast
import json
import shutil
import time
import types
from pathlib import Path

import pytest
import torch

from benchlib import check, harness, imports, smoke, trace
from benchlib import spec as spec_mod
from benchlib.spec import BENCH, ROOT, Spec

CPU = torch.device("cpu")


def ev(name, start, end, device="CPU", parent=None):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(name=name, device_type=getattr(DeviceType, device),
                                 time_range=types.SimpleNamespace(start=start, end=end),
                                 cpu_parent=parent)


def test_idle_share_from_a_synthetic_timeline():
    batch = ev("bench.batch", 0, 100)
    pre = ev("bench.prefill", 0, 40, parent=batch)
    dec = ev("bench.decode", 50, 100, parent=batch)
    events = [batch, pre, dec,
              ev("aten::mm", 5, 30, parent=pre), ev("aten::add", 60, 95, parent=dec),
              ev("gemm", 10, 30, "CUDA"), ev("gemm", 20, 35, "CUDA"),   # overlap: 10-35
              ev("copy", 70, 80, "CUDA"), ev("bench.decode", 50, 100, "CUDA"),
              ev("late", 120, 130, "CUDA")]                           # outside the slice
    out = trace.reduce(events)
    assert (out["window_us"], out["busy_us"]) == (100, 35)
    assert out["by_name"] == {"gemm": 35, "copy": 10}
    # gaps: 0-10 (prefill, mm), 35-70 (mid 52.5: decode, python), 80-100 (decode, add)
    assert out["gaps"] == {"prefill: aten::mm": 10, "decode: python": 35, "decode: aten::add": 20}
    assert trace.reduce([batch]) is None


def test_import_check_compares_whole_names():
    assert imports.forbidden(["repro_torch.models", "numpy", "reproducible"]) == []
    assert imports.forbidden(["repro.core.worker", "jax.numpy", "flax"]) == ["flax", "jax", "repro"]


def _imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_bench_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        names = set(_imported(path))
        assert not names & imports.FORBIDDEN, path
        if "reference" in path.parts:
            assert "repro_torch" not in names and "benchlib" not in names, path


def _run(cell, family, mixname, seconds=2.0, trace_on=False, on_engine=None, limit=0.05,
         spec=None, mix=None, keep=None):
    return harness.run_cell(spec or Spec(), cell, 2**31 + 21, seconds, trace_on, CPU,
                            time.perf_counter(), conf=smoke.config(family),
                            mix=mix or smoke.mix(mixname), on_engine=on_engine,
                            settings=smoke.settings(limit), keep=keep)


CHAT, LONG = "zamba2-1.2b.chat-every-batch", "zamba2-1.2b.longprompt"


@pytest.mark.parametrize("cell,family,mixname", [
    (CHAT, "hybrid", "chat"), (LONG, "hybrid", "longprompt")])
def test_tail_counts_requests_due_in_the_window_and_drains(cell, family, mixname):
    keep = {}
    res = _run(cell, family, mixname, keep=keep)
    run = keep["run"]
    counted = run.counted()
    assert res["correct"] and res["failed"] == 0 and res["attempted"] == len(counted) > 0
    assert all(run.t_open <= r.due < run.t_close and r.done is not None for r in counted)
    # the client went on past the close, so the last counted batch filled
    assert any(r.due >= run.t_close for r in run.requests.values())
    assert all(r.done >= r.due for r in counted)
    lat = sorted((r.done - r.due) * 1e3 for r in counted)
    # an end-to-end metric's quantity is its name up to the first dot
    p95 = [v["value"] for k, v in res["metrics"].items() if k.split(".")[0] == "request_p95_ms"]
    assert len(p95) == 1 and lat[0] <= p95[0] <= lat[-1]
    assert set(res["metrics"]) == {m["name"] for m in Spec().end_to_end(cell)}
    if "tokens_per_s" in res["metrics"]:
        done = [r for r in run.requests.values() if r.done and r.done <= run.t_close]
        want = sum(r.prompt_len + len(r.tokens) for r in done) / run.seconds
        assert res["metrics"]["tokens_per_s"]["value"] == pytest.approx(want)
    assert list(res)[-1] == "compared"


@pytest.mark.parametrize("cell,mixname,want", [
    (CHAT, "chat", {"fire_lag_ms.chat", "decode_step_ms.chat", "step_mfu.chat"}),
    (LONG, "longprompt", {"fire_lag_ms.longprompt", "prefill_us_per_token.longprompt",
                          "step_mfu.longprompt"})])
def test_traced_run_reports_the_cells_per_layer_metrics_it_can_read(cell, mixname, want):
    res = _run(cell, "hybrid", mixname, trace_on=True)
    # on the CPU nothing runs on a device: the readers of the device trace
    # find nothing and their metrics are left out of the line
    assert set(res["metrics"]) == want
    assert res["correct"]


def _state_unchanged(eng):
    real = eng.model.decode

    def decode(cache, batch):
        logits, new = real(cache, batch)
        return logits, {**new, "ssm": cache["ssm"], "conv": cache["conv"]}

    eng.model.decode = decode


def _token_altered(eng):
    real = eng.generate_batch

    def generate_batch(requests):
        out = real(requests)
        for o in out:
            o["tokens"][-1] = (o["tokens"][-1] + 1) % eng.cfg.vocab
        return out

    eng.generate_batch = generate_batch


@pytest.mark.parametrize("fault,cell,family,mixname", [
    (_state_unchanged, CHAT, "hybrid", "chat"),
    (_token_altered, CHAT, "hybrid", "chat"),
    (_state_unchanged, LONG, "hybrid", "longprompt"),
    (_token_altered, LONG, "hybrid", "longprompt")])
def test_a_broken_timed_path_is_not_correct(fault, cell, family, mixname):
    # at this size sound runs read gaps of 0.006-0.03, these faults 2-4
    mix = smoke.mix(mixname, check_tokens=48)
    assert _run(cell, family, mixname, mix=mix, limit=0.5)["correct"]
    res = _run(cell, family, mixname, mix=mix, on_engine=fault, limit=0.5)
    assert not res["correct"]
    assert res["compared"]["served_logit_gap_max"]["value"] > 0.5


def test_new_config_mix_and_metric_from_new_files_alone(tmp_path):
    bench = tmp_path / "bench"
    for sub in ("configs", "mixes", "metrics", "cells", "families", "reference"):
        shutil.copytree(BENCH / sub, bench / sub, ignore=shutil.ignore_patterns("__pycache__"))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    # a new configuration, mix and per-layer metric: new files and entries
    (bench / "configs" / "zamba2-tiny.json").write_text(json.dumps(smoke.config("hybrid")))
    (bench / "mixes" / "tiny.json").write_text(json.dumps(smoke.mix("chat", rate_per_s=30.0)))
    (bench / "cells" / "zamba2-tiny.tiny.json").write_text(json.dumps(smoke.settings(0.05)))
    (bench / "metrics" / "batches_formed.tiny.py").write_text(
        "def read(run):\n    return float(len(run.window_batches()))\n")
    data["configs"].append({"name": "zamba2-tiny", "source": "test", "reduced": [],
                            "file": "bench/configs/zamba2-tiny.json", "why": "test"})
    data["workloads"].append({"name": "zamba2-tiny.tiny", "config": "zamba2-tiny",
                              "traffic": "tiny", "chips": 1, "why": "test"})
    data["per_layer"].append({"name": "batches_formed.tiny", "unit": "batches",
                              "better": "higher", "source": "program_counter",
                              "layer": "runtime", "moves": "request_p95_ms",
                              "workloads": ["zamba2-tiny.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    spec = Spec(tmp_path)
    res = harness.run_cell(spec, "zamba2-tiny.tiny", 5, 2.0, True, CPU, time.perf_counter())
    assert res["correct"]
    assert res["metrics"]["batches_formed.tiny"]["value"] > 0
    assert "decode_step_ms.chat" not in res["metrics"]


FAMILY = "toyhybrid"        # a family that no file of bench/ names


def test_new_family_from_new_files_alone(tmp_path):
    """A family is two new files, ``families/<family>.py`` and
    ``reference/<family>.py``, found under the Spec's own bench directory;
    this one serves the hybrid's model and takes its rows as dependent, so
    the check computes whole batches."""
    assert not [p for p in BENCH.rglob("*") if FAMILY in p.name]
    bench = tmp_path / "bench"
    for sub in ("configs", "mixes", "metrics", "cells", "families", "reference"):
        (bench / sub).mkdir(parents=True)
    (bench / "families" / f"{FAMILY}.py").write_text(
        "from families.hybrid import (SMOKE, decode_flops, kernel_calls, model_config,  # noqa\n"
        "                             prefill_flops, rule)\n"
        "ROWS_INDEPENDENT = False\n")
    (bench / "reference" / f"{FAMILY}.py").write_text(
        "from reference.hybrid import logits  # noqa\n")
    conf = dict(smoke.config("hybrid"), name="toy-tiny", family=FAMILY)
    (bench / "configs" / "toy-tiny.json").write_text(json.dumps(conf))
    (bench / "mixes" / "tiny.json").write_text(json.dumps(smoke.mix("chat", rate_per_s=30.0)))
    (bench / "cells" / "toy-tiny.tiny.json").write_text(json.dumps(smoke.settings(0.05)))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "toy-tiny", "source": "test", "reduced": [],
                            "file": "bench/configs/toy-tiny.json", "why": "test"})
    data["workloads"].append({"name": "toy-tiny.tiny", "config": "toy-tiny",
                              "traffic": "tiny", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    spec = Spec(tmp_path)
    keep = {}
    res = harness.run_cell(spec, "toy-tiny.tiny", 2**31 + 45, 2.0, False, CPU,
                           time.perf_counter(), keep=keep)
    assert res["correct"] and res["info"]["compared_tokens"] > 0
    fam = spec_mod.family(keep["run"].conf)
    assert not fam.ROWS_INDEPENDENT and Path(fam.__file__).parent == bench / "families"
    assert Path(spec_mod.reference(keep["run"].conf).__file__).parent == bench / "reference"


@pytest.mark.parametrize("independent", [True, False])
def test_the_check_computes_whole_batches_where_rows_depend(tmp_path, independent):
    """A stub reference records the rows it is given: the sampled rows
    alone where the family's rows are independent, else every row of the
    batch in its order; either way only the sampled rows are compared."""
    bench = tmp_path / "bench"
    for sub in ("families", "reference"):
        (bench / sub).mkdir(parents=True)
    (bench / "families" / "stubrows.py").write_text(f"ROWS_INDEPENDENT = {independent}\n")
    (bench / "reference" / "stubrows.py").write_text(
        "import torch\n"
        "CALLS = []\n"
        "def logits(w, conf, tokens, S, positions, prec):\n"
        "    CALLS.append((tokens.tolist(), S, list(positions), prec))\n"
        "    best = torch.zeros(tokens.shape[0], len(positions), dtype=torch.long)\n"
        "    return torch.nn.functional.one_hot(best, conf['vocab_size']).float()\n")
    conf = Spec(ROOT, bench=bench).bind({"family": "stubrows", "vocab_size": 8})
    lengths = [5, 9, 7, 4, 6, 3]
    run = _synthetic_batches(2, 3, lengths)
    run.conf = conf
    for r in run.requests.values():
        r.tokens = [0, 0]
    run.requests["r4"].tokens = [1, 1]      # batch 1's middle row, not sampled
    traffic = types.SimpleNamespace(prompt=lambda i: list(range(1, lengths[i] + 1)))
    b = run.batches[1]
    g, g8, agree = check.gaps(run, {}, conf, [(b, [0, 2])], traffic, True, CPU)
    calls = spec_mod.reference(conf).CALLS
    assert [c[3] for c in calls] == ["fp32", "fp8"]
    rows = [0, 2] if independent else [0, 1, 2]
    want = [[0] * (b.S - lengths[3 + row]) + list(range(1, lengths[3 + row] + 1))
            + run.requests[b.ids[row]].tokens[:-1] for row in rows]
    assert all(c[:3] == (want, b.S, [b.S - 1, b.S]) for c in calls)
    # the middle row's tokens would read a gap of 1: it is computed, not compared
    assert g.tolist() == [0.0] * 4 and g8.tolist() == [0.0] * 4 and agree.all()


def _synthetic_batches(n_batches, rows, lengths):
    run = harness.Run(smoke.config(), {}, 1.0)
    run.t_open, run.t_close = 0.0, 1.0
    k = 0
    for b in range(n_batches):
        ids = []
        for _ in range(rows):
            # the last batch's rows are due after the close
            r = harness.Request(f"r{k}", k, lengths[k], None, 0.5 if b < n_batches - 1 else 2.0)
            r.done, r.tokens = 3.0, [1, 2]
            run.requests[r.id] = r
            ids.append(r.id)
            k += 1
        batch = harness.Batch(b, ids, max(lengths[k - rows:k]), 0.5)
        batch.t1 = 1.0
        run.batches.append(batch)
    return run


@pytest.mark.parametrize("whole", [False, True])
def test_the_sample_holds_the_longest_and_enough_tokens(whole):
    lengths = [5, 9, 7, 40, 3, 8, 6, 2, 11, 12, 13, 90]       # 90: due after the close
    run = _synthetic_batches(4, 3, lengths)
    mix = {"max_new_tokens": 2, "check_tokens": 8, "check_whole_batches": whole}
    picked = check.sample(run, mix, run.conf, 7)
    rows = [(b.index, row) for b, rs in picked for row in rs]
    assert (1, 0) in rows                                     # the longest counted prompt
    assert all(run.requests[run.batches[b].ids[r]].due < 1.0 for b, r in rows)
    assert 2 * len(rows) >= 8 and len(set(rows)) == len(rows)
    if whole:
        assert picked[0][0].index == 1
        assert all(len(rs) == 3 for _, rs in picked)
    else:
        assert len(rows) == 4
    assert check.sample(run, mix, run.conf, 7) == picked        # drawn from the key
