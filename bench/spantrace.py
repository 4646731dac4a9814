"""The program's serving spans in traced runs of a cell, on the card.

    python3 bench/spantrace.py --workload <cell> --seeds a,b,c [--seconds 30]

Each seed is one traced run of the cell, as ``run.py --trace 1`` makes it,
whose engine is also given a ``Tracer`` that samples every request, so the
port records its ``serve.request``, ``serve.batch``, ``serve.prefill`` and
``serve.decode`` spans (``serving/engine.py``).  Prints one JSON line a
seed: the readings of ``benchlib/spans.py`` beside the harness's per-layer
metrics, the engine's counters, and two checks of the spans against the
harness's own clocks:

- ``clock``: each ``bench.prefill`` and ``bench.decode`` range of the kept
  profile against the program's span around it, both on the profile's
  timeline: how far (µs) the range starts after its span starts
  (``start_in``) and ends before it ends (``end_in``); ``out_max`` is the
  farthest any range reaches outside its span;
- ``receipt``: each counted request's ``serve.request`` end against the
  client's receipt of its done event (the harness's wrapper on the event
  store's ``publish``), µs.

The benchmark's own runs never run this.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
RANGES = ("bench.prefill", "bench.decode")


def _summary(values):
    if not values:
        return None
    return {"n": len(values), "median": statistics.median(values), "min": min(values),
            "max": max(values)}


def clock(run, ranges) -> dict:
    """The kept profile's ``bench.*`` ranges against the program's spans."""
    from benchlib import spans

    start_in, end_in = [], []
    for name in ("prefill", "decode"):
        calls = spans.profiled_calls(run, "serve." + name) or []
        found = sorted((s, t) for n, s, t in ranges if n == "bench." + name)
        if len(calls) != len(found):
            return {"matched": False, "spans": len(calls), "ranges": len(found)}
        for (s0, s1), (r0, r1) in zip(calls, found):
            start_in.append(r0 - s0)
            end_in.append(s1 - r1)
    if not start_in:
        return {"matched": False, "spans": 0, "ranges": 0}
    return {"matched": True, "start_in": _summary(start_in), "end_in": _summary(end_in),
            "out_max": max(0.0, -min(start_in + end_in))}


def receipt(run, wall_minus_perf: float):
    """Counted requests: the client's receipt of the done event less the end
    of the request span, µs (the span's ``ts`` is ``time.time()``, the
    harness stamps ``time.perf_counter()``)."""
    from benchlib import spans

    idx = spans.Index(run)
    gaps = [(r.done - (spans.end(idx.requests[r.id]) - wall_minus_perf)) * 1e6
            for r in run.counted() if r.done is not None and r.id in idx.requests]
    return _summary(gaps)


def traced_run(spec, cell: str, seed: int, seconds: float, device, t_process: float,
               **kw) -> dict:
    """One traced run of ``cell`` with the program's spans → its line.

    Stands in for a tracer hook in the harness, so it leans on the
    harness's internals for the run's length: ``Recorder._maybe_stop`` and
    ``Recorder.profile`` (the kept profile, for its ``trace_start_ns``),
    and ``harness.trace_mod.reduce`` (the profile's events, for the
    ``bench.*`` ranges).  Once the harness gives the engine a tracer
    itself, this tool and its test go."""
    from torch.autograd import DeviceType

    from benchlib import harness, spans
    from repro_torch.obs.trace import SpanCollector, Tracer

    tracer = Tracer(sample=1.0, collector=SpanCollector(capacity=65536))
    counters = {}
    ranges = []

    def on_engine(eng):
        eng.tracer = tracer
        counters["registry"] = eng.metrics

    class Recorder(harness.Recorder):
        """Keeps the kept profile's origin on the run."""

        def __init__(self, run, *args, **kwargs):
            super().__init__(run, *args, **kwargs)
            self.run = run
            run.trace_start_ns = None

        def _maybe_stop(self, b):
            super()._maybe_stop(b)
            if self.profile is not None and self.run.trace_start_ns is None:
                self.run.trace_start_ns = self.profile.profiler.kineto_results.trace_start_ns()

    real_reduce, real_recorder = harness.trace_mod.reduce, harness.Recorder

    def reduce(events):
        ranges[:] = [(e.name, e.time_range.start, e.time_range.end) for e in events
                     if e.device_type == DeviceType.CPU and e.name in RANGES]
        return real_reduce(events)

    keep = {}
    harness.trace_mod.reduce, harness.Recorder = reduce, Recorder
    try:
        res = harness.run_cell(spec, cell, seed, seconds, True, device, t_process,
                               on_engine=on_engine, keep=keep, **kw)
    finally:
        harness.trace_mod.reduce, harness.Recorder = real_reduce, real_recorder
    run = keep["run"]
    run.spans = list(tracer.collector.spans)
    wall_minus_perf = statistics.median(time.time() - time.perf_counter() for _ in range(101))
    read = {
        "queue_wait_ms": spans.queue_wait_ms(run),
        "padding_share": spans.padding_share(run),
        "fire_lag_span_ms": spans.fire_lag_ms(run),
        "decode_step_span_ms": spans.decode_step_ms(run),
        "prefill_span_us_per_token": spans.prefill_us_per_token(run),
        "decode_idle_share": spans.idle_share(run, "serve.decode"),
        "prefill_idle_share": spans.idle_share(run, "serve.prefill"),
    }
    return {"workload": cell, "seed": seed, "correct": res["correct"],
            "device": res["device"].get("kind"), "spans": read,
            "harness": {k: v["value"] for k, v in res["metrics"].items()},
            "counters": counters["registry"].snapshot()["counters"],
            "clock": clock(run, ranges), "receipt": receipt(run, wall_minus_perf),
            "n_spans": len(run.spans), "batches": res["info"]["batches"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args()
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(ROOT / "build" / "bench-cache" / sub)
    sys.path[:0] = [str(ROOT / "src"), str(BENCH)]
    import torch

    from benchlib.spec import Spec

    if not torch.cuda.is_available():
        print("spantrace: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _cuda

    _cuda.build()
    torch.cuda.set_device(0)
    spec = Spec(ROOT)
    for seed in [int(s) for s in args.seeds.split(",")]:
        line = traced_run(spec, args.workload, seed, args.seconds, "cuda:0",
                          time.perf_counter())
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
