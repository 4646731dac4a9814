"""The readers of the program's serving spans (``benchlib/spans.py``) on
synthetic runs with hand-computed values, the spans' place on the
profile's timeline, and ``spantrace.py``'s traced run of a cell at CPU
size, whose spans agree with the harness's own records."""
import time

import pytest

import spantrace
from benchlib import harness, smoke, spans
from benchlib.spec import Spec

W = 1_792_000_000.0          # a span's ts is time.time()


def span(name, sid, ts, dur, parent=None, **attrs):
    return {"trace": "t", "span": sid, "parent": parent, "name": name, "ts": W + ts,
            "dur": dur, **attrs}


def _run():
    """Four counted requests in two window batches of two, one request due
    after the close; the program's spans of each."""
    run = harness.Run(smoke.config(), {}, 10.0)
    run.t_open, run.t_close = 0.0, 10.0
    for k, due in enumerate((1.0, 2.0, 3.0, 4.2, 12.0)):
        run.requests[f"r{k}"] = harness.Request(f"r{k}", k, 8, None, due)
    for k, (ids, t0) in enumerate(((["r0", "r1"], 2.1), (["r2", "r3"], 4.5))):
        b = harness.Batch(k, ids, 8, t0)
        b.t1 = t0 + 1.0
        run.batches.append(b)
    run.spans = [
        span("serve.request", "q0", 1.0, 3.3, id="r0", batch="b0"),
        span("serve.request", "q1", 2.0, 2.3, id="r1", batch="b0"),
        span("serve.request", "q2", 3.0, 2.5, id="r2", batch="b1"),
        span("serve.request", "q3", 4.2, 1.3, id="r3", batch="b1"),
        span("serve.batch", "b0", 2.1, 2.2, ids=["r0", "r1"]),
        span("serve.batch", "b1", 4.5, 1.0, ids=["r2", "r3"]),
        span("serve.prefill", "p0", 2.2, 0.2, "b0", B=2, S=8, prompt_tokens=10, pad_tokens=6),
        span("serve.decode", "d0", 2.5, 0.05, "b0", B=2, pos=8),
        span("serve.decode", "d1", 2.6, 0.07, "b0", B=2, pos=9),
        span("serve.prefill", "p1", 4.6, 0.1, "b1", B=2, S=5, prompt_tokens=9, pad_tokens=1),
        span("serve.decode", "d2", 4.8, 0.04, "b1", B=2, pos=5),
        span("serve.decode", "d3", 4.9, 0.04, "b1", B=2, pos=6),
        span("serve.request", "q9", 0.0, None, id="r4"),          # still open: not read
    ]
    return run


def test_readers_on_a_synthetic_run():
    run = _run()
    # waits 1100, 100, 1500, 300 ms: numpy's linear 95th percentile
    assert spans.queue_wait_ms(run) == pytest.approx(1100 + 0.85 * 400)
    assert spans.padding_share(run) == pytest.approx(100 * 7 / 26)
    assert spans.prefill_us_per_token(run) == pytest.approx(1e6 * 0.3 / 19)
    assert spans.decode_step_ms(run) == pytest.approx(50.0)
    # b0: 2.1 - 2.0 (its last request); b1: 4.5 - max(4.2, b0's end 4.3)
    assert spans.fire_lag_ms(run) == pytest.approx(150.0)
    # a profiled batch leaves the window's sums
    run.batches[1].profiled = True
    assert spans.decode_step_ms(run) == pytest.approx(60.0)
    assert spans.padding_share(run) == pytest.approx(100 * 6 / 16)


def test_readers_find_nothing_where_a_span_is_missing():
    run = _run()
    run.spans = [s for s in run.spans if s["span"] != "q3"]
    assert spans.queue_wait_ms(run) is None
    assert spans.fire_lag_ms(run) is None
    assert spans.padding_share(run) is not None
    run = _run()
    run.spans = [s for s in run.spans if s["span"] != "b1"]
    assert spans.queue_wait_ms(run) is None
    assert all(f(run) is None for f in (spans.padding_share, spans.decode_step_ms,
                                        spans.prefill_us_per_token, spans.fire_lag_ms))
    run = harness.Run(smoke.config(), {}, 10.0)   # a program that records no span
    run.t_open, run.t_close = 0.0, 10.0
    run.requests["r0"] = harness.Request("r0", 0, 8, None, 1.0)
    b = harness.Batch(0, ["r0"], 8, 2.0)
    b.t1 = 3.0
    run.batches.append(b)
    assert spans.queue_wait_ms(run) is None and spans.padding_share(run) is None
    assert spans.idle_share(run, "serve.decode") is None


def test_idle_inside_decode_spans_on_the_profiles_timeline():
    """Origin W + 10 s: batch A decodes 1000-2000 µs, batch B 3000-4000 µs;
    a batch of a dropped session lies before the origin.  Device gaps inside
    the spans count; the gap between the batches does not."""
    run = harness.Run(smoke.config(), {}, 10.0)
    run.t_open, run.t_close = 0.0, 20.0
    run.trace_start_ns, run.spans = int((W + 10.0) * 1e9), []
    for k, (ts, name) in enumerate(((5.0, "c"), (10.001, "a"), (10.003, "b"))):
        b = harness.Batch(k, [name], 4, ts)
        b.t1, b.profiled = ts + 0.001, True
        run.batches.append(b)
        run.spans += [span("serve.batch", name, ts - 1e-4, 0.0012, ids=[name]),
                      span("serve.decode", "d" + name, ts, 0.001, name, B=1, pos=4)]
    assert spans.on_timeline(run, run.spans[3]) == (pytest.approx(1000, abs=1),
                                                    pytest.approx(2000, abs=1))
    assert spans.profiled_calls(run, "serve.decode") == [
        (pytest.approx(1000, abs=1), pytest.approx(2000, abs=1)),
        (pytest.approx(3000, abs=1), pytest.approx(4000, abs=1))]
    run.trace = {"intervals": [(1000, 1400, "k"), (1300, 1500, "k"), (1800, 2500, "k"),
                               (3000, 3500, "k")]}
    # inside: 1000-1500, 1800-2000, 3000-3500 busy, so 1200 of 2000 µs
    assert spans.idle_share(run, "serve.decode") == pytest.approx(40.0, abs=0.1)
    assert spans.idle_share(run, "serve.prefill") is None
    run.trace = None
    assert spans.idle_share(run, "serve.decode") is None


def test_spantrace_reads_a_traced_run_of_a_cell():
    """At CPU size: the program's spans cover every counted request and
    window batch, each ``bench.*`` range of the kept profile lies inside
    its span on the profile's timeline, the span-timed readings wrap the
    harness's own records, and the tool leaves the harness as it was."""
    line = spantrace.traced_run(Spec(), "zamba2-1.2b.chat-every-batch", 2**31 + 33, 2.0,
                                "cpu", time.perf_counter(), conf=smoke.config(),
                                mix=smoke.mix("chat"), settings=smoke.settings(0.05))
    assert line["correct"]
    read, outside = line["spans"], line["harness"]
    assert all(read[k] is not None for k in ("queue_wait_ms", "padding_share",
                                             "fire_lag_span_ms", "decode_step_span_ms"))
    # no device activity on the CPU: the profiled slice reduces to nothing
    assert read["decode_idle_share"] is None
    # each span wraps the harness's own stamps (time.time() against
    # perf_counter(): equal to their resolution, well under 0.01 ms)
    assert outside["decode_step_ms.chat"] <= read["decode_step_span_ms"] + 0.01 \
        <= 1.05 * outside["decode_step_ms.chat"] + 1.0
    assert read["fire_lag_span_ms"] <= outside["fire_lag_ms.chat"] + 0.01
    assert 0 < read["padding_share"] < 100
    assert line["clock"]["matched"] and line["clock"]["out_max"] < 1000
    assert line["receipt"]["n"] > 0 and line["receipt"]["min"] >= -1000
    counters = line["counters"]
    # the batcher fires at max_batch: every batch, the warm-up's too, is full
    assert counters["tf_serve_requests_total"] == 4 * counters["tf_serve_batches_total"]
    assert counters["tf_serve_batches_total"] > line["batches"]
    assert harness.Recorder.__module__ == "benchlib.harness"
    assert harness.trace_mod.reduce.__module__ == "benchlib.trace"
