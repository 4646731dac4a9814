"""The program's serving spans in a run, and the readings taken from them.

Given a ``Tracer``, the port's ``ServingEngine`` (``serving/engine.py``)
records on its trace plane ``serve.request`` (publish → its done event
produced; ``id``, ``prompt_len``, ``batch``), ``serve.batch`` (the action's
start → its last done event; ``n``, ``S``, ``prompt_tokens``,
``pad_tokens``, ``ids``) and the batch's children ``serve.prefill`` (``B``,
``S``, ``prompt_tokens``, ``pad_tokens``) and ``serve.decode`` (``B``,
``pos``).  A record's ``ts`` is ``time.time()`` at its start, ``dur`` its
length in seconds.

The readers take a ``harness.Run`` carrying ``spans`` (the records) and
``trace_start_ns`` (the kept profile's origin), and pick the spans the way
``readers.py`` picks the harness's own records: counted requests by id,
the window's unprofiled batches (``Run.window_batches()``) by their request
ids, the profiled batches for the device's idle time.  Each returns None
where a counted request or a window batch has no span, so on a program
that records none they read nothing.

The profile's timeline: ``prof.events()`` times are µs after
``kineto_results.trace_start_ns()``, which is on ``time.time_ns()``'s clock,
so a span starts at ``ts·1e6 − trace_start_ns/1e3`` µs there.
"""
from __future__ import annotations

import bisect
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class Index:
    """A run's ended spans: requests by id, batches by span id and by their
    request ids, and each batch's prefill and decode spans."""

    def __init__(self, run):
        self.requests: Dict[str, dict] = {}
        self.batches: Dict[str, dict] = {}
        self.by_ids: Dict[tuple, dict] = {}
        self.children: Dict[str, List[dict]] = {}
        for s in getattr(run, "spans", None) or ():
            if s.get("dur") is None:
                continue
            name = s["name"]
            if name == "serve.request":
                self.requests[s["id"]] = s
            elif name == "serve.batch":
                self.batches[s["span"]] = s
                self.by_ids[tuple(s["ids"])] = s
            elif name in ("serve.prefill", "serve.decode"):
                self.children.setdefault(s["parent"], []).append(s)

    def of(self, batch) -> Optional[dict]:
        """The span of the harness's ``Batch``."""
        return self.by_ids.get(tuple(batch.ids))

    def calls(self, batch_span: dict, name: str) -> List[dict]:
        return [c for c in self.children.get(batch_span["span"], ()) if c["name"] == name]


def end(span: dict) -> float:
    return span["ts"] + span["dur"]


def _window(run, idx: Index) -> Optional[List[dict]]:
    """The spans of the window's unprofiled batches; None where one has none."""
    out = []
    for b in run.window_batches():
        s = idx.of(b)
        if s is None:
            return None
        out.append(s)
    return out or None


def _window_calls(run, name: str) -> Optional[List[dict]]:
    idx = Index(run)
    batches = _window(run, idx)
    if batches is None:
        return None
    calls = [c for s in batches for c in idx.calls(s, name)]
    return calls or None


def queue_wait_ms(run) -> Optional[float]:
    """95th percentile (numpy's linear) over the counted requests of their
    batch span's start less their request span's start, ms."""
    idx = Index(run)
    waits = []
    for r in run.counted():
        req = idx.requests.get(r.id)
        batch = idx.batches.get(req.get("batch")) if req is not None else None
        if batch is None:
            return None
        waits.append((batch["ts"] - req["ts"]) * 1e3)
    return float(np.percentile(waits, 95)) if waits else None


def padding_share(run) -> Optional[float]:
    """The window's prefill spans: Σ ``pad_tokens`` over Σ B·S, %."""
    calls = _window_calls(run, "serve.prefill")
    if calls is None:
        return None
    return 100.0 * sum(c["pad_tokens"] for c in calls) / sum(c["B"] * c["S"] for c in calls)


def fire_lag_ms(run) -> Optional[float]:
    """``readers.fire_lag_ms`` from the program's stamps: the median over the
    window's batches of the batch span's start less the later of its last
    request span's start and the previous batch span's end, ms."""
    idx = Index(run)
    batches = _window(run, idx)
    if batches is None:
        return None
    order = sorted(idx.batches.values(), key=lambda s: s["ts"])
    starts = [s["ts"] for s in order]
    lags = []
    for s in batches:
        ids = [i for i in s["ids"] if i in run.requests]
        if not ids:
            continue
        if any(i not in idx.requests for i in ids):
            return None
        ready = max(idx.requests[i]["ts"] for i in ids)
        k = bisect.bisect_left(starts, s["ts"])
        if k > 0:
            ready = max(ready, end(order[k - 1]))
        lags.append((s["ts"] - ready) * 1e3)
    return statistics.median(lags) if lags else None


def decode_step_ms(run) -> Optional[float]:
    """The mean ``dur`` of the window's decode spans, ms."""
    calls = _window_calls(run, "serve.decode")
    if calls is None:
        return None
    return 1e3 * sum(c["dur"] for c in calls) / len(calls)


def prefill_us_per_token(run) -> Optional[float]:
    """Σ ``dur`` of the window's prefill spans over Σ their ``prompt_tokens``,
    µs a real token."""
    calls = _window_calls(run, "serve.prefill")
    tokens = sum(c["prompt_tokens"] for c in calls) if calls else 0
    if not tokens:
        return None
    return 1e6 * sum(c["dur"] for c in calls) / tokens


def on_timeline(run, span: dict) -> Tuple[float, float]:
    """The span's start and end on the kept profile's timeline, µs."""
    t0 = span["ts"] * 1e6 - run.trace_start_ns / 1e3
    return t0, t0 + span["dur"] * 1e6


def profiled_calls(run, name: str) -> Optional[List[Tuple[float, float]]]:
    """The kept profile's ``name`` spans on its timeline, in order: the calls
    of the profiled batches that start after the profile's origin (a
    session that saw no device activity was dropped, and its batches lie
    before the kept one's)."""
    if getattr(run, "trace_start_ns", None) is None:
        return None
    idx = Index(run)
    out = []
    for b in run.batches:
        if not b.profiled:
            continue
        s = idx.of(b)
        if s is None:
            return None
        out.extend(on_timeline(run, c) for c in idx.calls(s, name))
    out = sorted(c for c in out if c[0] >= 0)
    return out or None


def union(intervals: Sequence[tuple]) -> List[Tuple[float, float]]:
    """The union of ``(start, end, ...)`` intervals as sorted disjoint pairs."""
    out: List[Tuple[float, float]] = []
    for s, t, *_ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t))
        else:
            out.append((s, t))
    return out


def covered(spans: Sequence[Tuple[float, float]], busy: List[Tuple[float, float]]) -> float:
    """The time of ``spans`` (disjoint) that ``busy`` (disjoint, sorted) covers."""
    starts = [b[0] for b in busy]
    total = 0.0
    for s, t in spans:
        k = max(bisect.bisect_right(starts, s) - 1, 0)
        while k < len(busy) and busy[k][0] < t:
            total += max(0.0, min(t, busy[k][1]) - max(s, busy[k][0]))
            k += 1
    return total


def idle_share(run, name: str) -> Optional[float]:
    """Of the profiled slice's time inside ``name`` spans, the share with no
    device interval (``trace.reduce``'s ``intervals``), %."""
    if run.trace is None:
        return None
    calls = profiled_calls(run, name)
    if calls is None:
        return None
    inside = sum(t - s for s, t in calls)
    busy = covered(calls, union(run.trace["intervals"]))
    return 100.0 * (1.0 - busy / inside)
