"""The metrics plane: a dependency-free registry of counters, gauges and
pre-bucketed histograms built for the batch plane's O(batch) discipline.

Recording rule (the whole design): the hot path records **once per
(trigger, slice) or per batch**, never per event — ``observe_batch(n,
total_seconds)`` adds ``n`` observations in one call by crediting the
batch *mean* to a single pre-computed bucket.  A recording is two float
adds, one int add and one bisect over a tuple of bounds; there is no
locking anywhere on the write path.  Aggregation happens only on scrape:
each shard (thread or OS process) owns a private registry instance and
``merge_snapshot`` folds plain-dict snapshots together — snapshots are
what travels over the process pool's command pipe, so the scrape path is
identical for both runtimes.

Export is a hand-rolled Prometheus text rendering (no client library —
the container pins its dependency set) plus a JSON dump of the same
snapshot; both are wired into ``launch/serve.py`` and the pools'
``metrics()``.
"""
from __future__ import annotations

import json
from bisect import bisect_right
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

# Log-spaced latency bounds (seconds): 10µs → 10s covers everything from a
# noop fire-run call to a cold fsync on a loaded disk.  Upper bounds,
# ascending; the +inf bucket is implicit (counts[-1]).
DEFAULT_BOUNDS: Tuple[float, ...] = (
    1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5, 1.0, 5.0, 10.0)


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    __slots__ = ("name", "bounds", "counts", "sum", "count")

    def __init__(self, name: str, bounds: Optional[Iterable[float]] = None) -> None:
        self.name = name
        self.bounds = tuple(bounds) if bounds is not None else DEFAULT_BOUNDS
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect_right(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def observe_batch(self, n: int, total: float) -> None:
        """One recording for ``n`` observations totalling ``total`` seconds:
        all ``n`` land in the bucket of the batch *mean* (the documented
        O(batch) approximation — per-event bucketing would reintroduce the
        per-event loop the batch plane exists to avoid)."""
        if n <= 0:
            return
        self.counts[bisect_right(self.bounds, total / n)] += n
        self.sum += total
        self.count += n


class MetricsRegistry:
    """Per-shard, get-or-create metric container.  Instances are private to
    one shard's hot loop (no locks); cross-shard totals exist only as merged
    snapshots produced at scrape time."""

    __slots__ = ("_counters", "_gauges", "_histograms")

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str, bounds: Optional[Iterable[float]] = None) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name, bounds)
        return h

    # -- scrape side ---------------------------------------------------------------
    def snapshot(self) -> Dict:
        """A plain-dict copy safe to serialize over a pipe and to merge."""
        return {
            "counters": {n: c.value for n, c in self._counters.items()},
            "gauges": {n: g.value for n, g in self._gauges.items()},
            "histograms": {
                n: {"bounds": list(h.bounds), "counts": list(h.counts),
                    "sum": h.sum, "count": h.count}
                for n, h in self._histograms.items()
            },
        }


def empty_snapshot() -> Dict:
    return {"counters": {}, "gauges": {}, "histograms": {}}


def merge_snapshot(into: Dict, snap: Optional[Mapping]) -> Dict:
    """Fold one shard's snapshot into an aggregate (in place; returns it).
    Counters and histogram buckets add; gauges add too — every gauge we
    export (lag, live shards) is a per-shard quantity whose fleet-wide value
    is the sum."""
    if not snap:
        return into
    c = into["counters"]
    for n, v in snap.get("counters", {}).items():
        c[n] = c.get(n, 0) + v
    g = into["gauges"]
    for n, v in snap.get("gauges", {}).items():
        g[n] = g.get(n, 0) + v
    hs = into["histograms"]
    for n, h in snap.get("histograms", {}).items():
        cur = hs.get(n)
        if cur is None or list(cur["bounds"]) != list(h["bounds"]):
            # first sight (or mismatched bounds: last writer wins whole)
            hs[n] = {"bounds": list(h["bounds"]), "counts": list(h["counts"]),
                     "sum": h["sum"], "count": h["count"]}
            continue
        cur["counts"] = [a + b for a, b in zip(cur["counts"], h["counts"])]
        cur["sum"] += h["sum"]
        cur["count"] += h["count"]
    return into


def fold_counters(into: Dict, counters: Mapping[str, int]) -> Dict:
    """Add loose ``{name: value}`` counters (e.g. a retired shard's folded
    ``WorkerStats``) into a snapshot's counter section."""
    c = into["counters"]
    for n, v in counters.items():
        c[n] = c.get(n, 0) + v
    return into


# -- export ------------------------------------------------------------------------
def render_prometheus(snap: Mapping) -> str:
    """Prometheus text exposition (0.0.4) of a snapshot — hand-rolled, no
    client library."""
    out: List[str] = []
    for name in sorted(snap.get("counters", {})):
        out.append(f"# TYPE {name} counter")
        out.append(f"{name} {snap['counters'][name]}")
    for name in sorted(snap.get("gauges", {})):
        out.append(f"# TYPE {name} gauge")
        out.append(f"{name} {snap['gauges'][name]}")
    for name in sorted(snap.get("histograms", {})):
        h = snap["histograms"][name]
        out.append(f"# TYPE {name} histogram")
        acc = 0
        for bound, n in zip(h["bounds"], h["counts"]):
            acc += n
            out.append(f'{name}_bucket{{le="{bound}"}} {acc}')
        out.append(f'{name}_bucket{{le="+Inf"}} {h["count"]}')
        out.append(f"{name}_sum {h['sum']}")
        out.append(f"{name}_count {h['count']}")
    return "\n".join(out) + "\n"


def render_json(snap: Mapping) -> str:
    return json.dumps(snap, indent=2, sort_keys=True)


def dump_metrics(snap: Mapping, prefix: str) -> List[str]:
    """Write ``<prefix>.prom`` + ``<prefix>.json``; returns the paths."""
    paths = []
    for suffix, text in ((".prom", render_prometheus(snap)),
                         (".json", render_json(snap))):
        path = prefix + suffix
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
        paths.append(path)
    return paths


class WorkerMetrics:
    """The worker's stage-boundary histograms, pre-bound so the hot loop
    pays attribute loads, not registry dict lookups.  One instance per
    ``TFWorker`` (= per shard)."""

    __slots__ = ("registry", "consume_lag", "batch_eval", "join_kernel",
                 "fire", "checkpoint", "publish")

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        r = self.registry = registry if registry is not None else MetricsRegistry()
        self.consume_lag = r.histogram("tf_consume_lag_seconds")
        self.batch_eval = r.histogram("tf_batch_eval_seconds")
        self.join_kernel = r.histogram("tf_join_kernel_seconds")
        self.fire = r.histogram("tf_fire_seconds")
        self.checkpoint = r.histogram("tf_checkpoint_seconds")
        self.publish = r.histogram("tf_publish_seconds")
