"""The causal trace plane: traceparent-style context on CloudEvents.

Every published event may carry a ``tftrace`` extension attribute —
``[trace_id, span_id]`` where ``span_id`` names the *span that produced
the event* (the workload's root publish span, or the fire span whose
action ``produce``d it).  A worker firing on a traced slice opens a
child span, runs the action with the new span as the current trace
context (so ``ctx.produce_batch`` stamps downstream events with it), and
records the span on completion — every downstream event therefore links
back to the fire that caused it, across shards, processes and crashes.

Spans are plain dicts collected in a bounded ring buffer
(``SpanCollector``) with a JSONL exporter.  Process-mode shards attach a
``SegmentLog`` sink: spans are flushed with the worker's checkpoint (so a
span is durable iff its batch's effects are), *plus* an early **open
record** (``dur: None``) written before a traced fire publishes children
— otherwise a SIGKILL between publish and checkpoint would leave orphan
child events pointing at a span no file ever saw.  Replay after the
crash re-runs the fire under a fresh span id, so stitching dedups by
``span_id`` (preferring the completed record over its open twin) and the
tree stays connected.

Sampling: the decision is made once, at the root.  A traced event is
always followed (context propagation is never sampled away mid-chain);
an *untraced* fire starts a new trace only when the tracer's sampler
admits it.  ``sample=1.0`` is full tracing, ``0.0`` is propagate-only.
"""
from __future__ import annotations

import json
import os
import time
import uuid
from collections import deque
from typing import TYPE_CHECKING, Dict, Iterable, List, Optional, Sequence, Tuple

if TYPE_CHECKING:  # annotation-only: keeps obs free of core imports (no cycle)
    from ..core.events import CloudEvent

#: CloudEvents extension attribute carrying ``[trace_id, span_id]``.
EXT_KEY = "tftrace"


def new_id() -> str:
    """128-bit random hex halved — unique across forked shard processes
    (uuid4 reads the OS entropy pool, never a fork-shared PRNG state)."""
    return uuid.uuid4().hex[:16]


def trace_context(event: CloudEvent) -> Optional[Tuple[str, str]]:
    """The (trace_id, parent_span_id) an event carries, if any."""
    ext = event.ext
    if not ext:
        return None
    tc = ext.get(EXT_KEY)
    return (tc[0], tc[1]) if tc else None


def inject(events: Iterable[CloudEvent], trace_id: str, span_id: str) -> None:
    """Stamp trace context onto events that do not already carry one.
    Writes through ``__dict__`` (the events are frozen dataclasses — same
    trick as ``CloudEvent.from_dict``)."""
    tc = [trace_id, span_id]
    for e in events:
        if e.ext is None:
            e.__dict__["ext"] = {EXT_KEY: tc}
        else:
            e.ext.setdefault(EXT_KEY, tc)


class SpanCollector:
    """Bounded ring buffer of finished spans, with an optional durable
    ``SegmentLog`` sink (process-mode shards).  ``deque.append`` is atomic,
    so thread-pool shards share one collector lock-free."""

    def __init__(self, capacity: int = 8192, segment=None) -> None:
        self.spans: deque = deque(maxlen=capacity)
        self._segment = segment
        self._pending: List[dict] = []

    def add(self, span: dict) -> None:
        self.spans.append(span)
        if self._segment is not None:
            self._pending.append(span)

    def flush(self) -> None:
        """Append pending spans to the segment sink (one write + fsync per
        flush — called from the worker's checkpoint, so span durability
        rides the checkpoint's fsync cadence, not per-span)."""
        if self._segment is None or not self._pending:
            return
        lines = [json.dumps(s, separators=(",", ":")) for s in self._pending]
        self._pending.clear()
        self._segment.append(lines)

    def persist_now(self, span: dict) -> None:
        """Durably append one record immediately (the open-record path)."""
        if self._segment is not None:
            self._segment.append([json.dumps(span, separators=(",", ":"))])

    def drain(self) -> List[dict]:
        out = list(self.spans)
        self.spans.clear()
        return out

    def export_jsonl(self, path: str) -> int:
        with open(path, "w", encoding="utf-8") as f:
            for s in self.spans:
                f.write(json.dumps(s, separators=(",", ":")) + "\n")
        return len(self.spans)


class Tracer:
    """Per-shard span factory.  ``sample`` admits *new* roots via a
    deterministic accumulator (no RNG on the hot path); propagation of an
    existing context is unconditional."""

    __slots__ = ("sample", "collector", "tag", "_acc")

    def __init__(self, sample: float = 0.1,
                 collector: Optional[SpanCollector] = None,
                 tag: Optional[str] = None) -> None:
        self.sample = max(0.0, min(1.0, sample))
        self.collector = collector if collector is not None else SpanCollector()
        self.tag = tag
        self._acc = 0.0

    def sample_new(self) -> bool:
        self._acc += self.sample
        if self._acc >= 1.0:
            self._acc -= 1.0
            return True
        return False

    # -- span lifecycle ------------------------------------------------------------
    def begin(self, name: str, trace_id: str, parent_id: Optional[str],
              **attrs) -> dict:
        span = {"trace": trace_id, "span": new_id(), "parent": parent_id,
                "name": name, "ts": time.time(), "dur": None}
        if self.tag is not None:
            span["shard"] = self.tag
        if attrs:
            span.update(attrs)
        span["_t0"] = time.perf_counter()
        return span

    def end(self, span: dict) -> None:
        span["dur"] = time.perf_counter() - span.pop("_t0")
        span.pop("_open", None)
        self.collector.add(span)

    def start_trace(self, name: str, **attrs) -> dict:
        """Open a root span (e.g. the workload's publish step).  The caller
        injects ``context_of_span(root)`` into the events it publishes and
        ``end()``s the root when done."""
        return self.begin(name, new_id(), None, **attrs)

    def fire_span(self, event: CloudEvent, trigger_id: str, workflow: str,
                  n: int) -> Optional[dict]:
        """Open a fire span for a (trigger, slice): child of the slice's
        carried context, or a sampled new root when the slice is untraced.
        Returns None when tracing declines (unsampled, untraced)."""
        tc = trace_context(event)
        if tc is not None:
            trace_id, parent = tc
        elif self.sample_new():
            trace_id, parent = new_id(), None
        else:
            return None
        return self.begin("fire", trace_id, parent,
                          wf=workflow, trigger=trigger_id, n=n)

    def persist_open(self, span: dict) -> None:
        """Durably record a still-open span (``dur: None``) before its fire
        publishes child events — the completed record written later shares
        the span id and wins at stitch time."""
        if self.collector._segment is None:
            return  # in-memory collectors have nothing to make durable
        if "_open" not in span:  # once per span
            span["_open"] = True
            open_rec = {k: v for k, v in span.items()
                        if k not in ("_t0", "_open")}
            self.collector.persist_now(open_rec)

    def flush(self) -> None:
        self.collector.flush()


def context_of_span(span: dict) -> Tuple[str, str]:
    return span["trace"], span["span"]


# -- stitching ---------------------------------------------------------------------
def load_spans(paths: Sequence[str]) -> List[dict]:
    """Read span records from JSONL files / directories of ``*.jsonl``.
    Tolerates the SegmentLog torn-tail (a SIGKILL mid-append): unparseable
    lines end that file's scan, matching the log's own contract."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p) if f.endswith(".jsonl")))
        else:
            files.append(p)
    spans: List[dict] = []
    for path in files:
        try:
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        spans.append(json.loads(line))
                    except ValueError:
                        break  # torn tail — everything before it is valid
        except OSError:
            continue
    return spans


def stitch_spans(*span_sets: Iterable[dict]) -> List[dict]:
    """Merge span records, deduplicating by span id.  A completed record
    (``dur`` set) always replaces its open twin; duplicate completed records
    (re-read segments) collapse to one."""
    by_id: Dict[str, dict] = {}
    for spans in span_sets:
        for s in spans:
            sid = s.get("span")
            if sid is None:
                continue
            cur = by_id.get(sid)
            if cur is None or (cur.get("dur") is None and s.get("dur") is not None):
                by_id[sid] = s
    return sorted(by_id.values(), key=lambda s: s.get("ts", 0.0))


def span_trees(spans: Sequence[dict]) -> Dict[str, dict]:
    """Group stitched spans into one tree per trace id.  Each tree is
    ``{"root": attachment, "spans": n, "children": {...}, "attachments": k}``
    where an *attachment point* is a parent id no span in the set owns
    (the workload's root context, typically) or ``None`` for explicit
    roots; a connected trace has exactly one."""
    trees: Dict[str, dict] = {}
    for trace_id in {s["trace"] for s in spans}:
        trace = [s for s in spans if s["trace"] == trace_id]
        ids = {s["span"] for s in trace}
        children: Dict[Optional[str], List[dict]] = {}
        attachments = set()
        for s in trace:
            parent = s.get("parent")
            if parent not in ids:
                attachments.add(parent)
            children.setdefault(parent, []).append(s)
        trees[trace_id] = {
            "spans": len(trace),
            "attachments": sorted(str(a) for a in attachments),
            "connected": len(attachments) == 1,
            "children": children,
        }
    return trees


def render_tree(tree: dict, spans: Sequence[dict]) -> str:
    """ASCII rendering of one trace's span tree (depth-first)."""
    children = tree["children"]
    ids = {s["span"]: s for s in spans}
    lines: List[str] = []

    def walk(parent: Optional[str], depth: int) -> None:
        for s in sorted(children.get(parent, ()), key=lambda x: x.get("ts", 0.0)):
            dur = s.get("dur")
            dur_s = f"{dur * 1e3:.2f}ms" if dur is not None else "open"
            label = s.get("name", "?")
            extra = " ".join(
                f"{k}={s[k]}" for k in ("wf", "trigger", "n", "shard") if k in s)
            lines.append(f"{'  ' * depth}- {label} [{s['span']}] {dur_s}"
                         + (f" ({extra})" if extra else ""))
            walk(s["span"], depth + 1)

    roots = [a for a in {s.get("parent") for s in spans if s["span"] in ids}
             if a not in ids]
    for attachment in sorted(str(r) for r in set(roots)):
        real = None if attachment == "None" else attachment
        lines.append(f"root <- {attachment}")
        walk(real, 1)
    return "\n".join(lines)
