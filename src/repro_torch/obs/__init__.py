"""Observability: the metrics plane (``obs.metrics``) and the causal
trace plane (``obs.trace``) — see docs/ARCHITECTURE.md §7."""
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    WorkerMetrics,
    dump_metrics,
    empty_snapshot,
    fold_counters,
    merge_snapshot,
    render_json,
    render_prometheus,
)
from .trace import (
    EXT_KEY,
    SpanCollector,
    Tracer,
    context_of_span,
    inject,
    load_spans,
    render_tree,
    span_trees,
    stitch_spans,
    trace_context,
)

__all__ = [
    "Counter", "EXT_KEY", "Gauge", "Histogram", "MetricsRegistry",
    "SpanCollector", "Tracer", "WorkerMetrics", "context_of_span",
    "dump_metrics", "empty_snapshot", "fold_counters", "inject",
    "load_spans", "merge_snapshot", "render_json", "render_prometheus",
    "render_tree", "span_trees", "stitch_spans", "trace_context",
]
