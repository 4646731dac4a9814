"""``obs-discipline``: metrics are batch-granular, never per-event.

The metrics plane's CI-gated overhead budget (≤10% on the noop action
plane) holds because the hot path records O(1) metric updates per *batch*
(``Histogram.observe_batch``), not per event.  This rule flags
``Counter.inc`` / ``Histogram.observe`` calls lexically
inside a ``for``/``while`` loop — the shape that silently reintroduces
O(events) instrument updates (and double-counting, PR 6's dlq bug) when a
batched path grows a per-item loop.

``observe_batch`` is the sanctioned call and is never flagged.  A scalar
update inside a *cold* loop (scrape aggregation, shutdown paths) is a
legitimate exception: pragma it with the reason.
"""
from __future__ import annotations

import ast
from typing import List, Sequence

from .core import Finding, Rule, SourceFile

_SCALAR_METRIC_ATTRS = ("inc", "observe")


class ObsDiscipline(Rule):
    id = "obs-discipline"
    invariant = ("No scalar metric updates (.inc()/.observe()) inside "
                 "per-item loops; hot paths record per batch via "
                 "observe_batch.")
    motivation = ("PR 6: the metrics plane's <=10% overhead gate and the "
                  "dlq double-count fix both rest on batch-granular "
                  "recording.")

    def check(self, files: Sequence[SourceFile]) -> List[Finding]:
        out: List[Finding] = []
        for sf in files:
            for qual, cls, fn in sf.functions():
                self._visit(sf, fn, False, out)
        return out

    def _visit(self, sf: SourceFile, node: ast.AST, in_loop: bool,
               out: List[Finding]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            now = in_loop or isinstance(child, (ast.For, ast.While))
            if in_loop and isinstance(child, ast.Call):
                f = child.func
                if isinstance(f, ast.Attribute) and \
                        f.attr in _SCALAR_METRIC_ATTRS:
                    self._finding(
                        sf, child, "scalar metric .%s() inside a loop — "
                        "record per batch (observe_batch) instead" % f.attr,
                        out)
            self._visit(sf, child, now, out)
