"""Vector join plane: batched aggregation-condition evaluation as array ops.

The worker's batch plane evaluates conditions over ``(subject, type)``
slices.  This module is the fully-vectorized tier above that: a consumed
batch whose subjects route to aggregation joins (``counter`` — counting or
aggregating — and ``threshold_join``, without ``exactly_once`` dedup) that
provably cannot fire within the batch (``count + batch share < threshold``)
reduces to *counting plus column gathers* — no action runs, no per-event
interpreter dispatch, no per-event state changes except the counters and
the pre-extracted result columns.

``triage`` therefore never walks individual events through the condition
machinery: the batch is bucketed per subject C-level (one pass), each
distinct subject is screened against its compiled dispatch entries, all
claimed subjects are folded into one one-hot segmented sum over the routed
event batch — the ``event_join`` kernel (Pallas on TPU, jitted-jnp or
``bincount`` on CPU; see ``kernels.event_join.dispatch``) — and aggregating
triggers additionally get their ``data["result"]`` column appended in one
list-comprehension per (subject, trigger) run.  The Table-1 join hot loop
becomes O(batch) array/column ops plus O(distinct subjects) Python.

``triage`` also accepts an :class:`EventColumns` view straight off a
decoded TFB1 columnar frame (``core.codec``): ids/subjects/types and the
result column are then the decoded frame's own columns, so a fully-claimed
binary batch flows from the segment log into the ``event_join`` kernel
without ever materializing per-event CloudEvent objects.

Everything else — slices that would cross a threshold, dedup, timeouts,
failures, non-join conditions — is returned as leftover for the worker's
per-trigger fire-run/batched/scalar path, which owns the exact fire
semantics.  The screening is the correctness boundary: the kernel only ever
sees slices whose outcome is pure counting/aggregation, so parity with the
scalar interpreter is by construction.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

try:  # numpy is the plane's only hard dependency; degrade to None without it
    import numpy as np
except ImportError:  # pragma: no cover - numpy is in the base image
    np = None

from .codec import EventColumns
from .conditions import _result_of
from .events import TYPE_FAILURE, TYPE_TIMEOUT, CloudEvent

TriageResult = Tuple[List[str], List[CloudEvent]]  # (handled ids, leftover)

#: Condition names ``triage`` can claim (absent ``exactly_once``).  The
#: worker's structural pre-screen (``TFWorker._has_join_triggers``) consumes
#: this, so extending claimability here automatically re-enables triage for
#: the new conditions.
CLAIMABLE_CONDITIONS = ("counter", "threshold_join")


class VectorJoinPlane:
    """Batch-level accelerator for non-firing aggregation-join batches."""

    def __init__(self, backend: Optional[str] = None, min_subjects: int = 2):
        if np is None:
            raise RuntimeError("VectorJoinPlane requires numpy")
        from ..kernels.event_join.dispatch import (join_counts_segments,
                                                   resolve_join_backend)

        self._join_segments = join_counts_segments
        self.backend, self._join = resolve_join_backend(backend)
        if self._join is None:
            raise RuntimeError("join backend disabled")
        # Below this many claimable subjects the per-trigger batched
        # conditions beat array assembly.
        self.min_subjects = min_subjects
        self.calls = 0
        self.events = 0

    @staticmethod
    def _screen_entry(entry, ctx) -> Optional[Tuple[int, bool]]:
        """(threshold, aggregates) for a claimable join condition, else None.

        Claimable: ``counter`` (either aggregation mode) or ``threshold_join``
        without ``exactly_once`` — their per-event effect on a non-firing,
        termination-typed slice is exactly "count += 1 (+ append result)".
        """
        cspec = entry.cspec
        if cspec.get("exactly_once"):
            return None
        expected = ctx.get("expected", cspec.get("expected", 1))
        if entry.cname == "counter":  # CLAIMABLE_CONDITIONS
            aggregates = bool(cspec.get("aggregate", True))
            threshold = int(expected)
        elif entry.cname == "threshold_join":  # CLAIMABLE_CONDITIONS
            frac = float(cspec.get("fraction", 1.0))
            aggregates = True
            threshold = max(1, math.ceil(int(expected) * frac))
        else:
            return None
        if aggregates:
            # a poisoned results value (introspection writing a non-list)
            # must be declined *here*: the apply loop below writes counts
            # before extending results, and an extend failure after that
            # would hand the batch to the exact path double-counted
            res = ctx.get("results")
            if res is not None and not isinstance(res, list):
                return None
        return threshold, aggregates

    def triage(self, batch: "List[CloudEvent] | EventColumns",
               entries_for: Callable[[str], Sequence[Any]],
               stats) -> Optional[TriageResult]:
        """Claim and evaluate the non-firing join share of a consumed batch.

        ``batch`` is either a list of CloudEvents (the in-memory bus) or an
        :class:`EventColumns` view straight off a decoded TFB1 frame — the
        columnar path never materializes per-event objects unless a split
        leaves events for the exact path.

        Returns ``(handled_event_ids, leftover_events)`` — the handled events
        have been fully accounted (counters advanced, result columns
        appended, activations counted) and only need committing; the
        leftovers carry every event the exact path must see.  Returns
        ``None`` when the batch isn't worth vectorizing (mixed types,
        failure/timeout slices, too few claimable subjects) — the caller
        then processes the whole batch normally.
        """
        cols = batch if isinstance(batch, EventColumns) else None
        if cols is not None:
            ids, subjects, types = cols.ids, cols.subjects, cols.types
        else:
            ids = [e.id for e in batch]
            subjects = [e.subject for e in batch]
            types = [e.type for e in batch]
        etype = types[0]
        if len(set(types)) != 1:
            return None
        if etype == TYPE_FAILURE or etype == TYPE_TIMEOUT:
            return None
        if len(set(ids)) != len(ids):
            # A re-published duplicate inside the batch: counting the copies
            # would double-count the join.  The grouped path's in-flight set
            # dedups exactly (§3.4), so leave the whole batch to it.
            return None
        # subject -> its arrival-ordered event indices (insertion order =
        # the order the grouped path would build its slices in)
        by_subject: dict = {}
        for i, s in enumerate(subjects):
            idxs = by_subject.get(s)
            if idxs is None:
                by_subject[s] = [i]
            else:
                idxs.append(i)
        # tid -> [ctx, count0, threshold, events_in_batch]
        pairs: dict = {}
        aggregating: dict = {}   # tid -> pre-extracted result column
        claimed: dict = {}       # subject -> its candidate tid list
        for subject, sidx in by_subject.items():
            m = len(sidx)
            entries = entries_for(subject)
            if not entries:
                continue  # unknown subject: worker's drop-count path
            cand = []
            for entry in entries:
                if not entry.matches(etype):
                    continue
                screened = self._screen_entry(entry, entry.ctx)
                if screened is None:
                    cand = None  # needs per-event work → exact path
                    break
                threshold, aggregates = screened
                ctx = entry.ctx
                tid = entry.trg.trigger_id
                prior = pairs.get(tid)
                count0 = prior[1] if prior is not None else ctx.get("count", 0)
                acc = prior[3] if prior is not None else 0
                if not isinstance(count0, int) or count0 + acc + m >= threshold:
                    cand = None  # could fire inside this batch
                    break
                cand.append((tid, ctx, count0, threshold, aggregates))
            if not cand:  # ineligible, or zero enabled candidates (DLQ path)
                continue
            for tid, ctx, count0, threshold, aggregates in cand:
                prior = pairs.get(tid)
                if prior is None:
                    pairs[tid] = [ctx, count0, threshold, m]
                    if aggregates:
                        aggregating[tid] = []
                else:
                    prior[3] += m
            claimed[subject] = [c[0] for c in cand]
        if len(claimed) < self.min_subjects or not pairs:
            return None

        # Pre-extracted result columns: one C-level gather per (subject,
        # trigger) run, in the same subject-slice order the grouped path's
        # batched conditions would append in.  On a ``_D_RESULT`` frame the
        # whole-batch result column already exists inside the decoded frame.
        if aggregating:
            res = cols.results() if cols is not None else None
            for subject, tids in claimed.items():
                acc_cols = [aggregating[t] for t in tids if t in aggregating]
                if not acc_cols:
                    continue
                sidx = by_subject[subject]
                column = ([res[i] for i in sidx] if res is not None
                          else [_result_of(batch[i]) for i in sidx])
                for col in acc_cols:
                    col.extend(column)

        rows = list(pairs.values())
        n_rows = len(rows)
        counts = np.fromiter((r[1] for r in rows), np.int32, n_rows)
        expected = np.fromiter((r[2] for r in rows), np.int32, n_rows)
        lens = np.fromiter((r[3] for r in rows), np.int64, n_rows)
        # The routed event batch as the kernel sees it is contiguous runs of
        # trigger-row ids (−1 would be padding; none is needed here) — the
        # row-id expansion lives next to the kernel.
        new_counts, fired = self._join_segments(lens, counts, expected,
                                                self._join)
        if fired.any():  # pragma: no cover - screening guarantees this
            raise AssertionError("vector join plane screening let a fire through")
        total = 0
        for i, (tid, row) in enumerate(pairs.items()):
            ctx = row[0]
            ctx["count"] = int(new_counts[i])
            column = aggregating.get(tid)
            if column:
                results = ctx.get("results") or []
                results.extend(column)
                ctx["results"] = results
            total += row[3]
        stats.activations += total
        self.calls += 1
        self.events += int(lens.sum())

        if len(claimed) == len(by_subject):
            # Fully claimed: nothing materializes even on the columnar path.
            return (ids if cols is None else list(ids)), []
        evs = cols.events() if cols is not None else batch
        return ([ids[i] for i, s in enumerate(subjects) if s in claimed],
                [evs[i] for i, s in enumerate(subjects) if s not in claimed])
