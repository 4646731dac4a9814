"""TF-Worker: the per-workflow event processor (paper §4).

Processing pipeline per batch (§3.2 trigger life-cycle + §3.4 fault tolerance):

  consume → dedup by event id → **group** by (subject, type) →
  **activate** (evaluate Conditions over event *slices* — the batch plane) →
  **fire** (run Action; transient triggers deactivate) →
  checkpoint: persist context *deltas* → commit processed events → redrive DLQ.

The batch plane: instead of a per-event interpreter walk (registry dispatch +
context wrap per event), a consumed batch is grouped once by
``(subject, type)`` and each matching trigger evaluates its condition over
the whole arrival-ordered slice via the batched-condition protocol
(``conditions.BATCHED_CONDITIONS``).  Groups that are provably pure counting
are further folded into one segmented-sum array op by the ``VectorJoinPlane``
(the ``event_join`` kernel's algorithm).  Conditions without a batched
implementation degrade to the identical scalar path per slice.  Set
``batch_plane=False`` to run the legacy per-event interpreter (kept as the
parity oracle).

The action plane (the fire path made O(batch)): a *fire-run* condition
(``conditions.FIRE_RUN_CONDITIONS``) reports every fire position of a slice
in one call and a batched action (``actions.BATCHED_ACTIONS``) handles the
whole run of fires in one call — so a trigger that fires on (nearly) every
event (Table-1 noop, fan-out produce) costs two Python calls per slice
instead of one condition + one action round-trip per event.  Gated per
worker by ``action_plane``; transient triggers and scalar-only actions
(``invoke``/``intercepted``/``pyfunc``) always keep the per-fire path.

Ordering contract: slices preserve per-subject arrival order (the bus's
per-key guarantee); cross-subject interleaving within a batch is relaxed —
the at-least-once event store contract already requires consumers to
tolerate reordering and redelivery, and parity tests pin the semantics.

Crash-consistency contract: contexts are persisted *before* events are
committed, so after a crash the event broker re-delivers uncommitted events
and replaying them over the last checkpointed contexts reconstructs the state
(conditions are idempotent; the built-in aggregators can additionally dedup by
event id inside their context for exactly-once counting across the
persist/commit window).  Checkpoints are incremental: only dirty context
*keys* (``TriggerContext.take_delta``) and dirty trigger ids are written.

Out-of-order sequences: an event whose trigger exists but is *disabled* goes
to the Dead Letter Queue and is redriven when any trigger state changes
(exactly the A→B example in §3.4).
"""
from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .actions import (ACTIONS, BATCHED_ACTIONS, batchable_action, run_action,
                      run_condition)
from .batch import CLAIMABLE_CONDITIONS
from .conditions import BATCHED_CONDITIONS, CONDITIONS, FIRE_RUN_CONDITIONS
from .context import TriggerContext
from .device import resolve_device
from .events import CloudEvent
from ..kernels.event_join.dispatch import JoinBackendError
from ..obs.trace import inject as _trace_inject
from .eventstore import EventStore
from .functions import FunctionBackend
from .policy import (ActionTimeout, AUTO_REDRIVE_REASONS, RETRY_STATE_KEY,
                     REASON_ACTION_ERROR, REASON_CONDITION_ERROR,
                     REASON_DISABLED, REASON_TIMEOUT, RetryPolicy,
                     call_with_timeout, quarantined, reason_counter_name)
from .statestore import StateStore
from .triggers import Trigger


class WorkerStats:
    """Hot-loop counters.  ``snapshot``/``merge``/``fold`` are THE folding
    helpers — both shard pools (thread and process) aggregate lifetime
    totals through them, so the two runtimes can't drift on what a stat
    means or which keys exist."""

    FIELDS = ("events_processed", "activations", "fires", "batches",
              "dlq_events", "action_retries", "poison_events",
              "action_timeouts")
    __slots__ = FIELDS

    def __init__(self) -> None:
        self.events_processed = 0
        self.activations = 0
        self.fires = 0
        self.batches = 0
        self.dlq_events = 0
        # failure-policy plane (core.policy): failed runs rescheduled under a
        # RetryPolicy, events quarantined on budget exhaustion, and attempts
        # cut short by the action watchdog
        self.action_retries = 0
        self.poison_events = 0
        self.action_timeouts = 0

    def snapshot(self) -> Dict[str, int]:
        return {f: getattr(self, f) for f in self.FIELDS}

    def merge(self, other) -> "WorkerStats":
        """Add another ``WorkerStats`` (or a snapshot dict) into this one."""
        if isinstance(other, WorkerStats):
            other = other.snapshot()
        for f in self.FIELDS:
            setattr(self, f, getattr(self, f) + other.get(f, 0))
        return self

    @staticmethod
    def fold(into: Dict[str, float], frm) -> Dict[str, float]:
        """Accumulate a stats mapping (snapshot or ``WorkerStats``) into a
        plain dict, preserving rider keys (e.g. the process runtime's
        ``cpu_seconds``) that travel alongside the core fields."""
        if isinstance(frm, WorkerStats):
            frm = frm.snapshot()
        for k, v in frm.items():
            into[k] = into.get(k, 0) + v
        return into


class _Entry:
    """Compiled per-subject dispatch entry: registry lookups and the trigger's
    context resolved once (invalidated on any trigger-structure change)."""

    __slots__ = ("trg", "ctx", "cspec", "cname", "cfn", "bfn", "rfn",
                 "aspec", "afn", "bafn", "policy")

    def __init__(self, trg: Trigger, ctx: TriggerContext) -> None:
        self.trg = trg
        self.ctx = ctx
        self.cspec = trg.condition
        self.cname = self.cspec["name"]
        self.cfn = CONDITIONS.get(self.cname) or (
            lambda c, e, s: run_condition(s, c, e))  # late-registered: raise like generic path
        self.bfn = BATCHED_CONDITIONS.get(self.cname)
        self.rfn = FIRE_RUN_CONDITIONS.get(self.cname)
        self.aspec = trg.action
        self.afn = ACTIONS.get(self.aspec["name"]) or (
            lambda c, e, s: run_action(s, c, e))
        # the trigger's compiled RetryPolicy (None ⇒ pre-policy semantics:
        # failures print and the event commits as consumed)
        self.policy = (RetryPolicy.from_dict(trg.retry_policy)
                       if trg.retry_policy else None)
        # action-plane eligibility covers the whole action tree: a chain
        # wrapping a scalar-only sub-action must keep the per-fire path.
        # A per-attempt watchdog (``action_timeout``) needs per-fire calls,
        # so it pins the trigger to the scalar fire path at compile time —
        # zero cost in the hot loop.
        self.bafn = (BATCHED_ACTIONS.get(self.aspec["name"])
                     if batchable_action(self.aspec)
                     and (self.policy is None
                          or self.policy.action_timeout is None) else None)

    def matches(self, etype: str) -> bool:
        """Live candidacy check: enabled and (no filter or type match)."""
        trg = self.trg
        return trg.enabled and (not trg.event_type or trg.event_type == etype)


class TFWorker:
    def __init__(
        self,
        workflow: str,
        event_store: EventStore,
        state_store: StateStore,
        backend: FunctionBackend,
        batch_size: int = 512,
        commit_policy: str = "on_fire",  # "on_fire" (paper) | "every_batch"
        keep_event_log: bool = True,
        timers=None,
        partitions: Optional[Iterable[int]] = None,
        batch_plane: bool = True,
        action_plane: bool = True,
        vector_join: Optional[str] = None,
        metrics: bool = True,
        tracer=None,
        device="cuda",
    ) -> None:
        self.workflow = workflow
        self.device = resolve_device(device)
        self.event_store = event_store
        self.state_store = state_store
        self.backend = backend
        self.timers = timers
        self.batch_size = batch_size
        self.commit_policy = commit_policy
        self.keep_event_log = keep_event_log
        # Assigned partition subset (consumer-group shard mode).  None means
        # "the whole stream" (the classic single-worker deployment).  A shard
        # *owns* its partitions exclusively, so consume() never races another
        # consumer of the same events and per-event is_committed checks are
        # unnecessary when the store only hands out uncommitted events.
        self.partitions: Optional[tuple] = (
            tuple(partitions) if partitions is not None else None
        )
        # Hoisted once: partition routing for inline sink-event ownership,
        # bound to this workflow (partitioned stores may pin a per-workflow
        # partition count, so subject→partition depends on the workflow).
        _pf = getattr(event_store, "partition_for", None)
        self._partition_for = (
            None if _pf is None
            else lambda subject, _pf=_pf, _wf=workflow: _pf(subject, _wf))

        self.lock = threading.RLock()
        self.triggers: Dict[str, Trigger] = {}
        self._by_subject: Dict[str, List[Trigger]] = {}
        self._contexts: Dict[str, TriggerContext] = {}
        self._dispatch: Dict[str, List[_Entry]] = {}
        self._seen: set = set()          # processed-but-uncommitted event ids
        # event ids already counted in stats.dlq_events: a quarantined event
        # that cycles through redrive back into the DLQ is one DLQ'd event,
        # not one per cycle (ids are released once the event finally commits)
        self._dlq_counted: set = set()
        # failure-policy plane (core.policy).  ``_retry_after`` is the local
        # backoff timer wheel: event id → monotonic not-before; a deferred
        # event stays pending in the store and is filtered out of consumed
        # batches until its deadline (no hot redelivery; deadlines are
        # volatile, so a restarted worker retries immediately — the durable
        # attempt counter, not the clock, bounds the budget).  ``_no_commit``
        # collects ids that must not commit this batch (deferred or
        # quarantined mid-slice); ``_policy_dirty`` forces a checkpoint when
        # retry bookkeeping touched a context even though nothing fired.
        self._retry_after: Dict[str, float] = {}
        self._no_commit: set = set()
        self._policy_dirty = False
        self._policy_cache: Dict[str, Optional[RetryPolicy]] = {}
        self._sink: List[CloudEvent] = []  # internal event buffer (§5.2)
        self.event_log: List[CloudEvent] = []  # native event-sourcing log (§5.3)
        self.stats = WorkerStats()
        # The metrics plane (repro.obs): stage-boundary histograms recorded
        # at batch/slice granularity — see docs/ARCHITECTURE.md §7.  Default
        # on; ``metrics=False`` removes every recording from the hot loop.
        self._metrics = None
        if metrics:
            from ..obs.metrics import WorkerMetrics

            self._metrics = WorkerMetrics()
        # The trace plane: a Tracer makes fires open causal spans and stamps
        # produced events with (trace_id, span_id) extension attributes.
        self._tracer = tracer
        # (trace_id, span_id, span) of the fire currently running its
        # action — sink()/sink_batch() stamp it onto produced events.
        self._trace_ctx: Optional[tuple] = None
        self.finished = False
        self.result: Any = None
        self._stop = threading.Event()
        # Crash simulation (pool.crash_shard): a killed worker discards its
        # in-flight checkpoint/commit instead of completing it — the store
        # keeps its batch pending for redelivery to the next partition owner.
        self._killed = False
        # Why this worker left its runner ("stopped" | "finished" | "idle" |
        # "error"); None while scheduled.  The pool's reap() accounting reads
        # it — an idle-timeout departure is not a crash, whatever the lag is.
        self.exit_reason: Optional[str] = None
        self._dirty_triggers: set = set()
        # bumped on any trigger-structure change (add/intercept/enable):
        # the batch plane uses it to re-offer the rest of an in-flight slice
        # to triggers registered or enabled by an action mid-slice.
        self._struct_version = 0
        # triage pre-screen cache: whether any registered trigger could even
        # name-qualify for the vector join plane (recomputed per struct
        # version, so pure fire-run workloads skip the per-batch bucketing
        # pass entirely)
        self._joins_version = -1
        self._maybe_joins = True
        # while a slice evaluation is in flight: the slice index of the event
        # whose condition/action is currently running, so a dynamically
        # added/enabled trigger can record exactly where it came online
        self._slice_pos: Optional[int] = None
        self._birth_pos: Dict[str, int] = {}
        self.last_active = time.monotonic()

        self.batch_plane = batch_plane
        # The action plane (fire-run fast path): collapse a whole slice's
        # evaluate→fire loop into one fire-run condition call + one batched
        # action call.  Only effective on the batch plane.
        self.action_plane = action_plane
        self._vector_plane = None
        if batch_plane:
            mode = vector_join or os.environ.get("TRIGGERFLOW_JOIN_BACKEND", "auto")
            # auto (resolved here alone) and bare cuda follow the worker's
            # device: the CUDA kernel on its own card, the plain torch
            # version on the CPU
            if mode == "auto" or (mode == "cuda" and self.device.type == "cuda"):
                mode = str(self.device) if self.device.type == "cuda" else "torch"
            if mode != "off":
                # no fallback: a backend that cannot be built raises here
                from .batch import VectorJoinPlane

                self._vector_plane = VectorJoinPlane(backend=mode)

        self._recover()

    # -- recovery / registration -------------------------------------------------
    def _recover(self) -> None:
        """Reload trigger defs + last checkpointed contexts (restart path)."""
        specs = self.state_store.get_triggers(self.workflow)
        ckpt = self.state_store.get_contexts(self.workflow)
        for tid, spec in specs.items():
            trg = Trigger.from_dict(spec)
            if tid in ckpt:
                trg.context = ckpt[tid]
            self._index(trg)
        meta = self.state_store.get_workflow(self.workflow) or {}
        if meta.get("status") in ("succeeded", "failed"):
            self.finished = True
            self.result = meta.get("result")

    def _index(self, trg: Trigger) -> None:
        self.triggers[trg.trigger_id] = trg
        for subj in trg.activation_events:
            self._by_subject.setdefault(subj, []).append(trg)

    def _invalidate_dispatch(self) -> None:
        # Clear in place: run_once may hold a subject's entries across a
        # slice, and a dynamic trigger added mid-batch must be visible to the
        # next slice lookup.
        self._dispatch.clear()
        self._struct_version += 1

    def _mark_trigger_dirty(self, trigger_id: str) -> None:
        self._dirty_triggers.add(trigger_id)

    def add_trigger(self, trg: Trigger, persist: bool = True) -> str:
        with self.lock:
            self._index(trg)
            self._invalidate_dispatch()
            if self._slice_pos is not None:
                self._birth_pos[trg.trigger_id] = self._slice_pos
            if persist:
                self.state_store.put_trigger(self.workflow, trg.trigger_id, trg.to_dict())
        return trg.trigger_id

    def add_dynamic_trigger(self, trg: Trigger) -> str:
        tid = self.add_trigger(trg)
        self._mark_trigger_dirty(tid)
        return tid

    def set_trigger_enabled(self, trigger_id: str, enabled: bool) -> None:
        with self.lock:
            trg = self.triggers[trigger_id]
            trg.enabled = enabled
            self._mark_trigger_dirty(trigger_id)
            # entries read `enabled` live, so the dispatch cache stays valid,
            # but an in-flight slice must learn a trigger came (back) online
            self._struct_version += 1
            if enabled and self._slice_pos is not None:
                self._birth_pos[trigger_id] = self._slice_pos

    def intercept(self, trigger_id: str, interceptor_action: Dict[str, Any]) -> None:
        """Wrap a trigger's action with an interceptor (Def. 5)."""
        with self.lock:
            trg = self.triggers[trigger_id]
            trg.action = {"name": "intercepted", "interceptor": interceptor_action,
                          "inner": trg.action}
            self._invalidate_dispatch()
            self.state_store.put_trigger(self.workflow, trigger_id, trg.to_dict())

    def intercept_by_condition(self, condition_name: str, interceptor_action: Dict[str, Any]) -> int:
        n = 0
        with self.lock:
            for trg in self.triggers.values():
                if trg.condition.get("name") == condition_name:
                    self.intercept(trg.trigger_id, interceptor_action)
                    n += 1
        return n

    # -- context plumbing ---------------------------------------------------------
    def context_of(self, trigger_id: str) -> TriggerContext:
        ctx = self._contexts.get(trigger_id)
        if ctx is None:
            trg = self.triggers[trigger_id]
            ctx = TriggerContext(trg.context, self, trigger_id)
            self._contexts[trigger_id] = ctx
        return ctx

    def sink(self, event: CloudEvent) -> None:
        """Internal event production from condition/action code (§5.2)."""
        tc = self._trace_ctx
        if tc is not None:
            _trace_inject((event,), tc[0], tc[1])
            self._tracer.persist_open(tc[2])
        self._sink.append(event)
        m = self._metrics
        if m is None:
            self.event_store.publish(self.workflow, event)
        else:
            t0 = time.perf_counter()
            self.event_store.publish(self.workflow, event)
            m.publish.observe(time.perf_counter() - t0)

    def sink_batch(self, events: List[CloudEvent]) -> None:
        """Bulk ``sink``: one ``publish_batch`` (one append per partition,
        one commit-log write on durable stores) for a whole fire run."""
        if not events:
            return
        tc = self._trace_ctx
        if tc is not None:
            # downstream events link to the fire producing them; the open
            # span record is made durable *before* the children exist, so a
            # SIGKILL here can't orphan them (obs.trace module docs)
            _trace_inject(events, tc[0], tc[1])
            self._tracer.persist_open(tc[2])
        self._sink.extend(events)
        m = self._metrics
        if m is None:
            self.event_store.publish_batch(self.workflow, events)
        else:
            t0 = time.perf_counter()
            self.event_store.publish_batch(self.workflow, events)
            m.publish.observe_batch(len(events), time.perf_counter() - t0)

    def metrics_snapshot(self) -> Dict:
        """The worker's observability scrape: the registry snapshot with the
        ``WorkerStats`` counters folded in under their metric names — one
        export surface whether metrics recording is on or off."""
        from ..obs.metrics import empty_snapshot, fold_counters

        snap = (self._metrics.registry.snapshot()
                if self._metrics is not None else empty_snapshot())
        fold_counters(snap, {f"tf_{k}_total": v
                             for k, v in self.stats.snapshot().items()})
        return snap

    def set_result(self, value: Any) -> None:
        self.finished = True
        self.result = value
        meta = self.state_store.get_workflow(self.workflow) or {}
        meta.update({"status": (value or {}).get("status", "succeeded"), "result": value})
        self.state_store.put_workflow(self.workflow, meta)

    # -- partition-aware store access --------------------------------------------
    def _consume(self, max_events: int) -> List[CloudEvent]:
        if self.partitions is not None:
            return self.event_store.consume_partitions(
                self.workflow, self.partitions, max_events)
        return self.event_store.consume(self.workflow, max_events)

    def _commit(self, event_ids: List[str]) -> None:
        if self.partitions is not None:
            self.event_store.commit_partitions(
                self.workflow, self.partitions, event_ids)
        else:
            self.event_store.commit(self.workflow, event_ids)

    def _own_sink_events(self) -> List[CloudEvent]:
        """Sink events this worker may process inline.  ``sink()`` already
        published every event to the store; a partition-restricted worker must
        leave events routed to *another* shard's partition for their owner —
        processing them here would double-fire (the owner consumes them too)
        and this worker could never commit them anyway."""
        if self.partitions is None or self._partition_for is None:
            return self._sink
        own = set(self.partitions)
        part_for = self._partition_for
        return [e for e in self._sink if part_for(e.subject) in own]

    def _dlq_size(self) -> int:
        if self.partitions is not None:
            return self.event_store.dlq_size_partitions(
                self.workflow, self.partitions)
        return self.event_store.dlq_size(self.workflow)

    def _redrive(self, reasons=None) -> int:
        if self.partitions is not None:
            return self.event_store.redrive_partitions(
                self.workflow, self.partitions, reasons)
        return self.event_store.redrive(self.workflow, reasons)

    def _dlq_by_reason(self) -> Dict[str, int]:
        fn = getattr(self.event_store, "dlq_by_reason", None)
        return fn(self.workflow) if fn is not None else {}

    # -- the failure-policy plane (core.policy) -----------------------------------
    def _policy_of(self, trg: Trigger) -> Optional[RetryPolicy]:
        """Compiled RetryPolicy for the scalar-oracle path (the batch plane
        compiles it into ``_Entry``)."""
        tid = trg.trigger_id
        cache = self._policy_cache
        if tid not in cache:
            cache[tid] = (RetryPolicy.from_dict(trg.retry_policy)
                          if trg.retry_policy else None)
        return cache[tid]

    def _defer_filter(self, batch: List[CloudEvent]) -> List[CloudEvent]:
        """Drop events still inside their retry backoff window; deadlines
        that passed are released for this batch.  O(batch) only while
        retries are actually pending — the empty-map case is one falsy check
        in the callers."""
        ra = self._retry_after
        now = time.monotonic()
        kept: List[CloudEvent] = []
        for e in batch:
            t = ra.get(e.id)
            if t is None:
                kept.append(e)
            elif now >= t:
                del ra[e.id]
                kept.append(e)
        return kept

    def _policy_failure(self, ctx: TriggerContext, pol: RetryPolicy,
                        event: CloudEvent, kind: str) -> bool:
        """Record one failed condition/action run under a RetryPolicy.

        Bumps the durable attempt record in the trigger's context (it rides
        the next checkpoint, so the count survives SIGKILL and never resets
        on replay), then either schedules a backoff retry or — budget
        exhausted — quarantines the event with a structured ``poison:*``
        reason.  Either way the event is withheld from this batch's commit
        (``_no_commit``) and de-processed (``_seen``).  Returns True:
        callers must not treat the run as a fire."""
        stats = self.stats
        now = time.time()
        att = dict(ctx.get(RETRY_STATE_KEY) or {})
        rec = att.get(event.id)
        attempt = (rec[0] if rec else 0) + 1
        first = rec[1] if rec else now
        if kind == "timeout":
            stats.action_timeouts += 1
        if attempt >= pol.max_attempts:
            att.pop(event.id, None)
            ctx[RETRY_STATE_KEY] = att  # reassign: delta tracking sees it
            reason = {"timeout": REASON_TIMEOUT,
                      "condition": REASON_CONDITION_ERROR}.get(
                          kind, REASON_ACTION_ERROR)
            self.event_store.to_dlq(
                self.workflow,
                quarantined(event, reason, attempts=attempt,
                            first_failure=first, last_failure=now))
            stats.poison_events += 1
            if self._metrics is not None:
                self._metrics.registry.counter(
                    reason_counter_name(reason)).inc()
            if event.id not in self._dlq_counted:
                self._dlq_counted.add(event.id)
                stats.dlq_events += 1
            self._retry_after.pop(event.id, None)
        else:
            att[event.id] = [attempt, first, now]
            ctx[RETRY_STATE_KEY] = att
            stats.action_retries += 1
            self._retry_after[event.id] = (
                time.monotonic() + pol.backoff(attempt, event.id))
        self._seen.discard(event.id)
        self._no_commit.add(event.id)
        self._policy_dirty = True
        return True

    def _policy_success(self, ctx: TriggerContext, event: CloudEvent) -> None:
        """A retried event finally succeeded: drop its durable attempt
        record (bounds context growth) and its backoff timer."""
        att = ctx.get(RETRY_STATE_KEY)
        if att and event.id in att:
            att = dict(att)
            att.pop(event.id)
            ctx[RETRY_STATE_KEY] = att
            self._retry_after.pop(event.id, None)
            self._policy_dirty = True

    def _run_action_guarded(self, entry: "_Entry", event: CloudEvent) -> bool:
        """One scalar action attempt under the entry's policy (watchdog +
        retry/quarantine accounting).  Returns True when the run counts as a
        fire, False when it was deferred/quarantined by the policy."""
        pol = entry.policy
        try:
            if pol is not None and pol.action_timeout is not None:
                call_with_timeout(pol.action_timeout, entry.afn,
                                  entry.ctx, event, entry.aspec)
            else:
                entry.afn(entry.ctx, event, entry.aspec)
        except Exception as exc:  # noqa: BLE001
            traceback.print_exc()
            if pol is None:
                return True  # pre-policy semantics: a failed fire still fired
            kind = "timeout" if isinstance(exc, ActionTimeout) else "action"
            return not self._policy_failure(entry.ctx, pol, event, kind)
        if pol is not None:
            self._policy_success(entry.ctx, event)
        return True

    def _isolate_run(self, entry: "_Entry", fired: List[CloudEvent]) -> int:
        """Poison-slice isolation for the action plane: after a batched
        action failed under a policy, re-run the fire run per event so each
        one gets its own verdict (success / backoff / quarantine).  Safe
        because batched actions are contractually slice-isolating — they
        build their whole output before any side effect (actions.py docs) —
        so the failed call left no partial effects to double.  Returns the
        number of successful fires (the healthy remainder commits)."""
        ok = 0
        for event in fired:
            if self._run_action_guarded(entry, event):
                ok += 1
        return ok

    # -- the batch-plane hot loop --------------------------------------------------
    def _has_join_triggers(self) -> bool:
        """Cheap structural pre-screen for the vector join plane: does any
        trigger carry a condition the triage could claim at all?  Without
        one, the per-batch subject-bucketing pass is provably wasted."""
        if self._joins_version != self._struct_version:
            self._joins_version = self._struct_version
            self._maybe_joins = any(
                t.condition.get("name") in CLAIMABLE_CONDITIONS
                and not t.condition.get("exactly_once")
                for t in self.triggers.values())
        return self._maybe_joins

    def _entries_for(self, subject: str) -> List[_Entry]:
        entries = self._dispatch.get(subject)
        if entries is None:
            entries = [
                _Entry(trg, self.context_of(trg.trigger_id))
                for trg in self._by_subject.get(subject, ())
            ]
            self._dispatch[subject] = entries
        return entries

    def _eval_entry_slice(self, entry: _Entry, events: List[CloudEvent],
                          pos_base: int = 0) -> Tuple[int, bool, Optional[int]]:
        """Evaluate one trigger over an arrival-ordered, type-uniform slice.

        Implements the batched-condition protocol: the condition consumes a
        prefix and reports the first fire index (or None); the action runs
        with the firing event and evaluation resumes on the rest.  Returns
        ``(consumed_index_inclusive, fired_any, structure_changed_at)`` —
        consumption stops early only when a transient fire disables the
        trigger mid-slice; ``structure_changed_at`` is the earliest slice
        index at which condition/action code changed trigger structure
        (dynamic add, interception, enable/disable), so the caller can
        re-offer the tail to new candidates.  ``pos_base`` anchors
        ``self._slice_pos`` (the birth-position frame of the caller's slice)
        when ``events`` is itself a tail of that slice.
        """
        trg = entry.trg
        ctx = entry.ctx
        cspec = entry.cspec
        bfn = entry.bfn
        stats = self.stats
        fired_any = False
        changed_at: Optional[int] = None
        ver = self._struct_version
        pos = 0
        n = len(events)
        # The action plane: a fire-run condition reports *every* fire position
        # in one call and a batched action handles the whole run in one call —
        # the per-fire evaluate→act loop below collapses to two Python calls
        # per (trigger, slice).  Only for non-transient triggers (a transient
        # must stop at its first fire) whose action opted into batching (the
        # scalar per-fire path stays the oracle for invoke/intercepted/pyfunc
        # and any dynamic-structure choreography they perform).
        if (self.action_plane and entry.rfn is not None
                and entry.bafn is not None and not trg.transient):
            res = self._eval_entry_run(entry, events, pos_base)
            if res is not None:
                return res
        try:
            while pos < n:
                sl = events[pos:] if pos else events
                if bfn is not None:
                    # a structural change inside the batched call is anchored
                    # to the chunk start — the earliest (safe) re-offer point
                    self._slice_pos = pos_base + pos
                    try:
                        idx = bfn(ctx, sl, cspec)
                    except Exception:  # noqa: BLE001
                        # The failed call may have partially mutated the
                        # context, so re-sweeping the slice with the scalar
                        # fn would double-count.  Apply the scalar loop's
                        # exception semantics instead: condition error ⇒ no
                        # fire for the affected events.
                        traceback.print_exc()
                        stats.activations += n - pos
                        return n - 1, fired_any, changed_at
                    if self._struct_version != ver:
                        ver = self._struct_version
                        if changed_at is None:
                            changed_at = pos
                else:
                    idx = None
                    cfn = entry.cfn
                    for i, event in enumerate(sl):
                        self._slice_pos = pos_base + pos + i
                        try:
                            ok = cfn(ctx, event, cspec)
                        except Exception:  # noqa: BLE001
                            traceback.print_exc()
                            ok = False
                            if entry.policy is not None:
                                # condition error under a policy: retry the
                                # event later instead of committing it unfired
                                self._policy_failure(ctx, entry.policy,
                                                     event, "condition")
                        if self._struct_version != ver:
                            ver = self._struct_version
                            if changed_at is None:
                                changed_at = pos + i
                        if ok:
                            idx = i
                            break
                if idx is None:
                    stats.activations += n - pos
                    return n - 1, fired_any, changed_at
                stats.activations += idx + 1
                event = sl[idx]
                self._slice_pos = pos_base + pos + idx
                tracer = self._tracer
                span = None
                if tracer is not None:
                    span = tracer.fire_span(event, trg.trigger_id,
                                            self.workflow, 1)
                    if span is not None:
                        self._trace_ctx = (span["trace"], span["span"], span)
                try:
                    fired = self._run_action_guarded(entry, event)
                finally:
                    if span is not None:
                        tracer.end(span)
                        self._trace_ctx = None
                if self._struct_version != ver:
                    ver = self._struct_version
                    if changed_at is None:
                        changed_at = pos + idx
                pos += idx + 1
                if not fired:
                    # policy deferred/quarantined the attempt: no fire
                    # happened, so the trigger stays armed (a transient must
                    # still get its one real fire) and the slice continues —
                    # the healthy remainder commits, the event retries later
                    continue
                stats.fires += 1
                fired_any = True
                if trg.transient:
                    trg.enabled = False
                    self._mark_trigger_dirty(trg.trigger_id)
                    return pos - 1, fired_any, changed_at
                if not trg.enabled:
                    # the action disabled its own trigger: stop consuming, as
                    # the scalar oracle (which re-checks enabled per event)
                    # would — the tail re-enters candidate resolution
                    return pos - 1, fired_any, changed_at
            return n - 1, fired_any, changed_at
        finally:
            self._slice_pos = None

    def _eval_entry_run(self, entry: _Entry, events: List[CloudEvent],
                        pos_base: int = 0) -> Optional[Tuple[int, bool, Optional[int]]]:
        """The action-plane fast path: one fire-run condition call + one
        batched action call for the whole slice.  Returns ``None`` when the
        condition declines the run (dedup, timeouts, anything needing
        per-event care) — the caller then falls through to the per-fire
        protocol.  Structure changes made by the batched action are anchored
        at the run's first fire (the earliest event whose action could have
        caused them) for the caller's re-offer pass."""
        trg = entry.trg
        ctx = entry.ctx
        stats = self.stats
        n = len(events)
        ver = self._struct_version
        self._slice_pos = pos_base
        try:
            try:
                fires = entry.rfn(ctx, events, entry.cspec)
            except Exception:  # noqa: BLE001
                # same contract as a failed batched-condition call: the run
                # may have partially mutated the context, so re-sweeping
                # would double-count — condition error ⇒ no fire.
                traceback.print_exc()
                stats.activations += n
                return n - 1, False, (0 if self._struct_version != ver else None)
            if fires is None:
                return None
            changed_at: Optional[int] = 0 if self._struct_version != ver else None
            ver = self._struct_version
            stats.activations += n
            if not fires:
                return n - 1, False, changed_at
            fired = events if len(fires) == n else [events[i] for i in fires]
            self._slice_pos = pos_base + fires[0]
            tracer = self._tracer
            span = None
            if tracer is not None:
                span = tracer.fire_span(fired[0], trg.trigger_id,
                                        self.workflow, len(fires))
                if span is not None:
                    self._trace_ctx = (span["trace"], span["span"], span)
            m = self._metrics
            t_fire = time.perf_counter() if m is not None else 0.0
            n_fired = len(fires)
            try:
                entry.bafn(ctx, fired, entry.aspec)
            except Exception:  # noqa: BLE001
                traceback.print_exc()
                if entry.policy is not None:
                    # poison-slice isolation: re-run per event so the poison
                    # event alone is deferred/quarantined and the healthy
                    # remainder of the run commits (PR-3 slice pattern)
                    n_fired = self._isolate_run(entry, fired)
            else:
                if entry.policy is not None and ctx.get(RETRY_STATE_KEY):
                    for event in fired:
                        self._policy_success(ctx, event)
            finally:
                if m is not None:
                    m.fire.observe_batch(len(fires), time.perf_counter() - t_fire)
                if span is not None:
                    tracer.end(span)
                    self._trace_ctx = None
            if self._struct_version != ver and changed_at is None:
                changed_at = fires[0]
            stats.fires += n_fired
            return n - 1, n_fired > 0, changed_at
        finally:
            self._slice_pos = None

    def _process_group(self, subject: str, etype: str, events: List[CloudEvent],
                       processed_ids: List[str]) -> bool:
        """Activate matching triggers over one (subject, type) slice."""
        stats = self.stats
        fired_any = False
        pos = 0
        n = len(events)
        while pos < n:
            # Re-fetched per sub-run so mid-slice structural changes (dynamic
            # triggers, interception) are visible after a transient fire.
            entries = self._entries_for(subject)
            if not entries:
                # Unknown subject: drop (but count).  Nothing to wait for, so
                # the events are committed, exactly like the scalar path.
                # Counting goes through ``_dlq_counted`` like the quarantine
                # branch below: one increment per dropped event, however many
                # deliveries it takes to commit (at-least-once redelivery
                # under on_fire must not re-count).
                counted = self._dlq_counted
                for e in events[pos:]:
                    if e.id not in counted:
                        counted.add(e.id)
                        stats.dlq_events += 1
                processed_ids.extend(e.id for e in events[pos:])
                return fired_any
            sl = events[pos:] if pos else events
            cover = -1
            change_min: Optional[int] = None
            any_enabled = False
            evaluated = set()
            self._birth_pos.clear()  # birth positions are sl-frame relative
            for entry in entries:
                if not entry.matches(etype):
                    continue
                any_enabled = True
                evaluated.add(entry.trg.trigger_id)
                consumed, fired, changed_at = self._eval_entry_slice(entry, sl)
                if fired:
                    fired_any = True
                if consumed > cover:
                    cover = consumed
                if changed_at is not None and (
                        change_min is None or changed_at < change_min):
                    change_min = changed_at
            if not any_enabled:
                # All candidate triggers disabled → out-of-order → DLQ (§3.4),
                # tagged ``disabled`` so reason-filtered redrives can pick it
                # back up without touching poison quarantines.
                to_dlq = self.event_store.to_dlq
                seen_discard = self._seen.discard
                counted = self._dlq_counted
                for e in sl:
                    to_dlq(self.workflow, quarantined(e, REASON_DISABLED))
                    seen_discard(e.id)
                    if e.id not in counted:
                        counted.add(e.id)
                        stats.dlq_events += 1
                return fired_any
            if change_min is not None:
                # An action (or condition) changed trigger structure at slice
                # index ``change_min``: triggers registered or enabled there
                # must still see the rest of this sub-run's coverage — the
                # scalar loop re-resolves candidates per event (events beyond
                # ``cover`` re-enter the outer loop and see them naturally).
                if self._reoffer_tail(subject, etype, sl, change_min, cover,
                                      evaluated):
                    fired_any = True
            if cover == len(sl) - 1:  # common case: whole slice covered
                processed_ids.extend(e.id for e in sl)
            else:
                processed_ids.extend(e.id for e in sl[:cover + 1])
            pos += cover + 1
        return fired_any

    def _reoffer_tail(self, subject: str, etype: str, sl: List[CloudEvent],
                      change_min: int, cover: int, evaluated: set) -> bool:
        """Deliver the slice tail to candidates that appeared (or came
        online) mid-slice and were not part of the original sweep.  Each
        fresh trigger starts at its recorded *birth position* (the event
        whose condition/action brought it online — inclusive, matching the
        scalar oracle, whose live match-list iteration visits a just-added
        trigger for that very event), falling back to the sweep's earliest
        change point.  Loops because a re-offered trigger's action can add
        further triggers; terminates since every round consumes trigger ids
        into ``evaluated`` and a round without fresh candidates stops."""
        fired_any = False
        births = self._birth_pos
        while change_min <= cover:
            fresh = [
                entry for entry in self._entries_for(subject)
                if entry.trg.trigger_id not in evaluated and entry.matches(etype)
            ]
            if not fresh:
                break
            next_change: Optional[int] = None
            for entry in fresh:
                tid = entry.trg.trigger_id
                evaluated.add(tid)
                start = births.get(tid, change_min)
                if start > cover:
                    continue
                tail = sl[start:cover + 1]
                _consumed, fired, changed_at = self._eval_entry_slice(
                    entry, tail, pos_base=start)
                if fired:
                    fired_any = True
                if changed_at is not None:
                    abs_change = start + changed_at
                    if next_change is None or abs_change < next_change:
                        next_change = abs_change
            if next_change is None:
                break
            change_min = next_change
        return fired_any

    def run_once(self, max_events: Optional[int] = None) -> int:
        """Process one batch.  Returns number of events processed."""
        if not self.batch_plane:
            return self._run_once_scalar(max_events)
        with self.lock:
            batch = self._consume(max_events or self.batch_size)
            if self._retry_after and batch:
                # events inside their retry backoff window stay pending in
                # the store instead of hot-redelivering into the pipeline
                batch = self._defer_filter(batch)
            if not batch and not self._sink:
                return 0
            m = self._metrics
            if m is not None and batch:
                # publish→consume lag at batch granularity: the oldest
                # event's publish stamp bounds every event in the batch
                t_pub = batch[0].time
                if t_pub is not None:
                    m.consume_lag.observe_batch(
                        len(batch), max(0.0, time.time() - t_pub) * len(batch))
            # Stores that only ever hand out uncommitted events
            # (``UNCOMMITTED_ONLY``) make the per-event committed round-trip a
            # provable no-op; in-flight dedup against ``_seen`` suffices.
            check_committed = not getattr(
                self.event_store, "UNCOMMITTED_ONLY", False)
            workflow = self.workflow
            is_committed = self.event_store.is_committed if check_committed else None
            seen = self._seen
            seen_add = seen.add
            event_log = self.event_log if self.keep_event_log else None
            stats = self.stats
            vector_plane = self._vector_plane
            processed_ids: List[str] = []
            fired_any = False
            n_new = 0
            # Tier 1 — vectorized triage: when nothing needs per-event care
            # (no in-flight ids, store redelivers only uncommitted events, no
            # event-sourcing log), the pure-counting share of the batch is
            # folded into one segmented-sum array op and only the leftover
            # events enter the Python path.
            if (vector_plane is not None and not seen and is_committed is None
                    and event_log is None and not self._sink and len(batch) > 1
                    and self._has_join_triggers()):
                t_join = time.perf_counter() if m is not None else 0.0
                try:
                    res = vector_plane.triage(batch, self._entries_for, stats)
                except JoinBackendError:
                    # the join itself failed: the batch fails with it, and
                    # no other path takes it over
                    raise
                except Exception:  # noqa: BLE001
                    # e.g. a non-numeric ctx["expected"] set via introspection:
                    # screening raises before any context is mutated, so the
                    # exact path can safely take the whole batch (the scalar
                    # loop contains the same error per event).
                    traceback.print_exc()
                    res = None
                if res is not None:
                    handled_ids, batch = res
                    if m is not None and handled_ids:
                        m.join_kernel.observe_batch(
                            len(handled_ids), time.perf_counter() - t_join)
                    n_new += len(handled_ids)
                    processed_ids.extend(handled_ids)
                    # protect the uncommitted window: even under every_batch
                    # the checkpoint/commit can fail, and a retry must not
                    # re-count the redelivered events (their counters already
                    # advanced)
                    seen.update(handled_ids)
            queue = batch
            qi = 0
            t_eval = time.perf_counter() if m is not None else 0.0
            while qi < len(queue):
                # Group the segment into type-uniform *runs* per subject:
                # consecutive same-type events of one subject share a slice,
                # and a type change (e.g. a timeout between result events)
                # starts a new group — so same-subject arrival order is fully
                # preserved across types (the bus's per-key guarantee).
                groups: List[Tuple[str, str, List[CloudEvent]]] = []
                current: Dict[str, List] = {}  # subject -> [type, events]
                while qi < len(queue):
                    event = queue[qi]
                    qi += 1
                    eid = event.id
                    if eid in seen or (
                        is_committed is not None and is_committed(workflow, eid)
                    ):
                        continue  # at-least-once dedup (§3.4)
                    seen_add(eid)
                    if event_log is not None:
                        event_log.append(event)
                    n_new += 1
                    subject = event.subject
                    cur = current.get(subject)
                    if cur is not None and cur[0] == event.type:
                        cur[1].append(event)
                    else:
                        evs = [event]
                        current[subject] = [event.type, evs]
                        groups.append((subject, event.type, evs))
                for subject, etype, evs in groups:
                    if self._process_group(subject, etype, evs, processed_ids):
                        fired_any = True
                    # Drain internally-produced events in the same batch (§5.2).
                    if self._sink:
                        queue.extend(self._own_sink_events())
                        self._sink.clear()
            stats.events_processed += n_new
            stats.batches += 1
            if m is not None and n_new:
                m.batch_eval.observe_batch(n_new, time.perf_counter() - t_eval)
            if self._no_commit:
                # deferred/quarantined mid-slice: withheld from this commit
                # (a quarantined id that committed would poison its redrive)
                nc = self._no_commit
                processed_ids = [i for i in processed_ids if i not in nc]
                nc.clear()
            if processed_ids:
                self.last_active = time.monotonic()
            # Checkpoint: contexts first, then commit (§3.4 ordering).  Retry
            # bookkeeping (durable attempt counters) must reach the
            # checkpoint even when nothing fired, or a SIGKILL between
            # attempts would reset the budget.
            if (fired_any or self._policy_dirty
                    or (self.commit_policy == "every_batch" and processed_ids)):
                if m is None:
                    self._checkpoint(processed_ids)
                else:
                    t_ck = time.perf_counter()
                    self._checkpoint(processed_ids)
                    m.checkpoint.observe(time.perf_counter() - t_ck)
                self._policy_dirty = False
                if fired_any and self._dlq_size():
                    # fire progress may unblock out-of-order sequences:
                    # redrive the ``disabled`` class only — poison stays put
                    self._redrive(AUTO_REDRIVE_REASONS)
            return len(processed_ids)

    # -- the legacy per-event interpreter (parity oracle) --------------------------
    def _process_one(self, event: CloudEvent) -> bool:
        """Activate matching triggers for one event.  Returns True if any fired."""
        fired = False
        matches = self._by_subject.get(event.subject)
        if not matches:
            # Unknown subject: drop (but count). Sequenced-but-disabled triggers
            # are handled below; a totally unknown event has nothing to wait
            # for.  Guarded by ``_dlq_counted`` exactly like the batch plane's
            # unknown-subject branch and the quarantine path: one increment
            # per dropped event across redeliveries, never one per delivery.
            if event.id not in self._dlq_counted:
                self._dlq_counted.add(event.id)
                self.stats.dlq_events += 1
            return False
        any_enabled = False
        for trg in matches:
            if not trg.enabled:
                continue
            if trg.event_type and trg.event_type != event.type:
                continue
            any_enabled = True
            ctx = self.context_of(trg.trigger_id)
            pol = self._policy_of(trg)
            self.stats.activations += 1
            try:
                ok = run_condition(trg.condition, ctx, event)
            except Exception:  # noqa: BLE001
                traceback.print_exc()
                ok = False
                if pol is not None:
                    self._policy_failure(ctx, pol, event, "condition")
            if ok:
                tracer = self._tracer
                span = None
                if tracer is not None:
                    span = tracer.fire_span(event, trg.trigger_id,
                                            self.workflow, 1)
                    if span is not None:
                        self._trace_ctx = (span["trace"], span["span"], span)
                ran = True
                try:
                    if pol is not None and pol.action_timeout is not None:
                        call_with_timeout(pol.action_timeout, run_action,
                                          trg.action, ctx, event)
                    else:
                        run_action(trg.action, ctx, event)
                except Exception as exc:  # noqa: BLE001
                    traceback.print_exc()
                    if pol is not None:
                        kind = ("timeout" if isinstance(exc, ActionTimeout)
                                else "action")
                        ran = not self._policy_failure(ctx, pol, event, kind)
                else:
                    if pol is not None:
                        self._policy_success(ctx, event)
                finally:
                    if span is not None:
                        tracer.end(span)
                        self._trace_ctx = None
                if not ran:
                    continue  # deferred/quarantined: not a fire, stay armed
                self.stats.fires += 1
                fired = True
                if trg.transient:
                    trg.enabled = False
                    self._mark_trigger_dirty(trg.trigger_id)
        if not any_enabled:
            # All candidate triggers disabled → out-of-order event → DLQ (§3.4).
            self.event_store.to_dlq(self.workflow,
                                    quarantined(event, REASON_DISABLED))
            self._seen.discard(event.id)
            if event.id not in self._dlq_counted:
                self._dlq_counted.add(event.id)
                self.stats.dlq_events += 1
            return False
        return fired

    def _run_once_scalar(self, max_events: Optional[int] = None) -> int:
        """The pre-batch-plane per-event loop (``batch_plane=False``)."""
        with self.lock:
            batch = self._consume(max_events or self.batch_size)
            if self._retry_after and batch:
                batch = self._defer_filter(batch)
            if not batch and not self._sink:
                return 0
            m = self._metrics
            if m is not None and batch:
                t_pub = batch[0].time
                if t_pub is not None:
                    m.consume_lag.observe_batch(
                        len(batch), max(0.0, time.time() - t_pub) * len(batch))
            t_eval = time.perf_counter() if m is not None else 0.0
            # Same predicate as the batch plane: on an UNCOMMITTED_ONLY store
            # the per-event is_committed round-trip can never return True —
            # for partitioned *and* whole-stream consumers alike — so dedup
            # against the in-flight set alone suffices.
            check_committed = not getattr(
                self.event_store, "UNCOMMITTED_ONLY", False)
            processed_ids: List[str] = []
            fired_any = False
            queue = list(batch)
            i = 0
            while i < len(queue):
                event = queue[i]
                i += 1
                if event.id in self._seen or (
                    check_committed
                    and self.event_store.is_committed(self.workflow, event.id)
                ):
                    continue  # at-least-once dedup (§3.4)
                self._seen.add(event.id)
                if self.keep_event_log:
                    self.event_log.append(event)
                self.stats.events_processed += 1
                if self._process_one(event):
                    fired_any = True
                if event.id in self._seen:  # not DLQ'd
                    processed_ids.append(event.id)
                # Drain internally-produced events in the same batch (§5.2).
                if self._sink:
                    queue.extend(self._own_sink_events())
                    self._sink.clear()
            self.stats.batches += 1
            if m is not None and processed_ids:
                m.batch_eval.observe_batch(
                    len(processed_ids), time.perf_counter() - t_eval)
            if self._no_commit:
                nc = self._no_commit
                processed_ids = [i for i in processed_ids if i not in nc]
                nc.clear()
            if processed_ids:
                self.last_active = time.monotonic()
            # Checkpoint: contexts first, then commit (§3.4 ordering); see
            # run_once — attempt counters checkpoint even without fires.
            if (fired_any or self._policy_dirty
                    or (self.commit_policy == "every_batch" and processed_ids)):
                if m is None:
                    self._checkpoint(processed_ids)
                else:
                    t_ck = time.perf_counter()
                    self._checkpoint(processed_ids)
                    m.checkpoint.observe(time.perf_counter() - t_ck)
                self._policy_dirty = False
                if fired_any and self._dlq_size():
                    self._redrive(AUTO_REDRIVE_REASONS)
            return len(processed_ids)

    def _checkpoint(self, processed_ids: List[str]) -> None:
        """Persist what changed — context deltas and dirty trigger ids only —
        then commit the batch (§3.4 ordering)."""
        if self._killed:
            # Crashed mid-batch (crash_shard): discard — nothing is persisted
            # and nothing commits, so the whole batch stays pending in the
            # store and is redelivered to the partitions' next owner.
            return
        deltas = {}
        dirty_ctxs = []
        for tid, ctx in self._contexts.items():
            if ctx.dirty:
                deltas[tid] = ctx.build_delta()
                dirty_ctxs.append(ctx)
        if deltas:
            # a store failure raises here with dirty tracking intact, so the
            # deltas are re-emitted on the next checkpoint attempt
            self.state_store.put_contexts_delta(self.workflow, deltas)
            for ctx in dirty_ctxs:
                ctx.mark_checkpointed()
        if self._dirty_triggers:
            specs = {
                tid: self.triggers[tid].to_dict()
                for tid in self._dirty_triggers
                if tid in self.triggers
            }
            if specs:
                self.state_store.put_triggers(self.workflow, specs)
            self._dirty_triggers.clear()
        self._commit(processed_ids)
        if self._tracer is not None:
            # span durability rides the checkpoint: a batch's fire spans hit
            # the segment sink with the same cadence as its effects
            self._tracer.flush()
        self._seen.difference_update(processed_ids)
        if self._dlq_counted:
            # a once-quarantined event that finally committed leaves the DLQ
            # lifecycle: a *future* quarantine is a new one and counts again
            self._dlq_counted.difference_update(processed_ids)

    def failure_diagnostics(self) -> str:
        """One-line stuck-workflow triage: lag, DLQ depth by reason, pending
        retry backoffs — so a CI timeout traceback is debuggable alone."""
        try:
            lag = self.event_store.lag(self.workflow)
        except Exception:  # noqa: BLE001 - diagnostics never mask the timeout
            lag = "?"
        try:
            dlq = self._dlq_by_reason() or self._dlq_size()
        except Exception:  # noqa: BLE001
            dlq = "?"
        return (f"lag={lag} dlq={dlq} deferred_retries={len(self._retry_after)} "
                f"uncommitted_inflight={len(self._seen)}")

    # -- loops ------------------------------------------------------------------------
    def run_until_complete(self, timeout: float = 60.0, poll: float = 0.001) -> Any:
        """Drive the worker until the workflow ends (deterministic mode)."""
        deadline = time.monotonic() + timeout
        while not self.finished:
            n = self.run_once()
            if n == 0:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"workflow {self.workflow} did not finish: "
                        + self.failure_diagnostics())
                time.sleep(poll)
        return self.result

    def run_forever(self, poll: float = 0.002, idle_timeout: Optional[float] = None) -> None:
        """Threaded mode; exits on stop(), workflow end, or idle_timeout
        (the latter is how KEDA-style scale-to-zero reclaims the worker).
        Every exit path records ``exit_reason`` ("stopped" | "finished" |
        "idle" | "error"), so a reaper can classify the departure without
        peeking at private state — see ``stopped`` / ``crashed``."""
        self.exit_reason = None
        try:
            while not self._stop.is_set() and not self.finished:
                n = self.run_once()
                if n == 0:
                    if idle_timeout is not None and time.monotonic() - self.last_active > idle_timeout:
                        self.exit_reason = "idle"
                        return
                    time.sleep(poll)
            self.exit_reason = "finished" if self.finished else "stopped"
        except BaseException:
            self.exit_reason = "error"
            raise

    def stop(self) -> None:
        self._stop.set()

    @property
    def stopped(self) -> bool:
        """True once a stop (or kill) was requested — the public face of the
        stop flag, for reapers deciding whether a dead loop was asked to
        die."""
        return self._stop.is_set()

    @property
    def crashed(self) -> bool:
        """Did this worker's loop die *unexpectedly*?  Only meaningful after
        the loop exited: a recorded ``error``, or no recorded reason at all
        on a worker that finished nothing and was never told to stop (a
        thread that died mid-flight).  Idle/stop/finish departures — whatever
        the lag at reap time — are clean scale-downs, not crashes."""
        return not self.finished and (
            self.exit_reason == "error"
            or (self.exit_reason is None and not self._stop.is_set()))

    def kill(self) -> None:
        """Simulate a crash: stop consuming AND discard any in-flight
        checkpoint/commit (``_checkpoint`` becomes a no-op).  In-memory
        context mutations die with the worker object; events it processed
        but never committed stay pending in the store — exactly the state a
        SIGKILLed process leaves behind (§3.4 recovery replays them over the
        last durable checkpoint)."""
        self._killed = True
        self._stop.set()
