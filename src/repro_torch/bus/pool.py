"""Sharded TF-Worker pool over a partitioned event bus.

One workflow is served by N ``ShardWorker`` shards.  A ``ConsumerGroup``
assigns each shard a disjoint partition subset; shards consume, activate and
fire triggers exactly like the classic single ``TFWorker`` (they *are*
TFWorkers), but only over their own partitions.  Because the default router
keys partitions by event subject, a trigger's causally-related events land on
one shard and its context is never contended across shards.

Rebalance semantics (join/leave/crash) follow Kafka: a partition always
restarts from its committed offset, so on any assignment change a shard
resets its volatile state to the last checkpoint (``rebalance_reset``) and
uncommitted events are simply redelivered — the same at-least-once replay
path the paper uses for crash recovery (§3.4).

Sharding constraint: trigger *contexts* live with the shard that owns the
trigger's subject partition and are not synchronized across shards.
Cross-trigger introspection (Def. 5 — e.g. a Map action setting the
downstream join trigger's ``expected``) therefore requires the involved
subjects to share a partition; route them together with a custom
``partitioner`` on the ``PartitionedEventStore`` (e.g. hash on a workflow
stage prefix).  Cross-shard context routing is future work.
"""
from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

from ..core.device import resolve_device
from ..core.eventstore import EventStore
from ..core.functions import FunctionBackend
from ..core.policy import REASON_DISABLED, CircuitBreaker
from ..core.statestore import StateStore
from ..core.triggers import Trigger
from ..core.worker import TFWorker, WorkerStats
from ..obs.metrics import empty_snapshot, fold_counters, merge_snapshot
from .group import ConsumerGroup


class ShardWorker(TFWorker):
    """A TF-Worker that owns an exclusive partition subset of one workflow.

    The batch-plane loop (``TFWorker.run_once``) already gives shards their
    two fast-path specializations: exclusive partition ownership elides the
    per-event committed check (``UNCOMMITTED_ONLY``), and the compiled
    per-subject dispatch resolves registry lookups and trigger contexts once
    per slice.  What remains here is membership identity and the rebalance
    contract.
    """

    def __init__(self, member: str, *args, **kwargs) -> None:
        self.member = member
        super().__init__(*args, **kwargs)

    def rebalance_reset(self) -> None:
        """Reset volatile state to the last checkpoint.

        Called (with ``self.lock`` held by the pool) whenever this shard's
        partition assignment changes.  Processed-but-uncommitted events are
        still pending in the store and will be redelivered — replaying them
        over the checkpointed contexts is exactly the §3.4 crash-recovery
        contract, applied at rebalance points.
        """
        self._seen.clear()
        self._sink.clear()
        self._dlq_counted.clear()
        specs = self.state_store.get_triggers(self.workflow)
        ckpt = self.state_store.get_contexts(self.workflow)
        for tid, trg in self.triggers.items():
            base = specs.get(tid, {}).get("context", trg.context)
            trg.context = dict(ckpt.get(tid, base))
        self._contexts.clear()
        self._invalidate_dispatch()  # cached entries hold the old contexts


class _Runner(threading.Thread):
    """One runner thread multiplexing several shard *tasks* (Kafka-Streams
    style: task count — shards — is decoupled from thread count, so scaling
    shards past the core count doesn't buy GIL churn).

    A shard leaves its runner when it is stopped, finishes its workflow,
    idles past ``idle_timeout`` (KEDA-style scale-down), or its batch raises;
    the departure *reason* is recorded on the worker (``exit_reason``) and
    ``on_exit`` fires so the pool can react immediately — in particular a
    batch that raised must surrender its partitions right away, not wait for
    someone to call ``reap()``.  The runner exits once it owns no shards."""

    def __init__(self, name: str, idle_timeout: Optional[float], poll: float,
                 on_exit=None) -> None:
        super().__init__(name=name, daemon=True)
        self.workers: Dict[str, ShardWorker] = {}
        self.idle_timeout = idle_timeout
        self.poll = poll
        self.on_exit = on_exit
        self.closing = False
        self._close_lock = threading.Lock()

    def add(self, member: str, worker: ShardWorker) -> bool:
        """Hand a shard task to this runner.  Returns False if the runner is
        on its way out (its loop saw an empty task set) — the caller must pick
        another runner, or the shard would never be scheduled."""
        with self._close_lock:
            if self.closing:
                return False
            worker.last_active = time.monotonic()
            worker.exit_reason = None
            self.workers[member] = worker
            return True

    def _drop(self, member: str, w: ShardWorker, reason: str) -> None:
        w.exit_reason = reason
        self.workers.pop(member, None)
        if self.on_exit is not None:
            try:
                self.on_exit(member, w)
            except Exception:  # noqa: BLE001 - pool reaction must not kill the runner
                traceback.print_exc()

    def run(self) -> None:
        while True:
            n = 0
            for member, w in list(self.workers.items()):
                if w._stop.is_set() or w.finished:
                    self._drop(member, w,
                               "finished" if w.finished else "stopped")
                    continue
                try:
                    n += w.run_once()
                except Exception:  # noqa: BLE001 - a broken shard must not kill siblings
                    traceback.print_exc()
                    self._drop(member, w, "error")
                    continue
                if self.idle_timeout is not None and \
                        time.monotonic() - w.last_active > self.idle_timeout:
                    self._drop(member, w, "idle")
            if not self.workers:
                with self._close_lock:
                    if not self.workers:  # nothing raced in: commit to exit
                        self.closing = True
                        return
            elif n == 0:
                time.sleep(self.poll)


class _WorkflowShards:
    __slots__ = ("group", "shards", "runner_of", "next_id",
                 "failures", "failed_unreaped", "rebalances", "retired",
                 "breaker")

    def __init__(self, num_partitions: int,
                 breaker: Optional[CircuitBreaker] = None) -> None:
        self.group = ConsumerGroup(num_partitions)
        self.shards: Dict[str, ShardWorker] = {}
        self.runner_of: Dict[str, _Runner] = {}
        self.next_id = 0
        self.failures = 0        # shards whose batch raised (lifetime total)
        self.failed_unreaped = 0  # …not yet folded into a reap() report
        self.rebalances = 0      # partition-assignment changes (lifetime)
        # lifetime stats of departed shards, folded via WorkerStats so they
        # aggregate identically to the process pool's retired_stats
        self.retired = WorkerStats()
        # crash-loop breaker: consecutive-crash streak gates start_shards
        self.breaker = breaker if breaker is not None else CircuitBreaker()


class ShardedWorkerPool:
    """Runs N TF-Worker shards per workflow over a ``PartitionedEventStore``."""

    def __init__(
        self,
        event_store: EventStore,
        state_store: StateStore,
        backend: FunctionBackend,
        timers=None,
        commit_policy: str = "on_fire",
        batch_size: int = 512,
        keep_event_log: bool = True,
        batch_plane: bool = True,
        action_plane: bool = True,
        metrics: bool = True,
        tracer=None,
        breaker: Optional[Dict[str, Any]] = None,
        device="cuda",
    ) -> None:
        if not hasattr(event_store, "consume_partitions"):
            raise TypeError(
                "ShardedWorkerPool needs a partitioned event store "
                "(missing consume_partitions); got %r" % type(event_store).__name__)
        self.event_store = event_store
        self.state_store = state_store
        self.backend = backend
        # every shard's worker, and so its join backend, on this one device
        self.device = resolve_device(device)
        self.timers = timers
        self.commit_policy = commit_policy
        self.batch_size = batch_size
        self.keep_event_log = keep_event_log
        self.batch_plane = batch_plane
        self.action_plane = action_plane
        # Observability (repro.obs): per-shard metric registries, merged on
        # scrape (obs_snapshot); one shared tracer (its collector's ring
        # buffer is append-atomic, so shard threads share it lock-free).
        self.metrics_enabled = metrics
        self.tracer = tracer
        # CircuitBreaker kwargs applied to every workflow's crash-loop
        # breaker (threshold / backoff_* / cooldown — see core.policy).
        self.breaker_conf = dict(breaker) if breaker else {}
        self._lock = threading.RLock()
        self._wfs: Dict[str, _WorkflowShards] = {}

    # -- membership ------------------------------------------------------------
    def _np_for(self, workflow: str) -> int:
        npf = getattr(self.event_store, "num_partitions_for", None)
        return npf(workflow) if npf is not None \
            else self.event_store.num_partitions

    def _wf(self, workflow: str) -> _WorkflowShards:
        wp = self._wfs.get(workflow)
        n = self._np_for(workflow)
        if wp is None:
            wp = self._wfs.setdefault(
                workflow,
                _WorkflowShards(n, CircuitBreaker(**self.breaker_conf)))
        elif wp.group.num_partitions != n:
            # a per-workflow partition pin landed after this group was sized
            # (e.g. the workflow was touched before create_stream pinned it):
            # resize while empty; with live members the widths have diverged
            # for good and silently continuing would strand partitions
            if wp.group.members():
                raise ValueError(
                    "workflow %r is sharded over %d partitions but the store "
                    "now pins %d" % (workflow, wp.group.num_partitions, n))
            wp.group = ConsumerGroup(n)
        return wp

    # -- ScalablePool surface (see repro.core.autoscaler) -----------------------
    def lag(self, workflow: str) -> int:
        return self.event_store.lag(workflow)

    def num_partitions(self, workflow: str) -> int:
        """The workflow's partition count — the hard shard cap (a shard
        without a partition has nothing to consume)."""
        with self._lock:
            wp = self._wfs.get(workflow)
            if wp is not None:
                return wp.group.num_partitions
        return self._np_for(workflow)

    def breaker_of(self, workflow: str) -> CircuitBreaker:
        """The workflow's crash-loop breaker (autoscaler gate + tests)."""
        with self._lock:
            return self._wf(workflow).breaker

    def local_worker(self, workflow: str) -> Optional[ShardWorker]:
        """First in-process shard worker, if any (the service facade's
        classic-API bridge; process pools have no in-process workers)."""
        with self._lock:
            wp = self._wfs.get(workflow)
            if wp is None or not wp.shards:
                return None
            return next(iter(wp.shards.values()))

    def shard_ids(self, workflow: str) -> List[str]:
        with self._lock:
            wp = self._wfs.get(workflow)
            return list(wp.shards.keys()) if wp else []

    def shard_count(self, workflow: str) -> int:
        with self._lock:
            wp = self._wfs.get(workflow)
            return len(wp.shards) if wp else 0

    def live_shard_count(self, workflow: str) -> int:
        """Shards currently owned by a live runner thread (threaded mode)."""
        with self._lock:
            wp = self._wfs.get(workflow)
            if wp is None:
                return 0
            return sum(
                1 for m, r in wp.runner_of.items()
                if r.is_alive() and m in r.workers
            )

    def add_shard(self, workflow: str) -> str:
        with self._lock:
            wp = self._wf(workflow)
            member = f"shard-{wp.next_id}"
            wp.next_id += 1
            worker = ShardWorker(
                member,
                workflow,
                self.event_store,
                self.state_store,
                self.backend,
                batch_size=self.batch_size,
                commit_policy=self.commit_policy,
                keep_event_log=self.keep_event_log,
                timers=self.timers,
                partitions=(),
                batch_plane=self.batch_plane,
                action_plane=self.action_plane,
                metrics=self.metrics_enabled,
                tracer=self.tracer,
                device=self.device,
            )
            wp.shards[member] = worker
            wp.group.join(member)
            self._rebalance(wp)
            return member

    def _retire(self, wp: _WorkflowShards, member: str) -> None:
        """Drop ``member`` and hand its partitions to the rest.  The victim's
        lock is taken once before rebalancing: an in-flight batch on a runner
        thread finishes (and commits/checkpoints) first, so a 'zombie' shard
        can never fire or commit concurrently with the new partition owner."""
        worker = wp.shards.pop(member)
        worker._stop.set()
        runner = wp.runner_of.pop(member, None)
        if runner is not None:
            runner.workers.pop(member, None)
        with worker.lock:  # fence: wait out any in-flight batch
            pass
        wp.group.leave(member)
        # a graceful leave keeps its lifetime counters (WorkerStats.merge —
        # the same fold the process pool applies to a clean child's exit
        # stats, so the two runtimes' lifetime totals mean the same thing)
        wp.retired.merge(worker.stats)
        wp.breaker.record_clean()
        self._rebalance(wp)

    def remove_shard(self, workflow: str, member: str) -> None:
        """Graceful leave: stop the shard, hand its partitions to the rest."""
        with self._lock:
            wp = self._wfs.get(workflow)
            if wp is not None and member in wp.shards:
                self._retire(wp, member)

    def crash_shard(self, workflow: str, member: str) -> None:
        """Simulate a shard crash: drop it with NO further checkpoint/commit.

        Unlike ``remove_shard`` (which fences and lets an in-flight batch
        finish, commit and checkpoint — a *graceful* leave), the victim is
        ``kill()``-ed first: an in-flight batch completes its in-memory work
        but **discards** its checkpoint/commit, so everything it consumed
        stays pending in the store and is redelivered to the shards the group
        reassigns those partitions to — redelivery happens *at the crash
        point*, not at the next batch boundary.  (In-process a thread cannot
        be preempted mid-batch; the real mid-batch SIGKILL lives in
        ``repro.bus.proc.ProcessShardPool``.)"""
        with self._lock:
            wp = self._wfs.get(workflow)
            if wp is None or member not in wp.shards:
                return
            worker = wp.shards.pop(member)
            worker.kill()  # in-flight batch now discards its commit
            runner = wp.runner_of.pop(member, None)
            if runner is not None:
                runner.workers.pop(member, None)
            with worker.lock:  # fence: wait out the (discarding) batch
                pass
            wp.group.leave(member)
            wp.breaker.record_crash()
            self._rebalance(wp)

    def _shard_exited(self, workflow: str, member: str, worker) -> None:
        """Runner callback: a shard left its runner.  Only a *failed* batch
        needs immediate action — the dead shard still owns its partitions and
        with no autoscaler loop calling ``reap()`` they would stall silently
        forever.  Surface the failure (stat + log) and rebalance now."""
        if worker.exit_reason != "error":
            return  # stopped / finished / idle: reap() accounts for these
        with self._lock:
            wp = self._wfs.get(workflow)
            if wp is None or wp.shards.get(member) is not worker:
                return  # already retired (reap/remove raced us)
            wp.shards.pop(member, None)
            wp.runner_of.pop(member, None)
            wp.failures += 1
            wp.failed_unreaped += 1
            wp.group.leave(member)
            wp.breaker.record_crash()
            self._rebalance(wp)
        print("[pool] shard %s of workflow %r failed its batch; "
              "partitions rebalanced to %d remaining shard(s)"
              % (member, workflow, self.shard_count(workflow)))

    def _rebalance(self, wp: _WorkflowShards) -> None:
        wp.rebalances += 1
        assignment = wp.group.assignment()
        granted: set = set()
        for member, worker in wp.shards.items():
            parts = tuple(assignment.get(member, ()))
            with worker.lock:
                if worker.partitions != parts:
                    worker.partitions = parts
                    worker.rebalance_reset()
            granted.update(parts)
        # lease-fenced stores (host-loss fault domain): a rebalance is the
        # only sanctioned ownership change, so it is the only place fence
        # latches clear.  With the breaker open no shards start, no
        # rebalance grants anything, and no lease is re-acquired — the
        # fencing plane honors the failure-policy plane's quarantine.
        reacquire = getattr(self.event_store, "reacquire_partition_leases",
                            None)
        if reacquire is not None and granted \
                and getattr(self.event_store, "lease_owner", None) is not None:
            for wf, w in self._wfs.items():
                if w is wp:
                    reacquire(wf, sorted(granted))
                    break

    def set_shard_count(self, workflow: str, count: int) -> List[str]:
        """Add/remove (drive-mode) shards to reach ``count``; returns ids."""
        with self._lock:
            while self.shard_count(workflow) < count:
                self.add_shard(workflow)
            wp = self._wfs.get(workflow)
            while wp is not None and len(wp.shards) > count:
                self.remove_shard(workflow, next(reversed(wp.shards)))
            return self.shard_ids(workflow)

    # -- threaded mode (autoscaler / benchmarks) --------------------------------
    def start_shards(
        self,
        workflow: str,
        count: int,
        idle_timeout: Optional[float] = None,
        poll: float = 0.002,
        max_threads: Optional[int] = None,
    ) -> List[str]:
        """Ensure ``count`` shard tasks exist and are scheduled on runner
        threads.  At most ``max_threads`` (default: core count) runners serve
        a workflow — shards are *tasks*, threads are execution slots."""
        with self._lock:
            wp = self._wf(workflow)
            need = count - len(wp.shards)
            if need > 0:
                # crash-loop breaker: a streak of shard crashes makes fresh
                # starts wait out an exponential backoff; past the threshold
                # the circuit opens (no starts) until a cooldown admits one
                # half-open probe.  Existing (stopped) shards reschedule
                # freely — only NEW capacity is gated.
                granted = wp.breaker.allow_start(need)
                if granted < need:
                    print("[pool] circuit breaker for workflow %r (%s, "
                          "streak=%d): granting %d/%d shard start(s)"
                          % (workflow, wp.breaker.state, wp.breaker.streak,
                             granted, need))
                for _ in range(granted):
                    self.add_shard(workflow)
            cap = max(1, max_threads or os.cpu_count() or 2)
            unassigned = []
            for member, worker in wp.shards.items():
                runner = wp.runner_of.get(member)
                if runner is not None and runner.is_alive() \
                        and not runner.closing and member in runner.workers:
                    continue
                worker._stop.clear()
                unassigned.append(member)
            if unassigned:
                on_exit = (lambda m, w, _wf=workflow:
                           self._shard_exited(_wf, m, w))
                slots = [r for r in set(wp.runner_of.values())
                         if r.is_alive() and not r.closing]
                fresh = [
                    _Runner(f"tf-{workflow}-runner-{wp.next_id}-{i}",
                            idle_timeout, poll, on_exit)
                    for i in range(min(cap - len(slots), len(unassigned)))
                ]
                slots += fresh
                if not slots:
                    fresh = [_Runner(f"tf-{workflow}-runner-{wp.next_id}-x",
                                     idle_timeout, poll, on_exit)]
                    slots = list(fresh)
                for i, member in enumerate(unassigned):
                    runner = slots[i % len(slots)]
                    if not runner.add(member, wp.shards[member]):
                        # runner committed to exit between the liveness check
                        # and the add — replace the slot with a fresh runner
                        runner = _Runner(
                            f"tf-{workflow}-runner-{wp.next_id}-r{i}",
                            idle_timeout, poll, on_exit)
                        fresh.append(runner)
                        slots[i % len(slots)] = runner
                        runner.add(member, wp.shards[member])
                    wp.runner_of[member] = runner
                for r in fresh:
                    r.start()
            return list(wp.shards.keys())

    def reap(self, workflow: str) -> Dict[str, Any]:
        """Remove shards that left their runner (idle scale-down, workflow
        end, crash, or runner death).  Returns
        ``{"reaped": n, "crashed": m, "reasons": {reason: count}}`` for the
        autoscaler's accounting (the ``ScalablePool`` contract).

        "Crashed" is decided by the *recorded departure reason*
        (``TFWorker.crashed``), not by circumstantial evidence: an
        idle-timeout departure is a clean scale-down even if new events
        arrived after the shard went idle (``stopped`` unset + lag > 0 is not
        a crash), while a failed batch or a runner thread that died without
        recording any reason is."""
        reaped = crashed = 0
        reasons: Dict[str, int] = {}
        with self._lock:
            wp = self._wfs.get(workflow)
            if wp is None:
                return {"reaped": 0, "crashed": 0, "reasons": {}}
            # failed-batch exits were retired immediately by _shard_exited;
            # fold them into this report exactly once
            if wp.failed_unreaped:
                reaped += wp.failed_unreaped
                crashed += wp.failed_unreaped
                reasons["error"] = wp.failed_unreaped
                wp.failed_unreaped = 0
            for member, runner in list(wp.runner_of.items()):
                if runner.is_alive() and member in runner.workers:
                    continue
                wp.runner_of.pop(member, None)
                worker = wp.shards.pop(member, None)
                wp.group.leave(member)
                reaped += 1
                reason = "lost" if worker is None else (
                    worker.exit_reason
                    or ("finished" if worker.finished else "lost"))
                reasons[reason] = reasons.get(reason, 0) + 1
                if worker is not None and worker.crashed:
                    crashed += 1
                    wp.breaker.record_crash()
                elif worker is not None:
                    wp.breaker.record_clean()
                    # clean departures keep their lifetime counters; a crash
                    # does not (its uncommitted work is replayed and counted
                    # again by the next owner — same as a SIGKILLed process
                    # shard, whose counters die with it)
                    wp.retired.merge(worker.stats)
            if reaped:
                self._rebalance(wp)
        return {"reaped": reaped, "crashed": crashed, "reasons": reasons}

    def stop(self, workflow: str) -> None:
        with self._lock:
            wp = self._wfs.get(workflow)
            if wp is None:
                return
            for worker in wp.shards.values():
                worker.stop()
            runners = list(set(wp.runner_of.values()))
        for r in runners:
            r.join(timeout=2.0)

    def stop_all(self) -> None:
        for wf in list(self._wfs.keys()):
            self.stop(wf)

    # -- deterministic drive mode (tests, benchmarks) ---------------------------
    def run_shard_once(
        self, workflow: str, member: str, max_events: Optional[int] = None
    ) -> int:
        with self._lock:
            worker = self._wf(workflow).shards[member]
        return worker.run_once(max_events)

    def drive(self, workflow: str, timeout: float = 30.0, poll: float = 0.0005) -> Any:
        """Round-robin every shard until the stream drains (or the workflow
        sets a result).  Single-threaded and deterministic."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                shards = list(self._wf(workflow).shards.values())
            n = 0
            for worker in shards:
                if worker.finished:
                    return worker.result
                n += worker.run_once()
            if n == 0:
                if self.event_store.lag(workflow) == 0:
                    return None
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"workflow {workflow} did not drain: "
                        + self.failure_diagnostics(workflow))
                time.sleep(poll)

    def failure_diagnostics(self, workflow: str) -> str:
        """One-line triage string for drain timeouts: per-partition lag, DLQ
        breakdown by reason, live shard count and breaker state."""
        try:
            lag_vec = self.event_store.partition_lags(workflow)
        except Exception:  # noqa: BLE001 - diagnostics must never raise
            lag_vec = []
        lags = lag_vec if isinstance(lag_vec, dict) else dict(enumerate(lag_vec))
        dbr = getattr(self.event_store, "dlq_by_reason", None)
        try:
            dlq = dbr(workflow) if dbr is not None else {}
        except Exception:  # noqa: BLE001
            dlq = {}
        with self._lock:
            wp = self._wfs.get(workflow)
            breaker = wp.breaker.snapshot() if wp else {}
        rl = getattr(self.event_store, "replica_lags", None)
        try:
            rep_lag = {p: n for p, n in enumerate(rl(workflow)) if n} \
                if rl is not None else {}
        except Exception:  # noqa: BLE001
            rep_lag = {}
        lh = getattr(self.event_store, "lease_holders", None)
        try:
            leases = lh(workflow) if lh is not None else {}
        except Exception:  # noqa: BLE001
            leases = {}
        return (f"lag={sum(lags.values())} "
                f"partition_lags={ {p: n for p, n in lags.items() if n} } "
                f"dlq_by_reason={dlq} "
                f"live_shards={self.live_shard_count(workflow)} "
                f"breaker={breaker} "
                f"replica_lag={rep_lag} "
                f"leases={leases}")

    # -- trigger management (broadcast to every shard) --------------------------
    def add_trigger(self, workflow: str, trigger: Trigger) -> str:
        with self._lock:
            wp = self._wfs.get(workflow)
            if wp is None or not wp.shards:
                self.state_store.put_trigger(
                    workflow, trigger.trigger_id, trigger.to_dict())
                return trigger.trigger_id
            first = True
            for worker in wp.shards.values():
                worker.add_trigger(trigger, persist=first)
                first = False
            return trigger.trigger_id

    def set_trigger_enabled(self, workflow: str, trigger_id: str, enabled: bool) -> None:
        """Broadcast the enable/disable to every shard.  Re-enabling also
        redrives the DLQ of the trigger's subject partitions (§3.4: events
        quarantined while the trigger was disabled become deliverable the
        moment its state changes)."""
        with self._lock:
            wp = self._wfs.get(workflow)
            if wp is None:
                return
            subjects: List[str] = []
            for worker in wp.shards.values():
                trg = worker.triggers.get(trigger_id)
                if trg is not None:
                    worker.set_trigger_enabled(trigger_id, enabled)
                    subjects = trg.activation_events
            if enabled and subjects:
                parts = {self.event_store.partition_for(s, workflow)
                         for s in subjects}
                # only ``disabled`` quarantines become deliverable again;
                # poison:* stays put until an operator redrives explicitly
                self.event_store.redrive_partitions(
                    workflow, parts, reasons=(REASON_DISABLED,))

    def trigger_context(self, workflow: str, trigger_id: str) -> Dict[str, Any]:
        """Context as seen by the shard that owns the trigger's subject."""
        with self._lock:
            wp = self._wfs.get(workflow)
            if wp is None:
                return {}
            for worker in wp.shards.values():
                trg = worker.triggers.get(trigger_id)
                if trg is None or not trg.activation_events:
                    continue
                p = self.event_store.partition_for(
                    trg.activation_events[0], workflow)
                if worker.partitions and p in worker.partitions:
                    return dict(worker.context_of(trigger_id))
            return {}

    # -- metrics (the autoscaler's and benchmark's observability surface) -------
    def folded_stats(self, workflow: str) -> WorkerStats:
        """Lifetime ``WorkerStats`` for the workflow: live shards plus
        cleanly-retired ones, all through ``WorkerStats.merge`` — the same
        folding helper ``ProcessShardPool`` uses, so the two runtimes cannot
        drift on what a lifetime total means."""
        total = WorkerStats()
        with self._lock:
            wp = self._wfs.get(workflow)
            if wp is None:
                return total
            total.merge(wp.retired)
            for w in wp.shards.values():
                total.merge(w.stats)
        return total

    def total_events_processed(self, workflow: str) -> int:
        return self.folded_stats(workflow).events_processed

    def total_fires(self, workflow: str) -> int:
        return self.folded_stats(workflow).fires

    def obs_snapshot(self, workflow: str) -> Dict[str, Any]:
        """The thread runtime's obs scrape: every live shard's registry
        snapshot merged (lock-free on the recording side — registries are
        per-shard), retired shards' counters folded back in, pool-level
        counters on top."""
        with self._lock:
            wp = self._wfs.get(workflow)
            workers = list(wp.shards.values()) if wp else []
            retired = wp.retired.snapshot() if wp else {}
            breaker = wp.breaker.snapshot() if wp else None
            pool_counters = {
                "tf_rebalance_total": wp.rebalances if wp else 0,
                "tf_shard_failures_total": wp.failures if wp else 0,
                "tf_circuit_open_total":
                    breaker["opened_total"] if breaker else 0,
            }
        snap = empty_snapshot()
        for w in workers:
            merge_snapshot(snap, w.metrics_snapshot())
        fold_counters(snap, {f"tf_{k}_total": v for k, v in retired.items()})
        fold_counters(snap, pool_counters)
        g = snap["gauges"]
        g["tf_restart_backoff_seconds"] = g.get("tf_restart_backoff_seconds", 0.0) \
            + (breaker["restart_backoff_seconds"] if breaker else 0.0)
        # host-loss fault domain (lease-fenced / replicated stores only):
        # fenced writes are a store-level counter (the threads share one
        # store instance), replication lag is the store client's deficit
        if getattr(self.event_store, "lease_owner", None) is not None:
            fold_counters(snap, {"tf_fenced_writes_total":
                                 self.event_store.fenced_writes})
        rep_stats = getattr(self.event_store, "replication_stats", None)
        if rep_stats is not None:
            try:
                g["tf_replication_lag_bytes"] = (
                    g.get("tf_replication_lag_bytes", 0)
                    + rep_stats()["lag_bytes"])
            except Exception:  # noqa: BLE001 - metrics must never raise
                # tfcheck: allow[seam-safety] scrape gauge is best-effort; a raising store stat must not break obs_snapshot
                pass
        return snap

    def metrics(self, workflow: str) -> Dict[str, Any]:
        with self._lock:
            wp = self._wfs.get(workflow)
            shards = dict(wp.shards) if wp else {}
            return {
                "shards": len(shards),
                "live_shards": self.live_shard_count(workflow),
                "shard_failures": wp.failures if wp else 0,
                "rebalances": wp.rebalances if wp else 0,
                "breaker": wp.breaker.snapshot() if wp else {},
                "generation": wp.group.generation if wp else 0,
                "assignment": {m: list(w.partitions or ()) for m, w in shards.items()},
                "partition_lags": self.event_store.partition_lags(workflow),
                "commit_offsets": self.event_store.commit_offsets(workflow),
                "events_processed": {
                    m: w.stats.events_processed for m, w in shards.items()},
                "total_lag": self.event_store.lag(workflow),
                "obs": self.obs_snapshot(workflow),
            }
