"""KEDA-style event-driven autoscaler (paper §4.2, Fig. 8).

Control loop: poll per-workflow queue *lag* (uncommitted events — exactly the
metric KEDA's Kafka scaler uses).

Classic mode (unpartitioned store): ``lag > 0`` and no live worker →
provision a TF-Worker (scale 0→1).  A worker idle longer than the grace
period exits and is reaped (scale →0).  Crashed workers are restarted
(deployment fault tolerance, §4.1/§4.2) and recover from the stores +
uncommitted events.  Departures are classified by the worker's *recorded*
exit reason (``TFWorker.crashed``): an idle exit is a ``scale_down``, a died
thread is a ``restart`` — never both.

Sharded mode: the autoscaler drives any pool implementing the
``ScalablePool`` protocol below — the threaded ``ShardedWorkerPool`` and the
multiprocess ``ProcessShardPool`` (one OS process per shard over the durable
file bus, the paper's Knative/KEDA container-per-worker deployment) are
interchangeable.  The target is *lag-proportional* —
``ceil(lag / events_per_shard)`` worker shards, capped by
``max_shards_per_workflow`` and the **workflow's own** partition count (a
shard without a partition has nothing to consume, and per-workflow partition
pins on the file bus make the store-global count the wrong cap).  Scale-up
starts new shards (the consumer group rebalances partitions onto them — a
two-phase ack'd handoff on the process pool) and counts the pool's *actual*
delta, not the request.  Scale-down is idle-driven: shards (threads or
processes) exit after the grace period and are reaped, so a drained workflow
decays back to zero shards; ``reap()``'s exit-reason accounting feeds
``scale_downs`` vs ``restarts``.

The autoscaler records a ``timeline`` of (t, active_workers, total_lag)
samples — the data behind the Fig. 8 reproduction (active_workers counts
*shards* in sharded mode).  On the file bus an idle tick costs O(1) stat
calls — the store's publish-notify-gated ``lag`` — not O(partitions) disk
scans.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Protocol, Tuple

from .policy import CircuitBreaker
from .service import Triggerflow


class ScalablePool(Protocol):
    """What a shard pool must expose for the autoscaler to drive it.

    Both ``repro.bus.ShardedWorkerPool`` (threads over the in-memory bus) and
    ``repro.bus.ProcessShardPool`` (OS processes over the durable file bus)
    implement this structurally — the autoscaler never needs to know which
    substrate runs the shards.
    """

    def live_shard_count(self, workflow: str) -> int:
        """Shards actually executing right now (0 after scale-to-zero)."""
        ...

    def start_shards(self, workflow: str, count: int,
                     idle_timeout: Optional[float] = None) -> List[str]:
        """Ensure ``count`` live shards; arms idle-exit with the grace
        period.  May start fewer than asked (partition caps, spawn
        failures) — callers must measure the actual delta."""
        ...

    def reap(self, workflow: str) -> Dict:
        """Retire departed shards.  Returns ``{"reaped": n, "crashed": m,
        "reasons": {...}}`` with crashes classified by recorded exit
        reason."""
        ...

    def lag(self, workflow: str) -> int:
        """Uncommitted events — the scaling metric.  Idle polls must be
        cheap (publish-notify-gated on the file bus)."""
        ...

    def num_partitions(self, workflow: str) -> int:
        """The *workflow's* partition count — the hard shard cap."""
        ...


class KedaAutoscaler:
    def __init__(
        self,
        tf: Triggerflow,
        poll_interval: float = 0.05,
        grace_period: float = 0.5,
        max_workers: int = 64,
        events_per_shard: int = 1000,
        max_shards_per_workflow: int = 8,
        breaker: Optional[Dict] = None,
    ) -> None:
        self.tf = tf
        self.poll_interval = poll_interval
        self.grace_period = grace_period
        self.max_workers = max_workers
        self.events_per_shard = max(1, events_per_shard)
        self.max_shards_per_workflow = max(1, max_shards_per_workflow)
        self.timeline: List[Tuple[float, int, int]] = []
        self.scale_ups = 0
        self.scale_downs = 0
        self.restarts = 0
        # host-loss recoveries observed via reap(): the recovery's restart
        # storm is deliberate, so it is neither a scale-down nor a crash
        self.node_recoveries = 0
        self._live: Dict[str, threading.Thread] = {}
        # Classic-mode crash-loop breakers, one per workflow: a worker whose
        # loop keeps dying gets restarted with exponential backoff and is
        # circuit-broken past the threshold (sharded mode delegates to the
        # pool's own per-workflow breaker inside start_shards).
        self.breaker_conf = dict(breaker) if breaker else {}
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._stop = threading.Event()
        # serializes ticks; stop() drains the in-flight one through it, so a
        # tick caught mid-start_shards can never outlive the autoscaler and
        # leave freshly started shards unreaped
        self._tick_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._t0 = time.monotonic()

    # -- control loop -------------------------------------------------------------
    def _tick(self) -> None:
        with self._tick_lock:
            if self.tf.pool is not None:
                self._tick_sharded()
            else:
                self._tick_classic()

    def _tick_classic(self) -> None:
        lags = {wf: self.tf.event_store.lag(wf) for wf in self.tf.event_store.workflows()}
        # Reap exited workers: a clean departure (idle / stopped / finished)
        # is a scale-down, a died loop is a restart — separate counters, one
        # increment per exit, classified by the worker's public predicate.
        for wf, th in list(self._live.items()):
            if not th.is_alive():
                worker = self.tf._workers.get(wf)
                del self._live[wf]
                if worker is not None and worker.crashed:
                    self.restarts += 1
                    self._breaker(wf).record_crash()
                else:
                    self.scale_downs += 1
                    self._breaker(wf).record_clean()
        # Provision workers for workflows with lag.
        for wf, lag in lags.items():
            if lag <= 0 or wf in self._live or len(self._live) >= self.max_workers:
                continue
            if self._breaker(wf).allow_start(1) < 1:
                continue  # crash-looping workflow: backing off / circuit open
            worker = self.tf.worker(wf)
            if worker.finished:
                continue
            worker.last_active = time.monotonic()
            th = self.tf.start_worker(wf, idle_timeout=self.grace_period)
            self._live[wf] = th
            self.scale_ups += 1
        self.timeline.append(
            (time.monotonic() - self._t0, len(self._live), sum(lags.values()))
        )

    def _breaker(self, workflow: str) -> CircuitBreaker:
        br = self._breakers.get(workflow)
        if br is None:
            br = self._breakers[workflow] = CircuitBreaker(**self.breaker_conf)
        return br

    def breaker_of(self, workflow: str) -> CircuitBreaker:
        """The breaker gating restarts of ``workflow`` — the pool's own in
        sharded mode, the autoscaler's in classic mode."""
        pool = self.tf.pool
        if pool is not None and hasattr(pool, "breaker_of"):
            return pool.breaker_of(workflow)
        return self._breaker(workflow)

    def target_shards(self, lag: int, workflow: Optional[str] = None) -> int:
        """Lag-proportional shard target (0 when the stream is drained),
        capped by the *workflow's* partition count when one is named — on a
        bus with per-workflow partition pins the store-global count would
        over-cap narrow workflows and under-cap wide ones."""
        if lag <= 0:
            return 0
        if workflow is not None and self.tf.pool is not None:
            partitions = self.tf.pool.num_partitions(workflow)
        else:
            partitions = getattr(self.tf.event_store, "num_partitions",
                                 self.max_shards_per_workflow)
        return min(
            self.max_shards_per_workflow,
            partitions,
            math.ceil(lag / self.events_per_shard),
        )

    def _tick_sharded(self) -> None:
        pool: ScalablePool = self.tf.pool
        store = self.tf.event_store
        workflows = store.workflows()
        lags: Dict[str, int] = {}
        lives: Dict[str, int] = {}
        for wf in workflows:
            reaped = pool.reap(wf)
            host_lost = reaped["reasons"].get("host-loss", 0)
            self.scale_downs += reaped["reaped"] - reaped["crashed"] - host_lost
            self.restarts += reaped["crashed"]
            self.node_recoveries += reaped.get("node_recoveries", 0)
            lags[wf] = pool.lag(wf)
            lives[wf] = pool.live_shard_count(wf)
        # max_workers caps the *total* shard count across workflows, so the
        # budget must see every workflow's live shards, not just the ones
        # iterated so far.
        total_live = sum(lives.values())
        for wf in workflows:
            live = lives[wf]
            target = self.target_shards(lags[wf], wf)
            budget = self.max_workers - total_live
            if target > live and budget > 0:
                # the workflow-meta read costs a state-store round-trip, so
                # only pay it when this tick would actually scale up
                meta = self.tf.state_store.get_workflow(wf) or {}
                if meta.get("status") in ("succeeded", "failed"):
                    continue
                want = min(target, live + budget)
                pool.start_shards(wf, want, idle_timeout=self.grace_period)
                # count what the pool actually started — partition caps or
                # spawn failures may grant fewer shards than requested
                now_live = pool.live_shard_count(wf)
                self.scale_ups += max(0, now_live - live)
                lives[wf] = now_live
                total_live += now_live - live
        self.timeline.append(
            (time.monotonic() - self._t0, sum(lives.values()), sum(lags.values())))

    def run(self) -> None:
        while not self._stop.is_set():
            self._tick()
            self._stop.wait(self.poll_interval)

    def start(self) -> "KedaAutoscaler":
        self._t0 = time.monotonic()
        self._thread = threading.Thread(target=self.run, name="keda-autoscaler", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 60.0) -> None:
        """Stop the control loop and *drain the in-flight tick* before
        returning.  A tick caught mid-``start_shards`` (process spawns can
        take seconds) must finish under the autoscaler's watch — returning
        early would leave its freshly started shards running unreaped after
        the caller believes autoscaling is over (the ``launch/serve.py``
        shutdown path: scaler.stop() then tf.shutdown())."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        with self._tick_lock:  # drain a tick the join timeout abandoned
            pass

    @property
    def active_workers(self) -> int:
        n = len([th for th in self._live.values() if th.is_alive()])
        if self.tf.pool is not None:
            for wf in self.tf.event_store.workflows():
                n += self.tf.pool.live_shard_count(wf)
        return n

    def metrics_snapshot(self) -> Dict:
        """The autoscaler's counters as a named-metric snapshot — the same
        shape the shard pools scrape, so ``merge_snapshot`` composes the
        Fig-8 control loop into one export (``launch/serve.py``)."""
        from ..obs.metrics import empty_snapshot, fold_counters
        snap = empty_snapshot()
        fold_counters(snap, {
            "tf_scale_ups_total": self.scale_ups,
            "tf_scale_downs_total": self.scale_downs,
            "tf_restarts_total": self.restarts,
            "tf_autoscaler_node_recoveries_total": self.node_recoveries,
            # classic-mode breakers only; sharded-mode breakers report
            # through their pool's obs_snapshot (no double counting)
            "tf_circuit_open_total":
                sum(b.opened_total for b in self._breakers.values()),
        })
        snap["gauges"]["tf_active_workers"] = self.active_workers
        snap["gauges"]["tf_restart_backoff_seconds"] = sum(
            b.restart_backoff() for b in self._breakers.values())
        return snap
