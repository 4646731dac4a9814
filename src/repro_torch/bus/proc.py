"""Multiprocess shard runtime: TF-Worker shards as OS processes (§3.4, Fig 13).

``ProcessShardPool`` is the cross-interpreter sibling of
``ShardedWorkerPool``: each ``ShardWorker`` runs in its **own process** over
the durable ``FilePartitionedEventStore``, so pure-Python workloads scale
with cores instead of saturating one GIL (the threaded pool's ceiling — see
``benchmarks/sharded_load.py --mode=process``).  Crossing the interpreter
boundary replaces every in-memory shortcut of the threaded pool with its
real distributed-systems counterpart:

* **data plane** — events, commits and DLQ state flow through per-partition
  segment logs (file-locked per partition: the striped-lock design carried
  across processes) instead of shared ``StreamShard`` objects;
* **checkpoints** — each shard process appends context deltas to its own
  scope of the ``FileStateStore`` delta log; the pool folds all scopes into
  the compacted base at every ownership boundary;
* **control plane** — trigger management (add / enable / disable) is
  *broadcast over a command pipe* as serialized specs, mirroring the paper's
  trigger-API → worker path;
* **membership** — the same ``ConsumerGroup`` (consistent hashing with
  bounded loads), driven by the parent, with a two-phase rebalance: revoke
  moved partitions from their old owners (ack'd), fold checkpoint scopes,
  then grant — so a partition never has two live writers;
* **crashes** — ``crash_shard`` is a real ``SIGKILL``.  Recovery is §3.4
  verbatim: the replacement owner reloads trigger defs + last acknowledged
  checkpoints from disk and the bus redelivers everything uncommitted,
  including a batch torn mid-append (never acknowledged ⇒ truncated).

Start method: on the CPU, ``fork`` where available (fast; inherits
registered conditions/actions/pyfuncs), else ``spawn``.  On a CUDA device,
``forkserver``, its server preloading ``torch`` and this module: a CUDA
context does not survive a fork, and the server never starts one, so every
shard makes its own, and a shard forks from the server in well under a
second where a spawned one first imports torch.  An explicit ``fork``
raises there once the parent has initialised CUDA.  Under ``spawn`` and
``forkserver`` ``child_init`` and any custom registrations must be
importable/picklable.  Every shard runs on the pool's device, named with
its index (``cuda:0``), whatever the child's current device.  Event-id
uniqueness across forked processes is guaranteed by the per-process id
prefix in ``repro.core.events``.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import signal
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import torch

from ..core.device import resolve_device
from ..core.events import CloudEvent  # noqa: F401  (re-exported for callers)
from ..core.functions import FunctionBackend
from ..core.policy import REASON_DISABLED, CircuitBreaker
from ..core.statestore import FileStateStore
from ..core.triggers import Trigger
from ..core.worker import WorkerStats
from ..obs.metrics import empty_snapshot, fold_counters, merge_snapshot
from .group import ConsumerGroup
from .partitioned import FilePartitionedEventStore
from .pool import ShardWorker
from .replicate import ReplicaServer, ReplicationClient


def _stats_dict(worker) -> Dict[str, int]:
    d = worker.stats.snapshot()
    d["cpu_seconds"] = time.process_time()
    return d


def _metrics_dict(worker, store) -> Dict[str, Any]:
    """The shard's full observability snapshot, shipped over the command
    pipe: histogram registry + stats counters (``metrics_snapshot``) plus
    the shard's own segment-append accounting and a CPU gauge."""
    snap = worker.metrics_snapshot()
    ap = store.append_stats(worker.workflow)
    fold_counters(snap, {"tf_log_appends_total": ap["appends"]})
    snap["counters"]["tf_log_append_seconds_total"] = (
        snap["counters"].get("tf_log_append_seconds_total", 0)
        + ap["append_seconds"])
    snap["gauges"]["tf_cpu_seconds"] = time.process_time()
    # host-loss fault domain: writes this shard had fenced (a superseded
    # lease epoch) and the bytes it has shipped but not yet had acked
    if getattr(store, "lease_owner", None) is not None:
        fold_counters(snap, {"tf_fenced_writes_total": store.fenced_writes})
    rep = getattr(store, "_rep", None)
    if rep is not None:
        snap["gauges"]["tf_replication_lag_bytes"] = (
            snap["gauges"].get("tf_replication_lag_bytes", 0)
            + rep.replica_lag_bytes())
    return snap


def _shard_main(member: str, workflow: str, bus_root: str, state_root: str,
                num_partitions: int, conn, cfg: Dict[str, Any]) -> None:
    """Shard process entry point: build the stores/worker from disk, then
    loop — drain commands, run one batch, idle-wait on the pipe.  The final
    text of every reply carries ``member`` so the parent can assert it is
    talking to whom it thinks.

    KEDA-style scale-down (``idle_timeout``): a shard that processes nothing
    for the grace period announces ``("idle", ...)`` and exits cleanly
    (code 0) — the container-per-worker analogue of the threaded runner's
    idle drop.  Its partitions stay with the (dead) member until the parent's
    next ``reap()`` hands them to survivors — or, at scale-to-zero, until a
    later burst makes the autoscaler start fresh shards."""
    replica_addr = cfg.get("replica_addr")
    lease = bool(cfg.get("lease"))
    store = FilePartitionedEventStore(
        bus_root, num_partitions, fsync=cfg["fsync"],
        replicate_to=replica_addr, replicate_prefix="bus",
        lease_owner=member if lease else None,
        lease_ttl=cfg.get("lease_ttl", 30.0),
        event_codec=cfg.get("event_codec", "binary"))
    state_rep = None
    if replica_addr is not None:
        state_rep = ReplicationClient(replica_addr, state_root,
                                      prefix="state")
    state = FileStateStore(state_root, scope=member, replicator=state_rep)
    backend = FunctionBackend(store, inline=True)
    child_init = cfg.get("child_init")
    if child_init is not None:
        child_init(backend)
    tracer = None
    if cfg.get("trace"):
        # span segment: SIGKILL-durable sink under <root>/spans; spans flush
        # with the worker's checkpoint, open records immediately
        from ..core.eventstore import SegmentLog
        from ..obs.trace import SpanCollector, Tracer
        os.makedirs(cfg["trace_dir"], exist_ok=True)
        seg = SegmentLog(
            os.path.join(cfg["trace_dir"], "spans.%s.jsonl" % member),
            fsync=cfg["fsync"])
        sample = 1.0 if cfg["trace"] == "full" else cfg.get("trace_sample", 0.1)
        tracer = Tracer(sample=sample, collector=SpanCollector(segment=seg),
                        tag=member)
    worker = ShardWorker(
        member, workflow, store, state, backend,
        batch_size=cfg["batch_size"], commit_policy=cfg["commit_policy"],
        keep_event_log=False, timers=None, partitions=(),
        batch_plane=cfg["batch_plane"], action_plane=cfg["action_plane"],
        metrics=cfg.get("metrics", True), tracer=tracer,
        device=cfg["device"],
    )
    conn.send(("ready", member))
    poll = cfg["poll"]
    idle_timeout = cfg.get("idle_timeout")
    last_active = time.monotonic()
    notified_finish = False
    try:
        while True:
            while conn.poll(0):
                msg = conn.recv()
                op = msg[0]
                if op == "assign":
                    parts, gen = tuple(msg[1]), msg[2]
                    with worker.lock:
                        dropped: tuple = ()
                        if worker.partitions != parts:
                            dropped = tuple(
                                set(worker.partitions) - set(parts))
                            worker.partitions = parts
                            worker.rebalance_reset()
                    if lease:
                        # sanctioned ownership change: release what moved
                        # away, (re-)acquire what was granted — the epoch
                        # bump fences any zombie writer and clears this
                        # member's own fence latches for the partitions
                        for p in sorted(dropped):
                            store.release_partition_lease(workflow, p)
                        if parts:
                            store.reacquire_partition_leases(workflow, parts)
                    # fresh ownership restarts the idle clock: the grace
                    # period measures inactivity *while serving*, not time
                    # spent waiting out a rebalance
                    last_active = time.monotonic()
                    conn.send(("assigned", member, gen))
                elif op == "add_trigger":
                    worker.add_trigger(Trigger.from_dict(msg[1]), persist=False)
                    conn.send(("ok", member))
                elif op == "enable":
                    if msg[1] in worker.triggers:
                        worker.set_trigger_enabled(msg[1], msg[2])
                    conn.send(("ok", member))
                elif op == "stats":
                    conn.send(("stats", member, _stats_dict(worker)))
                elif op == "metrics":
                    conn.send(("metrics", member, _metrics_dict(worker, store)))
                elif op == "ping":
                    conn.send(("pong", member))
                elif op == "stop":
                    if tracer is not None:
                        tracer.flush()
                    if replica_addr is not None:
                        # bound the replica's staleness at a clean exit;
                        # SIGKILL keeps whatever lag was in flight — that
                        # is the bounded-lag window recovery tolerates
                        store.drain_replication(5.0)
                        state_rep.drain(5.0)
                    conn.send(("stopped", member, _stats_dict(worker)))
                    return
            try:
                n = worker.run_once() if worker.partitions else 0
            except Exception as exc:  # noqa: BLE001 - a failed batch is a crash
                # Nothing from the failed batch was checkpointed or
                # committed (the exception interrupted _checkpoint at the
                # latest), so dying here leaves the store in the ordinary
                # crash state: the parent reaps the non-zero exit and the
                # partitions' next owner replays the uncommitted events.
                traceback.print_exc()
                try:
                    conn.send(("failed", member, repr(exc)))
                except Exception:  # noqa: BLE001
                    # tfcheck: allow[seam-safety] best-effort death notice on a dying pipe; SystemExit(1) below is the real signal
                    pass
                raise SystemExit(1)
            if worker.finished and not notified_finish:
                notified_finish = True
                conn.send(("finished", member, worker.result))
            if n:
                last_active = time.monotonic()
            else:
                if idle_timeout is not None and \
                        time.monotonic() - last_active > idle_timeout:
                    # scale-to-zero: announce the clean exit (best effort —
                    # the parent classifies by exit code 0 regardless) and go
                    if tracer is not None:
                        tracer.flush()
                    if replica_addr is not None:
                        store.drain_replication(5.0)
                        state_rep.drain(5.0)
                    try:
                        conn.send(("idle", member, _stats_dict(worker)))
                    except (BrokenPipeError, OSError):  # pragma: no cover
                        pass
                    return
                conn.poll(poll)  # idle sleep; a command wakes us early
    except (EOFError, BrokenPipeError):  # parent is gone: nothing to serve
        return


class _ProcShard:
    __slots__ = ("member", "proc", "conn", "alive", "partitions",
                 "final_stats", "finished", "result", "exit_reason")

    def __init__(self, member: str, proc, conn) -> None:
        self.member = member
        self.proc = proc
        self.conn = conn
        self.alive = True
        self.partitions: tuple = ()
        self.final_stats: Optional[Dict[str, int]] = None
        self.finished = False
        self.result: Any = None
        # why the process left ("idle" | "stopped" | "error" | None while
        # running) — from its last pipe message or, failing that, its exit
        # code; ``reap()`` folds these into the autoscaler's accounting
        self.exit_reason: Optional[str] = None


class _ProcWorkflow:
    __slots__ = ("group", "shards", "next_id", "crashes", "rebalances",
                 "triggers", "finished", "result", "unreaped", "retired_stats",
                 "breaker", "node_recoveries", "recovery_seconds",
                 "unreported_recoveries")

    def __init__(self, num_partitions: int,
                 breaker: Optional[CircuitBreaker] = None) -> None:
        self.group = ConsumerGroup(num_partitions)
        self.shards: Dict[str, _ProcShard] = {}
        self.next_id = 0
        self.crashes = 0
        self.rebalances = 0
        self.triggers: Dict[str, Dict[str, Any]] = {}  # parent spec cache
        self.finished = False
        self.result: Any = None
        # departures retired outside reap() (_observe_death during a
        # broadcast/rebalance), by exit reason — folded into the next reap()
        # report exactly once so the autoscaler's accounting sees them
        self.unreaped: List[str] = []
        # summed final_stats of departed-and-dropped shards: scale-to-zero
        # cycles must not grow wf.shards without bound, but the workflow's
        # lifetime totals (events_processed, fires, …) must survive the drop
        self.retired_stats: Dict[str, int] = {}
        # crash-loop breaker: consecutive-crash streak gates start_shards
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        # host-loss recoveries (recover_host_loss): lifetime count, summed
        # wall-clock seconds, and the not-yet-reaped delta the autoscaler's
        # accounting drains exactly once
        self.node_recoveries = 0
        self.recovery_seconds = 0.0
        self.unreported_recoveries = 0

    def fold_retired(self, shard: _ProcShard) -> None:
        if shard.final_stats:
            WorkerStats.fold(self.retired_stats, shard.final_stats)


class ProcessShardPool:
    """Runs N ShardWorker *processes* per workflow over the file-backed bus.

    ``root`` holds the whole deployment: ``<root>/bus`` (partitioned event
    segments) and ``<root>/state`` (workflow/trigger/context database).  A
    pool constructed over an existing root *recovers* it — streams, trigger
    defs and checkpoints are all on disk.

    ``fsync=False`` keeps every durability property against process
    crashes/SIGKILL (the page cache survives) and trades only power-loss
    durability for a large cut in append latency — the Kafka default-flush
    analogy.  Crash tests run with the default ``fsync=True``.
    """

    def __init__(
        self,
        root: str,
        num_partitions: int = 8,
        batch_size: int = 512,
        commit_policy: str = "every_batch",
        poll: float = 0.002,
        fsync: bool = True,
        batch_plane: bool = True,
        action_plane: bool = True,
        start_method: Optional[str] = None,
        child_init: Optional[Callable] = None,
        command_timeout: float = 30.0,
        metrics: bool = True,
        trace: Optional[str] = None,
        trace_sample: float = 0.1,
        breaker: Optional[Dict[str, Any]] = None,
        replicate: bool = False,
        replica_root: Optional[str] = None,
        lease: bool = False,
        lease_ttl: float = 30.0,
        event_codec: str = "binary",
        device="cuda",
    ) -> None:
        # one device for every shard, fixed here with its index, and a start
        # method that gives each shard on a card a fresh CUDA context
        self.device = resolve_device(device)
        on_cuda = self.device.type == "cuda"
        if start_method is None and on_cuda:
            start_method = "forkserver"
            mp.get_context(start_method).set_forkserver_preload(["torch", __name__])
        elif start_method == "fork" and on_cuda and torch.cuda.is_initialized():
            raise ValueError(
                "start_method='fork' on %s: CUDA is initialised in this process "
                "and a forked shard cannot use it; use 'spawn' or 'forkserver'"
                % self.device)
        # ``command_timeout`` bounds every command-pipe round-trip.  Shard
        # processes service the pipe between batches, so it must exceed the
        # worst-case batch (batch_size × the slowest action) — a busy shard
        # that misses the deadline is treated as hung and SIGKILLed.  Size
        # batches (or raise this) accordingly for slow-action workloads.
        self.root = root
        self.bus_root = os.path.join(root, "bus")
        self.state_root = os.path.join(root, "state")
        self._num_partitions = num_partitions  # bus default; see num_partitions()
        # -- host-loss fault domain -------------------------------------------
        # replicate=True stands up a ReplicaServer under <root>/replica (or
        # ``replica_root`` — on a real deployment, another host) and ships
        # every segment mutation there: the parent's publishes, each shard
        # process's commits/DLQ/checkpoints.  The replica mirrors the whole
        # deployment layout (replica/bus/..., replica/state/...), so
        # ``recover_host_loss`` can rebuild a lost segment root from it.
        # lease=True arms lease-fenced ownership in the shard processes.
        self.replica_root = replica_root or os.path.join(root, "replica")
        self.replica_server: Optional[ReplicaServer] = None
        self._rep_addr = None
        if replicate:
            self.replica_server = ReplicaServer(self.replica_root)
            self._rep_addr = self.replica_server.address
        self.event_store = FilePartitionedEventStore(
            self.bus_root, num_partitions, fsync=fsync,
            replicate_to=self._rep_addr, replicate_prefix="bus",
            event_codec=event_codec)
        self.state_store = FileStateStore(
            self.state_root,
            replicator=(ReplicationClient(self._rep_addr, self.state_root,
                                          prefix="state")
                        if self._rep_addr is not None else None))
        # trace: None (off) | "sampled" (trace_sample of new roots) |
        # "full" (every fire).  Span segments land under <root>/spans,
        # one SIGKILL-durable file per shard process, stitched by
        # trace_spans()/scripts/trace_report.py.
        self.trace_dir = os.path.join(root, "spans")
        if trace:
            os.makedirs(self.trace_dir, exist_ok=True)
        self._cfg: Dict[str, Any] = {
            "batch_size": batch_size, "commit_policy": commit_policy,
            "poll": poll, "fsync": fsync, "batch_plane": batch_plane,
            "action_plane": action_plane, "child_init": child_init,
            "idle_timeout": None,
            "metrics": metrics, "trace": trace, "trace_sample": trace_sample,
            "trace_dir": self.trace_dir,
            "replica_addr": self._rep_addr, "lease": lease,
            "lease_ttl": lease_ttl, "event_codec": event_codec,
            "device": str(self.device),
        }
        self.metrics_enabled = metrics
        self.command_timeout = command_timeout
        # CircuitBreaker kwargs applied to every workflow's crash-loop
        # breaker (threshold / backoff_* / cooldown — see core.policy).
        self.breaker_conf = dict(breaker) if breaker else {}
        if start_method is None:
            start_method = ("fork" if "fork" in mp.get_all_start_methods()
                            else "spawn")
        self.start_method = start_method
        self._mp = mp.get_context(start_method)
        self._lock = threading.RLock()
        self._wfs: Dict[str, _ProcWorkflow] = {}

    # -- workflow / trigger management (the Fig. 1 control plane) --------------
    def _wf(self, workflow: str) -> _ProcWorkflow:
        wf = self._wfs.get(workflow)
        n = self.event_store.num_partitions_for(workflow)
        if wf is None:
            wf = self._wfs.setdefault(
                workflow, _ProcWorkflow(n, CircuitBreaker(**self.breaker_conf)))
        elif wf.group.num_partitions != n:
            # a per-workflow partition pin landed after this group was sized
            # (e.g. add_trigger before create_workflow(num_partitions=...)):
            # resize while empty; live members mean the widths diverged
            if wf.group.members():
                raise ValueError(
                    "workflow %r is sharded over %d partitions but the store "
                    "now pins %d" % (workflow, wf.group.num_partitions, n))
            wf.group = ConsumerGroup(n)
        return wf

    def num_partitions(self, workflow: str) -> int:
        """The workflow's pinned partition count (``ScalablePool``) — the
        hard shard cap the autoscaler must respect per workflow."""
        with self._lock:
            wf = self._wfs.get(workflow)
            if wf is not None:
                return wf.group.num_partitions
        return self.event_store.num_partitions_for(workflow)

    def create_workflow(self, workflow: str,
                        meta: Optional[Dict[str, Any]] = None,
                        num_partitions: Optional[int] = None) -> None:
        """``num_partitions`` pins a per-workflow partition count (written to
        the stream's ``stream.json``); create the workflow before starting
        shards or publishing from other processes, so every store instance
        routes its subjects identically."""
        self.event_store.create_stream(workflow, num_partitions=num_partitions)
        m = {"status": "created"}
        m.update(meta or {})
        self.state_store.put_workflow(workflow, m)
        with self._lock:
            self._wf(workflow)

    def add_trigger(self, workflow: str, trigger: Trigger) -> str:
        """Persist the spec (restart/bootstrap source of truth), then
        broadcast it to every live shard process over the command pipe."""
        spec = trigger.to_dict()
        with self._lock:
            wf = self._wf(workflow)
            self.state_store.put_trigger(workflow, trigger.trigger_id, spec)
            wf.triggers[trigger.trigger_id] = spec
            for shard in self._live(wf):
                if self._request(wf, shard, ("add_trigger", spec), "ok") is None:  # tfcheck: allow[lock-discipline] serialized control plane; waits bounded by command_timeout
                    self._observe_death(workflow, wf, shard)  # tfcheck: allow[lock-discipline] serialized control plane; waits bounded by command_timeout
        return trigger.trigger_id

    def set_trigger_enabled(self, workflow: str, trigger_id: str,
                            enabled: bool) -> None:
        """Broadcast the flip; re-enabling also redrives the DLQ of the
        trigger's subject partitions (§3.4) through the shared bus files —
        the owning shards pick the requeued events up on their next sync."""
        with self._lock:
            wf = self._wfs.get(workflow)
            if wf is None:
                return
            for shard in self._live(wf):
                if self._request(wf, shard,  # tfcheck: allow[lock-discipline] serialized control plane; waits bounded by command_timeout
                                 ("enable", trigger_id, enabled), "ok") is None:
                    self._observe_death(workflow, wf, shard)  # tfcheck: allow[lock-discipline] serialized control plane; waits bounded by command_timeout
            if enabled:
                spec = wf.triggers.get(trigger_id) or \
                    self.state_store.get_triggers(workflow).get(trigger_id, {})
                subjects = spec.get("activation_events", ())
                if subjects:
                    parts = {self.event_store.partition_for(s, workflow)
                             for s in subjects}
                    # only ``disabled`` quarantines come back; poison:* stays
                    # put until an operator redrives explicitly
                    self.event_store.redrive_partitions(
                        workflow, parts, reasons=(REASON_DISABLED,))

    def publish(self, workflow: str, event: CloudEvent) -> None:
        self.event_store.publish(workflow, event)

    def publish_batch(self, workflow: str, events) -> None:
        self.event_store.publish_batch(workflow, events)

    # -- shard lifecycle --------------------------------------------------------
    def _live(self, wf: _ProcWorkflow) -> List[_ProcShard]:
        return [s for s in wf.shards.values() if s.alive]

    def shard_ids(self, workflow: str) -> List[str]:
        with self._lock:
            wf = self._wfs.get(workflow)
            return [s.member for s in self._live(wf)] if wf else []

    def shard_count(self, workflow: str) -> int:
        return len(self.shard_ids(workflow))

    def breaker_of(self, workflow: str) -> CircuitBreaker:
        """The workflow's crash-loop breaker (autoscaler gate + tests)."""
        with self._lock:
            return self._wf(workflow).breaker

    def live_shard_count(self, workflow: str) -> int:
        """Shard processes that are actually running right now (an idle-exited
        or crashed child stops counting the moment it dies, even before
        ``reap()`` retires its membership) — the autoscaler's Fig-8 signal."""
        with self._lock:
            wf = self._wfs.get(workflow)
            if wf is None:
                return 0
            return sum(1 for s in wf.shards.values()
                       if s.alive and s.proc.is_alive())

    def start_shards(self, workflow: str, count: int,
                     idle_timeout: Optional[float] = None,
                     ready_timeout: float = 30.0) -> List[str]:
        """Ensure ``count`` live shard processes serve ``workflow``.

        ``idle_timeout`` arms KEDA-style scale-down in every shard started by
        this call: a child that processes nothing for that grace period exits
        cleanly (code 0) and is reaped as a scale-down, not a crash."""
        with self._lock:
            wf = self._wf(workflow)
            cfg = self._cfg
            if idle_timeout is not None:
                cfg = dict(cfg)
                cfg["idle_timeout"] = idle_timeout
            fresh: List[_ProcShard] = []
            need = count - len(self._live(wf))
            granted = wf.breaker.allow_start(need) if need > 0 else 0
            if granted < max(0, need):
                # crash-loop breaker: a crash streak makes fresh starts wait
                # out an exponential backoff; past the threshold the circuit
                # opens until a cooldown admits one half-open probe
                print("[proc-pool] circuit breaker for workflow %r (%s, "
                      "streak=%d): granting %d/%d shard start(s)"
                      % (workflow, wf.breaker.state, wf.breaker.streak,
                         granted, need))
            while len(fresh) < granted:
                member = "proc-%d" % wf.next_id
                wf.next_id += 1
                parent_conn, child_conn = self._mp.Pipe()
                proc = self._mp.Process(
                    target=_shard_main,
                    args=(member, workflow, self.bus_root, self.state_root,
                          self._num_partitions, child_conn, cfg),
                    name="tf-%s-%s" % (workflow, member), daemon=True)
                proc.start()
                child_conn.close()
                fresh.append(_ProcShard(member, proc, parent_conn))
            for shard in fresh:
                wf.shards[shard.member] = shard
                if self._await(wf, shard, "ready", ready_timeout) is None:  # tfcheck: allow[lock-discipline] serialized control plane; waits bounded by command_timeout
                    self._observe_death(workflow, wf, shard, rebalance=False)  # tfcheck: allow[lock-discipline] serialized control plane; waits bounded by command_timeout
            joined = False
            for shard in fresh:
                if shard.alive:
                    wf.group.join(shard.member)
                    joined = True
            if joined:
                self._rebalance(workflow, wf)  # tfcheck: allow[lock-discipline] serialized control plane; waits bounded by command_timeout
            return [s.member for s in self._live(wf)]

    def remove_shard(self, workflow: str, member: str) -> None:
        """Graceful leave: drain-stop the process, fold its checkpoint scope,
        hand its partitions to the rest."""
        with self._lock:
            wf = self._wfs.get(workflow)
            shard = wf.shards.get(member) if wf else None
            if shard is None:
                return
            self._stop_shard(wf, shard)  # tfcheck: allow[lock-discipline] serialized control plane; waits bounded by command_timeout
            wf.group.leave(member)
            wf.breaker.record_clean()
            self._rebalance(workflow, wf)  # tfcheck: allow[lock-discipline] serialized control plane; waits bounded by command_timeout

    def crash_shard(self, workflow: str, member: str) -> None:
        """A real crash: SIGKILL the shard process mid-whatever-it-was-doing.
        Nothing it had not checkpointed/committed survives; the group
        reassigns its partitions and the bus redelivers every uncommitted
        event to the new owners (§3.4 / Fig 13)."""
        with self._lock:
            wf = self._wfs.get(workflow)
            shard = wf.shards.get(member) if wf else None
            if shard is None or not shard.alive:
                return
            if shard.proc.is_alive():
                os.kill(shard.proc.pid, signal.SIGKILL)
            shard.proc.join(timeout=10.0)
            shard.alive = False
            shard.exit_reason = "error"
            shard.conn.close()
            wf.crashes += 1
            wf.breaker.record_crash()
            wf.group.leave(member)
            self._rebalance(workflow, wf)  # tfcheck: allow[lock-discipline] serialized control plane; waits bounded by command_timeout

    def recover_host_loss(self, workflow: str, count: Optional[int] = None,
                          ready_timeout: float = 30.0) -> float:
        """Bounded-time recovery from losing the node that served
        ``workflow`` — host *and* local segment root (the disk is gone, not
        just the processes).  The sequence:

        1. SIGKILL whatever shard processes remain (their working set
           vanished from under them).  Node loss is not a crash loop: the
           breaker is NOT fed, so the restart below is not backoff-gated —
           but an already-open breaker still gates it, by design (a workflow
           mid-quarantine does not get resurrected by a host failover).
        2. Rehydrate the workflow's bus partition files from the replica
           root (``restore_from_replica`` — the ordinary torn-tail-tolerant
           replay, fed from the replica's bytes).
        3. Restart ``count`` shards (default: as many as were live).  The
           fresh children force-acquire the partition leases on their first
           assignment — the epoch bump fences any zombie writer that
           survived the "lost" host.

        Returns wall-clock recovery seconds (also ``tf_recovery_seconds``)."""
        if self.replica_server is None:
            raise RuntimeError(
                "recover_host_loss requires the pool to be constructed with "
                "replicate=True (there is no replica to recover from)")
        t0 = time.perf_counter()
        with self._lock:
            wf = self._wf(workflow)
            want = count if count is not None else max(1, len(self._live(wf)))
            for shard in list(wf.shards.values()):
                if not shard.alive:
                    continue  # already departed: reap() accounts for it
                self._drain_final(wf, shard)  # tfcheck: allow[lock-discipline] serialized control plane; waits bounded by command_timeout
                if shard.proc.is_alive():
                    os.kill(shard.proc.pid, signal.SIGKILL)
                shard.proc.join(timeout=10.0)
                shard.alive = False
                shard.exit_reason = "host-loss"
                shard.conn.close()
                wf.group.leave(shard.member)
                wf.unreaped.append("host-loss")
                wf.fold_retired(shard)
                wf.shards.pop(shard.member, None)
            self.event_store.restore_from_replica(
                workflow, os.path.join(self.replica_root, "bus"))
            wf.node_recoveries += 1
            wf.unreported_recoveries += 1
        self.start_shards(workflow, want, ready_timeout=ready_timeout)
        seconds = time.perf_counter() - t0
        with self._lock:
            wf.recovery_seconds += seconds
        return seconds

    def replica_lag(self, workflow: str) -> Dict[int, int]:
        """True per-partition replication deficit in bytes: local segment
        sizes minus the replica's — across ALL writers (parent publishes and
        every shard process), unlike the per-client ``replica_lags`` view.
        Empty when replication is off."""
        out: Dict[int, int] = {}
        if self.replica_server is None:
            return out
        d = os.path.join(self.bus_root, workflow.replace("/", "_"))
        rd = os.path.join(self.replica_root, "bus",
                          workflow.replace("/", "_"))
        if not os.path.isdir(d):
            return out
        for fn in sorted(os.listdir(d)):
            if fn.rpartition(".")[2] not in ("log", "committed", "dlq"):
                continue
            if not (fn.startswith("p") and fn[1:5].isdigit()):
                continue
            try:
                local = os.path.getsize(os.path.join(d, fn))
            except OSError:
                local = 0
            try:
                remote = os.path.getsize(os.path.join(rd, fn))
            except OSError:
                remote = 0
            if local > remote:
                p = int(fn[1:5])
                out[p] = out.get(p, 0) + (local - remote)
        return out

    def reap(self, workflow: str) -> Dict[str, Any]:
        """Fold in shards whose process died on its own — idle scale-down,
        workflow end, or a genuine crash (SIGKILL, OOM, failed batch).
        Mirrors the thread pool's ``ScalablePool`` accounting:
        ``{"reaped": n, "crashed": m, "reasons": {reason: count}}``.

        Classification is by the child's *recorded exit reason* (its last
        pipe message — ``idle``/``stopped``/``failed``), falling back to the
        exit code: 0 is a clean departure, anything else (including a signal
        death's negative code) is a crash."""
        reaped = crashed = 0
        reasons: Dict[str, int] = {}
        with self._lock:
            wf = self._wfs.get(workflow)
            if wf is None:
                return {"reaped": 0, "crashed": 0, "reasons": {},
                        "node_recoveries": 0}
            # host-loss recoveries since the last reap: the restart storm
            # they caused is deliberate (not a crash loop), so the
            # autoscaler accounts them separately
            recoveries = wf.unreported_recoveries
            wf.unreported_recoveries = 0
            # departures _observe_death already retired (their wf.crashes
            # were counted there; only the report entries are pending)
            for reason in wf.unreaped:
                reaped += 1
                reasons[reason] = reasons.get(reason, 0) + 1
                if reason == "error":
                    crashed += 1
            wf.unreaped = []
            dead = [s for s in wf.shards.values()
                    if s.alive and not s.proc.is_alive()]
            for shard in dead:
                self._drain_final(wf, shard)  # tfcheck: allow[lock-discipline] serialized control plane; waits bounded by command_timeout
                shard.alive = False
                shard.conn.close()
                wf.group.leave(shard.member)
                reaped += 1
                reason = shard.exit_reason
                if reason is None:
                    reason = "stopped" if shard.proc.exitcode == 0 else "error"
                    shard.exit_reason = reason
                reasons[reason] = reasons.get(reason, 0) + 1
                if reason == "error":
                    crashed += 1
                    wf.crashes += 1
                    wf.breaker.record_crash()
                else:
                    wf.breaker.record_clean()
                # drop the corpse (scale-to-zero cycles are unbounded;
                # wf.shards must not be) but keep its lifetime totals
                wf.fold_retired(shard)
                wf.shards.pop(shard.member, None)
            if dead:
                self._rebalance(workflow, wf)  # tfcheck: allow[lock-discipline] serialized control plane; waits bounded by command_timeout
        return {"reaped": reaped, "crashed": crashed, "reasons": reasons,
                "node_recoveries": recoveries}

    def stop(self, workflow: str) -> None:
        with self._lock:
            wf = self._wfs.get(workflow)
            if wf is None:
                return
            for shard in self._live(wf):
                self._stop_shard(wf, shard)  # tfcheck: allow[lock-discipline] serialized control plane; waits bounded by command_timeout
                # the member is gone for good: without the leave, a later
                # start_shards would assign partitions to a dead member and
                # the workflow would stall forever
                wf.group.leave(shard.member)
            self.state_store.compact(workflow)

    def stop_all(self) -> None:
        for workflow in list(self._wfs.keys()):
            self.stop(workflow)

    def close_replication(self) -> None:
        """Tear down the replication plane (tests/soaks; the threads are
        daemons, so skipping this just leaves idle sockets until exit)."""
        rep = getattr(self.event_store, "_rep", None)
        if rep is not None:
            rep.drain(2.0)
            rep.close()
        if self.state_store.replicator is not None:
            self.state_store.replicator.drain(2.0)
            self.state_store.replicator.close()
        if self.replica_server is not None:
            self.replica_server.close()

    def _stop_shard(self, wf: _ProcWorkflow, shard: _ProcShard) -> None:
        reply = self._request(wf, shard, ("stop",), "stopped", timeout=10.0)
        if reply is not None:
            shard.final_stats = reply[2]
            shard.exit_reason = "stopped"
        shard.proc.join(timeout=10.0)
        if shard.proc.is_alive():  # refused to die: escalate
            os.kill(shard.proc.pid, signal.SIGKILL)
            shard.proc.join(timeout=10.0)
            shard.exit_reason = "error"
        shard.alive = False
        shard.conn.close()

    def _observe_death(self, workflow: str, wf: _ProcWorkflow,
                       shard: _ProcShard, rebalance: bool = True) -> None:
        """A shard stopped answering: confirm it is gone and rebalance.
        A child that managed a clean last word (``idle``/``stopped``) before
        the pipe broke — e.g. an idle-exit racing a broadcast — is a clean
        departure, not a crash."""
        self._drain_final(wf, shard)
        if shard.proc.is_alive():
            os.kill(shard.proc.pid, signal.SIGKILL)
        shard.proc.join(timeout=10.0)
        shard.alive = False
        shard.conn.close()
        if shard.exit_reason not in ("idle", "stopped"):
            shard.exit_reason = "error"
            wf.crashes += 1
            wf.breaker.record_crash()
        else:
            wf.breaker.record_clean()
        wf.unreaped.append(shard.exit_reason)
        wf.fold_retired(shard)
        wf.shards.pop(shard.member, None)
        wf.group.leave(shard.member)
        if rebalance:
            self._rebalance(workflow, wf)

    # -- rebalance (two-phase, ack'd) -------------------------------------------
    def _rebalance(self, workflow: str, wf: _ProcWorkflow,
                   _depth: int = 0) -> None:
        """Never let a partition have two live writers:

        1. *Revoke*: shrink every continuing owner to the partitions it
           keeps, and wait for each ack (the child resets volatile state to
           its last checkpoint before answering).
        2. *Fold*: compact every checkpoint scope into the base — after
           this, any scope may legally write any trigger.
        3. *Grant*: send the full new assignment (ack'd as well, so callers
           returning from membership changes see a settled group).

        A shard found dead mid-rebalance leaves the group and the whole
        pass re-runs against the shrunken membership, so its partitions are
        granted to survivors instead of dangling until the next change."""
        if _depth == 0:
            wf.rebalances += 1
        assignment = wf.group.assignment()
        lost = False
        for shard in self._live(wf):
            target = set(assignment.get(shard.member, ()))
            retained = tuple(sorted(set(shard.partitions) & target))
            if retained != shard.partitions:
                if self._request(wf, shard, ("assign", retained, -1),
                                 "assigned") is None:
                    self._observe_death(workflow, wf, shard, rebalance=False)
                    lost = True
                    continue
                shard.partitions = retained
        self.state_store.compact(workflow)
        gen = wf.group.generation
        for shard in self._live(wf):
            target = tuple(sorted(assignment.get(shard.member, ())))
            if target != shard.partitions:
                if self._request(wf, shard, ("assign", target, gen),
                                 "assigned") is None:
                    self._observe_death(workflow, wf, shard, rebalance=False)
                    lost = True
                    continue
                shard.partitions = target
        if lost and _depth < len(wf.shards) + 1:
            self._rebalance(workflow, wf, _depth + 1)

    # -- request/reply over the command pipe -------------------------------------
    def _absorb(self, wf: _ProcWorkflow, shard: _ProcShard, msg) -> None:
        if msg[0] == "finished":
            shard.finished = True
            shard.result = msg[2]
            wf.finished = True
            wf.result = msg[2]
        elif msg[0] == "stats":
            shard.final_stats = msg[2]
        elif msg[0] == "metrics":
            pass  # stale scrape reply — nothing to keep
        elif msg[0] == "idle":
            # the child's goodbye before a clean scale-to-zero exit
            shard.exit_reason = "idle"
            shard.final_stats = msg[2]
        elif msg[0] == "failed":
            shard.exit_reason = "error"

    def _drain_final(self, wf: _ProcWorkflow, shard: _ProcShard) -> None:
        """Absorb a dead (or dying) shard's last words so its departure is
        classified by what it *said*, not only by its exit code."""
        try:
            while shard.conn.poll(0):
                self._absorb(wf, shard, shard.conn.recv())
        except (EOFError, BrokenPipeError, OSError):
            pass

    def _await(self, wf: _ProcWorkflow, shard: _ProcShard, op: str,
               timeout: Optional[float] = None):
        """Wait for a reply of type ``op``, absorbing unsolicited messages
        (``finished`` notifications, stale replies).  None ⇒ shard is gone."""
        deadline = time.monotonic() + (timeout or self.command_timeout)
        try:
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not shard.conn.poll(remaining):
                    return None
                msg = shard.conn.recv()
                if msg[0] == op:
                    return msg
                self._absorb(wf, shard, msg)
        except (EOFError, BrokenPipeError, OSError):
            return None

    def _request(self, wf: _ProcWorkflow, shard: _ProcShard, msg, reply_op: str,
                 timeout: Optional[float] = None):
        if not shard.alive:
            return None
        try:
            shard.conn.send(msg)
        except (BrokenPipeError, OSError):
            return None
        return self._await(wf, shard, reply_op, timeout)

    # -- observability -----------------------------------------------------------
    def lag(self, workflow: str) -> int:
        return self.event_store.lag(workflow)

    def _stats(self, workflow: str) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        with self._lock:
            wf = self._wfs.get(workflow)
            if wf is None:
                return out
            for member, shard in wf.shards.items():
                if shard.alive:
                    reply = self._request(wf, shard, ("stats",), "stats")  # tfcheck: allow[lock-discipline] serialized control plane; waits bounded by command_timeout
                    if reply is not None:
                        out[member] = reply[2]
                        continue
                if shard.final_stats is not None:
                    out[member] = shard.final_stats
        return out

    def _retired_stat(self, workflow: str, key: str) -> int:
        with self._lock:
            wf = self._wfs.get(workflow)
            return wf.retired_stats.get(key, 0) if wf is not None else 0

    def total_events_processed(self, workflow: str) -> int:
        return self._retired_stat(workflow, "events_processed") + sum(
            s.get("events_processed", 0)
            for s in self._stats(workflow).values())

    def total_fires(self, workflow: str) -> int:
        return self._retired_stat(workflow, "fires") + sum(
            s.get("fires", 0) for s in self._stats(workflow).values())

    def trigger_context(self, workflow: str, trigger_id: str) -> Dict[str, Any]:
        """The trigger's last *acknowledged checkpoint* (base + all scope
        logs) — the durable truth a replacement owner would recover."""
        return self.state_store.get_contexts(workflow).get(trigger_id, {})

    def obs_snapshot(self, workflow: str) -> Dict[str, Any]:
        """Aggregate metrics snapshot across shard *processes*: each live
        shard is scraped over the command pipe (a shard that misses the
        deadline is simply skipped — scrapes never kill shards), retired
        shards contribute their folded exit stats, and the parent adds its
        own membership counters.  Same shape as the thread pool's
        ``obs_snapshot``, so ``merge_snapshot`` composes the two runtimes."""
        snap = empty_snapshot()
        with self._lock:
            wf = self._wfs.get(workflow)
            if wf is None:
                return snap
            for shard in wf.shards.values():
                if shard.alive:
                    reply = self._request(wf, shard, ("metrics",), "metrics",  # tfcheck: allow[lock-discipline] serialized control plane; waits bounded by command_timeout
                                          timeout=5.0)
                    if reply is not None:
                        merge_snapshot(snap, reply[2])
                elif shard.final_stats:
                    # stopped but not yet reaped/dropped: its exit stats are
                    # the counters' last word (same rule as ``_stats``)
                    fold_counters(snap, {
                        "tf_%s_total" % k: v
                        for k, v in shard.final_stats.items()
                        if k in WorkerStats.FIELDS})
            fold_counters(snap, {
                "tf_%s_total" % k: v for k, v in wf.retired_stats.items()
                if k in WorkerStats.FIELDS})
            breaker = wf.breaker.snapshot()
            fold_counters(snap, {"tf_rebalance_total": wf.rebalances,
                                 "tf_shard_failures_total": wf.crashes,
                                 "tf_circuit_open_total":
                                     breaker["opened_total"],
                                 "tf_node_recoveries_total":
                                     wf.node_recoveries})
            g = snap["gauges"]
            g["tf_restart_backoff_seconds"] = (
                g.get("tf_restart_backoff_seconds", 0.0)
                + breaker["restart_backoff_seconds"])
            g["tf_recovery_seconds"] = (
                g.get("tf_recovery_seconds", 0.0) + wf.recovery_seconds)
            rep = getattr(self.event_store, "_rep", None)
            if rep is not None:
                # the parent's own unacked publishes (shard lag arrives via
                # the scraped child snapshots above)
                g["tf_replication_lag_bytes"] = (
                    g.get("tf_replication_lag_bytes", 0)
                    + rep.replica_lag_bytes())
        return snap

    def trace_spans(self, workflow: Optional[str] = None) -> List[dict]:
        """Stitched span records from every shard's span segment (one file
        per shard process under ``<root>/spans``), deduplicated by span id —
        completed records win over their open (pre-crash) twins."""
        from ..obs.trace import load_spans, stitch_spans
        return stitch_spans(load_spans([self.trace_dir]))

    def metrics(self, workflow: str) -> Dict[str, Any]:
        with self._lock:
            wf = self._wfs.get(workflow)
            shards = self._live(wf) if wf else []
            out = {
                "shards": len(shards),
                "crashes": wf.crashes if wf else 0,
                "rebalances": wf.rebalances if wf else 0,
                "node_recoveries": wf.node_recoveries if wf else 0,
                "breaker": wf.breaker.snapshot() if wf else {},
                "generation": wf.group.generation if wf else 0,
                "assignment": {s.member: list(s.partitions) for s in shards},
                "partition_lags": self.event_store.partition_lags(workflow),
                "commit_offsets": self.event_store.commit_offsets(workflow),
                "total_lag": self.event_store.lag(workflow),
            }
        out["obs"] = self.obs_snapshot(workflow)
        return out

    def result(self, workflow: str) -> Any:
        with self._lock:
            wf = self._wfs.get(workflow)
            if wf is not None and wf.finished:
                return wf.result
        meta = self.state_store.get_workflow(workflow) or {}
        return meta.get("result")

    def wait_drained(self, workflow: str, timeout: float = 60.0,
                     poll: float = 0.02) -> None:
        """Block until every published event is committed (lag 0).  The
        multiprocess analogue of the thread pool's ``drive`` exit condition.
        Each poll also reaps shards whose process died on its own (a failed
        batch exits non-zero), so their partitions rebalance to survivors
        instead of stalling the drain until the timeout."""
        deadline = time.monotonic() + timeout
        while self.event_store.lag(workflow) > 0:
            self.reap(workflow)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    "workflow %r did not drain: " % workflow
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
        try:
            dlq = self.event_store.dlq_by_reason(workflow)
        except Exception:  # noqa: BLE001
            dlq = {}
        with self._lock:
            wf = self._wfs.get(workflow)
            breaker = wf.breaker.snapshot() if wf else {}
            recoveries = wf.node_recoveries if wf else 0
        try:
            rep_lag = self.replica_lag(workflow)
        except Exception:  # noqa: BLE001
            rep_lag = {}
        try:
            leases = self.event_store.lease_holders(workflow)
        except Exception:  # noqa: BLE001
            leases = {}
        return (f"lag={sum(lags.values())} "
                f"partition_lags={ {p: n for p, n in lags.items() if n} } "
                f"dlq_by_reason={dlq} "
                f"live_shards={self.live_shard_count(workflow)} "
                f"breaker={breaker} "
                f"replica_lag={rep_lag} "
                f"leases={leases} "
                f"node_recoveries={recoveries}")
