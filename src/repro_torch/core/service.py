"""Triggerflow service facade (paper Fig. 1 API):

``create_workflow`` / ``add_trigger`` / ``add_event_source`` / ``get_state``
plus ``publish`` and worker lifecycle management.  The service wires together
the event store, the state store (database), the function backend, the timer
source and the controller/autoscaler.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Optional, Union

from .device import resolve_device
from .events import TYPE_INIT, CloudEvent
from .eventstore import EventStore, MemoryEventStore
from .functions import FunctionBackend, TimerSource
from .statestore import MemoryStateStore, StateStore
from .triggers import Trigger
from .worker import TFWorker


class Triggerflow:
    def __init__(
        self,
        event_store: Optional[EventStore] = None,
        state_store: Optional[StateStore] = None,
        backend: Optional[FunctionBackend] = None,
        inline_functions: bool = False,
        commit_policy: str = "on_fire",
        num_partitions: Optional[int] = None,
        num_shards: int = 1,
        pool=None,
        device: str = "cuda",
    ) -> None:
        # The device the workload runs on (the counterpart of JAX's implicit
        # placement): the worker's join backend and the serving engine take
        # it from here.  A CUDA device without CUDA raises; nothing falls back.
        self.device = resolve_device(device)
        # A deployment-owned pool (e.g. repro.bus.ProcessShardPool) brings
        # its own stores: the facade and the autoscaler then drive *it*
        # instead of building a threaded pool — the ScalablePool protocol
        # (core.autoscaler) is the only contract between them.
        if pool is not None:
            event_store = event_store or pool.event_store
            state_store = state_store or pool.state_store
        if event_store is None and (num_partitions is not None or num_shards > 1):
            from ..bus import PartitionedEventStore

            event_store = PartitionedEventStore(num_partitions or max(2 * num_shards, 8))
        self.event_store = event_store or MemoryEventStore()
        self.state_store = state_store or MemoryStateStore()
        self.backend = backend or FunctionBackend(self.event_store, inline=inline_functions)
        self.timers = TimerSource(self.event_store)
        self.commit_policy = commit_policy
        self.num_shards = max(1, num_shards)
        self._workers: Dict[str, TFWorker] = {}
        self._threads: Dict[str, threading.Thread] = {}
        self._lock = threading.RLock()
        # Sharded runtime rides on any partition-capable store (repro.bus).
        self.pool = pool
        if pool is None and hasattr(self.event_store, "consume_partitions"):
            from ..bus import ShardedWorkerPool

            self.pool = ShardedWorkerPool(
                self.event_store,
                self.state_store,
                self.backend,
                timers=self.timers,
                commit_policy=self.commit_policy,
                device=self.device,
            )

    # -- Fig. 1 API -----------------------------------------------------------
    def create_workflow(self, workflow: str, meta: Optional[Dict[str, Any]] = None) -> None:
        self.event_store.create_stream(workflow)
        m = {"status": "created"}
        m.update(meta or {})
        self.state_store.put_workflow(workflow, m)

    def add_trigger(self, workflow: str, trigger: Union[Trigger, Iterable[Trigger]]) -> List[str]:
        triggers = [trigger] if isinstance(trigger, Trigger) else list(trigger)
        worker = self._workers.get(workflow)
        ids = []
        for trg in triggers:
            if self.pool is not None and self.pool.shard_count(workflow) > 0:
                ids.append(self.pool.add_trigger(workflow, trg))
            elif worker is not None:
                ids.append(worker.add_trigger(trg))
            else:
                self.state_store.put_trigger(workflow, trg.trigger_id, trg.to_dict())
                ids.append(trg.trigger_id)
        return ids

    def add_event_source(self, workflow: str, source) -> None:
        """Attach an external event source: anything with ``start(publish_fn)``."""
        source.start(lambda ev: self.event_store.publish(workflow, ev))

    def get_state(self, workflow: str) -> Optional[Dict[str, Any]]:
        return self.state_store.get_workflow(workflow)

    def get_trigger_context(self, workflow: str, trigger_id: str) -> Dict[str, Any]:
        if self.pool is not None and self.pool.shard_count(workflow) > 0:
            ctx = self.pool.trigger_context(workflow, trigger_id)
            if ctx:
                return ctx
        worker = self._workers.get(workflow)
        if worker is not None:
            return dict(worker.context_of(trigger_id))
        return self.state_store.get_contexts(workflow).get(trigger_id, {})

    # -- events ------------------------------------------------------------------
    def publish(self, workflow: str, event: CloudEvent) -> None:
        self.event_store.publish(workflow, event)

    def init_workflow(self, workflow: str, data: Any = None, subject: str = "$init") -> None:
        self.publish(workflow, CloudEvent(subject=subject, type=TYPE_INIT, data=data))

    def timeout(self, workflow: str, subject: str, delay: float) -> None:
        from .events import TYPE_TIMEOUT

        self.timers.after(workflow, delay, CloudEvent(subject=subject, type=TYPE_TIMEOUT))

    # -- interception (Def. 5) ------------------------------------------------------
    def intercept(
        self,
        workflow: str,
        interceptor_action: Dict[str, Any],
        trigger_id: Optional[str] = None,
        condition_name: Optional[str] = None,
    ) -> None:
        worker = self.worker(workflow)
        if trigger_id is not None:
            worker.intercept(trigger_id, interceptor_action)
        elif condition_name is not None:
            worker.intercept_by_condition(condition_name, interceptor_action)
        else:
            raise ValueError("need trigger_id or condition_name")

    # -- worker lifecycle -----------------------------------------------------------
    def start_shards(self, workflow: str, count: Optional[int] = None,
                     idle_timeout: Optional[float] = None) -> List[str]:
        """Run ``count`` worker shards (threads) for the workflow (repro.bus)."""
        if self.pool is None:
            raise RuntimeError("start_shards needs a partitioned event store "
                               "(construct Triggerflow with num_shards/num_partitions)")
        return self.pool.start_shards(workflow, count or self.num_shards,
                                      idle_timeout=idle_timeout)

    def worker(self, workflow: str) -> TFWorker:
        # Pool-backed mode: the workflow is served by shards; hand back the
        # first *in-process* one (they share trigger defs; contexts live with
        # the shard owning the subject's partition — see get_trigger_context).
        # Process pools have no in-process workers, so they fall through to a
        # classic facade worker (which must then only be used for read-side
        # APIs, never driven against live shard processes).
        if self.pool is not None and self.pool.shard_count(workflow) > 0:
            local = getattr(self.pool, "local_worker", None)
            if local is not None:
                w = local(workflow)
                if w is not None:
                    return w
        with self._lock:
            w = self._workers.get(workflow)
            if w is None:
                w = TFWorker(
                    workflow,
                    self.event_store,
                    self.state_store,
                    self.backend,
                    commit_policy=self.commit_policy,
                    timers=self.timers,
                    device=self.device,
                )
                self._workers[workflow] = w
            return w

    def evict_worker(self, workflow: str) -> None:
        """Drop the in-memory worker (simulates a pod being reclaimed/crashed);
        a later ``worker()`` call reconstructs state from the stores."""
        with self._lock:
            w = self._workers.pop(workflow, None)
            if w is not None:
                w.stop()

    def start_worker(self, workflow: str, idle_timeout: Optional[float] = None) -> threading.Thread:
        w = self.worker(workflow)
        th = threading.Thread(
            target=w.run_forever, kwargs={"idle_timeout": idle_timeout},
            name=f"tf-worker-{workflow}", daemon=True,
        )
        with self._lock:
            self._threads[workflow] = th
        th.start()
        return th

    def worker_alive(self, workflow: str) -> bool:
        th = self._threads.get(workflow)
        return th is not None and th.is_alive()

    def run_until_complete(self, workflow: str, timeout: float = 60.0) -> Any:
        if self.pool is not None:
            if hasattr(self.pool, "drive"):
                if self.pool.shard_count(workflow) > 0:
                    return self.pool.drive(workflow, timeout=timeout)
            else:
                # A pool without drive (process pool) owns the stream even at
                # zero shards — an autoscaler (or a later start_shards) forks
                # the consumers.  Never drive a facade worker against it: a
                # second consumer on the shared bus double-fires (§3.4).
                self.pool.wait_drained(workflow, timeout=timeout)
                return self.pool.result(workflow)
        return self.worker(workflow).run_until_complete(timeout=timeout)

    def metrics_snapshot(self, workflow: Optional[str] = None) -> Dict[str, Any]:
        """One aggregated metrics snapshot for the whole deployment: every
        classic facade worker plus, when a shard pool serves the workflows,
        the pool's per-shard registries (thread pool merges in-process;
        process pool scrapes over the command pipe)."""
        from ..obs.metrics import empty_snapshot, merge_snapshot
        snap = empty_snapshot()
        with self._lock:
            workers = list(self._workers.values())
        for w in workers:
            if workflow is None or w.workflow == workflow:
                merge_snapshot(snap, w.metrics_snapshot())
        if self.pool is not None and hasattr(self.pool, "obs_snapshot"):
            wfs = [workflow] if workflow is not None \
                else self.event_store.workflows()
            for wf in wfs:
                merge_snapshot(snap, self.pool.obs_snapshot(wf))
        return snap

    def shutdown(self) -> None:
        if self.pool is not None:
            self.pool.stop_all()
        for w in self._workers.values():
            w.stop()
        for th in self._threads.values():
            th.join(timeout=2.0)
        self.timers.cancel_all()
        self.backend.shutdown()
