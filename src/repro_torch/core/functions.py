"""Simulated serverless-function backend (the data plane's task executor).

In the paper, trigger Actions asynchronously invoke cloud functions (IBM CF /
AWS Lambda) which later emit termination CloudEvents.  Offline we model this
with a thread pool: ``invoke`` schedules a registered callable; on completion
a ``termination.success`` event (with the result) — or ``termination.failure``
(with the error) — is published to the workflow's event stream.

``inline=True`` executes in the caller thread (deterministic single-threaded
orchestration-overhead benchmarks, isolating trigger overhead from threading).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional

from .events import failure_event, termination_event
from .eventstore import EventStore


class FunctionBackend:
    def __init__(self, event_store: EventStore, max_workers: int = 64, inline: bool = False):
        self.event_store = event_store
        self.inline = inline
        self._pool: Optional[ThreadPoolExecutor] = None
        self._max_workers = max_workers
        self.registry: Dict[str, Callable[[Any], Any]] = {}
        self.invocations = 0
        self._lock = threading.Lock()

    # -- registry --------------------------------------------------------------
    def register(self, name: str, fn: Callable[[Any], Any]) -> None:
        self.registry[name] = fn

    def function(self, name: str) -> Callable[[Callable], Callable]:
        def deco(fn: Callable) -> Callable:
            self.register(name, fn)
            return fn

        return deco

    # -- invocation --------------------------------------------------------------
    def _run(self, workflow: str, fn_name: str, args: Any, subject: str, delay: float) -> None:
        try:
            if delay > 0:
                time.sleep(delay)
            result = self.registry[fn_name](args)
            self.event_store.publish(workflow, termination_event(subject, result=result, fn=fn_name))
        except Exception as exc:  # noqa: BLE001 - failures become failure events
            self.event_store.publish(workflow, failure_event(subject, error=str(exc), fn=fn_name))

    def invoke(self, workflow: str, fn_name: str, args: Any, subject: str, delay: float = 0.0) -> None:
        with self._lock:
            self.invocations += 1
        if self.inline:
            self._run(workflow, fn_name, args, subject, delay)
            return
        if self._pool is None:
            with self._lock:
                if self._pool is None:
                    self._pool = ThreadPoolExecutor(max_workers=self._max_workers,
                                                    thread_name_prefix="tf-fn")
        self._pool.submit(self._run, workflow, fn_name, args, subject, delay)

    def shutdown(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


class TimerSource:
    """Timer event source (Wait states §5.2, FL round timeouts §5.4)."""

    def __init__(self, event_store: EventStore):
        self.event_store = event_store
        self._timers: list = []

    def after(self, workflow: str, delay: float, event) -> threading.Timer:
        t = threading.Timer(delay, self.event_store.publish, args=(workflow, event))
        t.daemon = True
        t.start()
        self._timers.append(t)
        return t

    def cancel_all(self) -> None:
        for t in self._timers:
            t.cancel()
        self._timers.clear()
