"""§5.3 — Workflow as Code with event sourcing (Lithops / Durable-Functions
style) on top of dynamic triggers.

The user writes an ordinary imperative *orchestrator function*::

    def my_workflow(ex):
        f = ex.call_async("train", {"steps": 100})
        state = f.result()                     # suspends here until the event
        parts = ex.map("evaluate", shards)     # fan-out
        return combine(parts.result())

Calling ``.result()`` on an unresolved future raises ``Suspend``: the
orchestrator stops (and can be deprovisioned — scale-to-zero while the tasks
run).  Each ``call_async``/``map`` registers a *dynamic trigger* on a
deterministic invocation key; when the termination event(s) arrive, the
trigger fires and **replays** the orchestrator from the start.  Replay is pure
event sourcing: previously-invoked calls resolve instantly from recorded
results, so execution continues from the last suspension point.  User code is
unchanged between local and Triggerflow execution (paper: Lithops portability).

Two schedulers, as in the paper:
* ``native``   — replay inside the TF-Worker action; results are resolved
                 from the wake triggers' in-memory contexts (fast path).
* ``external`` — simulates Lithops/ADF: the orchestrator runs as a backend
                 "cloud function"; every replay re-reads the event store
                 (``committed_events`` + wake contexts), counting store
                 round-trips — the quantity Fig. 11 measures.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

from .actions import register_pyfunc
from .service import Triggerflow
from .triggers import make_trigger

_ORCHESTRATORS: Dict[str, "WorkflowAsCode"] = {}


class Suspend(Exception):
    """Raised when awaiting a future whose termination event hasn't arrived."""


class TFFuture:
    __slots__ = ("key", "_executor", "n")

    def __init__(self, key: str, executor: "CodeExecutor", n: int = 1):
        self.key = key
        self._executor = executor
        self.n = n

    def done(self) -> bool:
        return self.key in self._executor.resolved

    def result(self) -> Any:
        if not self.done():
            raise Suspend(self.key)
        return self._executor.resolved[self.key]


class CodeExecutor:
    """Per-replay execution context handed to the orchestrator function."""

    def __init__(self, wac: "WorkflowAsCode", ctx, resolved: Dict[str, Any]):
        self._wac = wac
        self._ctx = ctx  # ctrl trigger context (persists `invoked`)
        self.resolved = resolved
        self._seq = 0
        self.store_requests = 0  # external-scheduler accounting (Fig. 11)

    def _next_key(self, kind: str) -> str:
        key = f"wac|{kind}{self._seq}"
        self._seq += 1
        return key

    # -- the Lithops-like API -------------------------------------------------
    def call_async(self, fn_name: str, args: Any = None) -> TFFuture:
        key = self._next_key("c")
        self._ensure_invoked(key, fn_name, [args], 1)
        return TFFuture(key, self, 1)

    def map(self, fn_name: str, items) -> TFFuture:
        items = list(items)
        key = self._next_key("m")
        self._ensure_invoked(key, fn_name, items, len(items))
        return TFFuture(key, self, len(items))

    def _ensure_invoked(self, key: str, fn_name: str, args_list: List[Any], n: int) -> None:
        invoked = self._ctx.get("invoked") or {}
        if key in invoked:
            return
        # dynamic trigger: termination event(s) on `key` wake the orchestrator
        self._ctx.add_trigger(make_trigger(
            key,
            condition={"name": "counter", "expected": max(n, 1)},
            action={"name": "pyfunc", "func": "wac.wake", "wac": self._wac.wac_id,
                    "key": key},
            trigger_id=f"{self._wac.workflow}/{key}",
        ))
        for a in args_list:
            self._ctx.invoke(fn_name, a, key)
        invoked[key] = n
        self._ctx["invoked"] = invoked


class WorkflowAsCode:
    def __init__(self, tf: Triggerflow, workflow: str,
                 orchestrator: Callable[[CodeExecutor], Any],
                 scheduler: str = "native"):
        assert scheduler in ("native", "external")
        self.tf = tf
        self.workflow = workflow
        self.orchestrator = orchestrator
        self.scheduler = scheduler
        self.wac_id = workflow
        self.replays = 0
        self.store_requests = 0
        _ORCHESTRATORS[self.wac_id] = self

    def deploy(self) -> None:
        self.tf.create_workflow(self.workflow, {"kind": "workflow_as_code",
                                                "scheduler": self.scheduler})
        self.tf.add_trigger(self.workflow, make_trigger(
            "$init",
            action={"name": "pyfunc", "func": "wac.wake", "wac": self.wac_id,
                    "key": "$init"},
            trigger_id=f"{self.workflow}/$ctrl",
            transient=False,
        ))

    def run(self, timeout: float = 60.0) -> Any:
        self.tf.init_workflow(self.workflow)
        return self.tf.run_until_complete(self.workflow, timeout=timeout)

    # -- replay ------------------------------------------------------------------
    def _resolve_results(self, ctx) -> Dict[str, Any]:
        """Event sourcing: reconstruct {invocation key -> result(s)}."""
        invoked = ctx.get("invoked") or {}
        resolved: Dict[str, Any] = {}
        if self.scheduler == "external":
            # cloud-function replay: one store read per step (the n-requests
            # behaviour Fig. 11 quantifies), from durable committed events +
            # checkpointed trigger contexts
            self.store_requests += 1
            events = ctx.committed_events() + ctx.local_events()
            by_key: Dict[str, List[Any]] = {}
            for ev in events:
                if ev.subject in invoked and isinstance(ev.data, dict) and "result" in ev.data:
                    by_key.setdefault(ev.subject, []).append(ev.data["result"])
            for key, n in invoked.items():
                vals = by_key.get(key, [])
                if len(vals) >= n:
                    resolved[key] = vals[0] if key.startswith("wac|c") else vals[:n]
        else:
            # native scheduler: wake-trigger contexts hold aggregated results
            for key, n in invoked.items():
                tid = f"{self.workflow}/{key}"
                try:
                    tctx = ctx.get_trigger_context(tid)
                except KeyError:
                    continue
                vals = tctx.get("fired_results") or tctx.get("results") or []
                if len(vals) >= n:
                    resolved[key] = vals[0] if key.startswith("wac|c") else list(vals[:n])
        return resolved

    def replay(self, ctx) -> None:
        self.replays += 1
        resolved = self._resolve_results(ctx)
        ex = CodeExecutor(self, ctx, resolved)
        try:
            out = self.orchestrator(ex)
        except Suspend:
            return  # parked until the next termination event wakes us
        ctx.workflow_result({"status": "succeeded", "result": out,
                             "replays": self.replays})


def _wake(ctx, event, params) -> None:
    wac = _ORCHESTRATORS[params["wac"]]
    # ctrl context lives on the $ctrl trigger; wake triggers delegate to it
    ctrl_ctx = ctx if params["key"] == "$init" else ctx.get_trigger_context(
        f"{wac.workflow}/$ctrl")
    if wac.scheduler == "external":
        # run in a backend thread like a re-invoked cloud function
        wac.replay(ctrl_ctx)
    else:
        wac.replay(ctrl_ctx)


register_pyfunc("wac.wake", _wake)
