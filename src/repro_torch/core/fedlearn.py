"""§5.4 — Federated Learning orchestrator built from two persistent triggers.

* ``round`` trigger — starts a training round: resets the aggregator, invokes
  every available client "function", arms a timeout, and decides at round end
  whether to continue or finish.
* ``aggregator`` trigger — a custom *threshold* condition: fires when
  ``threshold``·|clients| round-tagged termination events arrived, or when the
  round timeout event lands (so failed/straggler clients can never hang the
  workflow — Fig. 17 round 3).  Its action aggregates the partial weights from
  the object store, deletes intermediates, and signals the round trigger.

Clients are heterogeneous/unreliable by design: they receive
``{"round", "client", "model"}``, train locally, ``put`` their delta into the
object store and return its key.  The controller can be fully deprovisioned
during training: all orchestration state lives in trigger contexts.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from .actions import register_pyfunc
from .conditions import register_condition
from .events import TYPE_TIMEOUT, termination_event
from .service import Triggerflow
from .triggers import make_trigger

_FL: Dict[str, "FederatedLearningOrchestrator"] = {}


class ObjectStore:
    """COS/S3 stand-in for model weights (events never carry big payloads —
    the paper's control/data-plane split, §3.3)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._data: Dict[str, Any] = {}
        self.puts = 0
        self.gets = 0

    def put(self, key: str, value: Any) -> str:
        with self._lock:
            self._data[key] = value
            self.puts += 1
        return key

    def get(self, key: str) -> Any:
        with self._lock:
            self.gets += 1
            return self._data[key]

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._data.keys())


def _fl_aggregator_condition(ctx, event, params) -> bool:
    """Round-scoped threshold join: stale events from earlier rounds are
    ignored; timeouts fire the aggregation with whatever arrived."""
    rnd = ctx.get("round", 0)
    data = event.data if isinstance(event.data, dict) else {}
    ev_round = data.get("round", (data.get("result") or {}).get("round")
               if isinstance(data.get("result"), dict) else None)
    if event.type == TYPE_TIMEOUT:
        if data.get("round") != rnd or ctx.get("done_round") == rnd:
            return False  # stale timer
        ctx["timed_out_rounds"] = ctx.get("timed_out_rounds", []) + [rnd]
        fire = ctx.get("count", 0) >= int(params.get("min_results", 1))
        if fire:
            ctx["done_round"] = rnd
            ctx["fired_results"] = ctx.get("results") or []
        return fire
    if ev_round != rnd or ctx.get("done_round") == rnd:
        return False
    cnt = ctx.get("count", 0) + 1
    ctx["count"] = cnt
    results = ctx.get("results") or []
    res = data.get("result")
    if isinstance(res, dict) and "round" in res and "result" in res:
        res = res["result"]  # unwrap round-tagged client payloads
    results.append(res)
    ctx["results"] = results
    expected = int(ctx.get("expected", 1))
    threshold = float(ctx.get("threshold", 1.0))
    import math

    if cnt >= max(1, math.ceil(expected * threshold)):
        ctx["done_round"] = rnd
        ctx["fired_results"] = results
        return True
    return False


register_condition("fl_aggregator", _fl_aggregator_condition)


class FederatedLearningOrchestrator:
    def __init__(
        self,
        tf: Triggerflow,
        workflow: str,
        client_fn: Callable[[Dict[str, Any]], Any],
        aggregate_fn: Callable[[List[Any], "ObjectStore"], Any],
        n_clients: int,
        rounds: int,
        threshold: float = 1.0,
        round_timeout: Optional[float] = None,
        object_store: Optional[ObjectStore] = None,
        stop_fn: Optional[Callable[[Any, int], bool]] = None,
    ) -> None:
        self.tf = tf
        self.workflow = workflow
        self.client_fn = client_fn
        self.aggregate_fn = aggregate_fn
        self.n_clients = n_clients
        self.rounds = rounds
        self.threshold = threshold
        self.round_timeout = round_timeout
        self.store = object_store or ObjectStore()
        self.stop_fn = stop_fn
        self.round_log: List[Dict[str, Any]] = []
        _FL[workflow] = self

    def deploy(self) -> None:
        self.tf.create_workflow(self.workflow, {"kind": "fedlearn"})
        self.tf.backend.register(f"{self.workflow}:client", self.client_fn)
        round_trg = make_trigger(
            "fl|round",
            action={"name": "pyfunc", "func": "fl.round", "fl": self.workflow},
            trigger_id=f"{self.workflow}/round",
            transient=False,
        )
        agg_trg = make_trigger(
            "fl|agg",
            condition={"name": "fl_aggregator", "min_results": 1},
            action={"name": "pyfunc", "func": "fl.aggregate", "fl": self.workflow},
            trigger_id=f"{self.workflow}/agg",
            transient=False,
            context={"round": -1},
        )
        self.tf.add_trigger(self.workflow, [round_trg, agg_trg])

    def start(self, init_model: Any, timeout: float = 120.0) -> Any:
        self.store.put("model/0", init_model)
        self.tf.publish(self.workflow,
                        termination_event("fl|round", result={"round": 0, "model": "model/0"}))
        return self.tf.run_until_complete(self.workflow, timeout=timeout)


def _fl_round(ctx, event, params) -> None:
    fl = _FL[params["fl"]]
    data = (event.data or {}).get("result") or {}
    rnd, model_key = int(data.get("round", 0)), data.get("model")
    stop = rnd >= fl.rounds or (fl.stop_fn is not None
                                and fl.stop_fn(fl.store.get(model_key), rnd))
    if stop:
        ctx.workflow_result({"status": "succeeded",
                             "result": {"model": model_key, "rounds": rnd}})
        return
    # arm the aggregator for this round via introspection (§3.2 Context)
    agg_ctx = ctx.get_trigger_context(f"{fl.workflow}/agg")
    agg_ctx.update({"round": rnd, "expected": fl.n_clients, "count": 0,
                    "results": [], "threshold": fl.threshold, "model": model_key})
    for i in range(fl.n_clients):
        ctx.invoke(f"{fl.workflow}:client",
                   {"round": rnd, "client": i, "model": model_key}, "fl|agg")
    if fl.round_timeout is not None:
        ctx.timeout("fl|agg", fl.round_timeout, data={"round": rnd})


def _fl_aggregate(ctx, event, params) -> None:
    fl = _FL[params["fl"]]
    rnd = ctx.get("round", 0)
    results = [r for r in (ctx.get("fired_results") or []) if r is not None]
    new_model = fl.aggregate_fn(results, fl.store)
    new_key = fl.store.put(f"model/{rnd + 1}", new_model)
    for r in results:  # delete intermediate client deltas (paper §5.4)
        if isinstance(r, str):
            fl.store.delete(r)
    fl.round_log.append({"round": rnd, "n_results": len(results),
                         "timed_out": rnd in (ctx.get("timed_out_rounds") or [])})
    ctx.produce(termination_event(
        "fl|round", result={"round": rnd + 1, "model": new_key}))


register_pyfunc("fl.round", _fl_round)
register_pyfunc("fl.aggregate", _fl_aggregate)
