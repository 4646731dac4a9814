"""Condition registry (paper §3.2: Conditions are user-defined active rules).

Conditions are referenced by name + JSON params so triggers stay serializable.
A condition is ``fn(context, event, params) -> bool``; it may mutate the
context (stateful composite event detection: counters, aggregation) and MUST
be idempotent w.r.t. re-delivered events (§3.4) — the built-in aggregators
offer an ``exactly_once`` param that dedups by event id inside the context.

Batched-condition protocol (the worker's batch plane)
-----------------------------------------------------
A condition may additionally register a *batched* implementation
``fn_batch(ctx, events, params) -> fire_index | None`` via
``register_condition(name, fn, batched=fn_batch)``.  The contract:

* ``events`` is a non-empty, **type-uniform** slice of CloudEvents addressed
  to this trigger, in arrival order (the worker groups each consumed batch
  by ``(subject, type)``).
* The batched fn must be semantically identical to folding the scalar fn
  over the slice: it returns ``None`` if no event fires (the whole slice is
  consumed and the context reflects it), or the smallest index ``i`` at
  which the scalar fn would have returned True — with the context reflecting
  consumption of ``events[:i + 1]`` only.  The worker then runs the action
  with ``events[i]`` and re-enters the batched fn on the remaining slice.
* Anything the batched fn cannot replicate exactly (``exactly_once`` dedup
  under redelivery, timeout handling) falls back to sweeping the scalar fn
  over the slice via ``scalar_sweep`` — correctness first, speed second.

Fire-run protocol (the worker's action plane)
---------------------------------------------
The batched protocol above still re-enters the condition once per *fire* —
fine for sparse joins, but a trigger that fires on (nearly) every event
(the Table-1 noop scenario) degenerates back to one Python round-trip per
event.  A condition may therefore also register a *fire-run* implementation
``fn_run(ctx, events, params) -> list[int] | None`` via
``register_condition(name, fn, batched=..., fire_run=fn_run)``:

* It consumes the **whole** type-uniform slice in one call and returns the
  ascending positions at which the scalar fn would have returned True, with
  the context reflecting full consumption — i.e. it collapses the entire
  evaluate→fire→re-enter loop into one call plus one batched action.
* Returning ``None`` declines the run (``exactly_once`` dedup, timeouts,
  anything needing per-event care) and the worker falls back to the
  per-fire batched/scalar path above.  A fire-run fn must decline *before*
  mutating the context — the fallback re-evaluates the same slice.
* The worker only takes this path for non-transient triggers whose action
  has a batched implementation (``actions.BATCHED_ACTIONS``): transient
  triggers must stop at their first fire, and scalar-only actions keep the
  exact condition/action interleaving of the per-fire path.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

from .events import TYPE_FAILURE, TYPE_TIMEOUT, CloudEvent

ConditionFn = Callable[[Any, CloudEvent, Dict[str, Any]], bool]
BatchedConditionFn = Callable[[Any, List[CloudEvent], Dict[str, Any]], Optional[int]]
FireRunConditionFn = Callable[[Any, List[CloudEvent], Dict[str, Any]],
                              Optional[List[int]]]

CONDITIONS: Dict[str, ConditionFn] = {}
#: Opt-in batched implementations, keyed like ``CONDITIONS``.
BATCHED_CONDITIONS: Dict[str, BatchedConditionFn] = {}
#: Opt-in fire-run implementations (whole-slice fire positions), keyed alike.
FIRE_RUN_CONDITIONS: Dict[str, FireRunConditionFn] = {}


def condition(name: str, batched: Optional[BatchedConditionFn] = None,
              fire_run: Optional[FireRunConditionFn] = None
              ) -> Callable[[ConditionFn], ConditionFn]:
    def deco(fn: ConditionFn) -> ConditionFn:
        register_condition(name, fn, batched=batched, fire_run=fire_run)
        return fn

    return deco


def register_condition(name: str, fn: ConditionFn,
                       batched: Optional[BatchedConditionFn] = None,
                       fire_run: Optional[FireRunConditionFn] = None) -> None:
    """Third-party extension point (paper: extensible at all levels).

    ``batched`` opts the condition into the worker's batch plane, ``fire_run``
    additionally into the action plane; without them the worker degrades to
    the scalar / per-fire path for this condition's slices."""
    CONDITIONS[name] = fn
    if batched is not None:
        BATCHED_CONDITIONS[name] = batched
    else:
        # re-registering without a batched impl must not leave a stale one
        BATCHED_CONDITIONS.pop(name, None)
    if fire_run is not None:
        FIRE_RUN_CONDITIONS[name] = fire_run
    else:
        FIRE_RUN_CONDITIONS.pop(name, None)


def batched_condition(name: str) -> Callable[[BatchedConditionFn], BatchedConditionFn]:
    """Attach a batched implementation to an already-registered condition."""
    def deco(fn: BatchedConditionFn) -> BatchedConditionFn:
        BATCHED_CONDITIONS[name] = fn
        return fn

    return deco


def fire_run_condition(name: str) -> Callable[[FireRunConditionFn], FireRunConditionFn]:
    """Attach a fire-run implementation to an already-registered condition."""
    def deco(fn: FireRunConditionFn) -> FireRunConditionFn:
        FIRE_RUN_CONDITIONS[name] = fn
        return fn

    return deco


def scalar_sweep(fn: ConditionFn, ctx, events: List[CloudEvent],
                 params: Dict[str, Any]) -> Optional[int]:
    """Reference fold of a scalar condition over a slice — the semantics every
    batched implementation must match, and the fallback they delegate to."""
    for i, event in enumerate(events):
        if fn(ctx, event, params):
            return i
    return None


def _result_of(event: CloudEvent) -> Any:
    if isinstance(event.data, dict) and "result" in event.data:
        return event.data["result"]
    return event.data


@condition("true")
def _true(ctx, event, params) -> bool:
    return True


@batched_condition("true")
def _true_batch(ctx, events, params) -> Optional[int]:
    return 0


@fire_run_condition("true")
def _true_run(ctx, events, params) -> Optional[List[int]]:
    return list(range(len(events)))


@condition("false")
def _false(ctx, event, params) -> bool:
    return False


@batched_condition("false")
def _false_batch(ctx, events, params) -> Optional[int]:
    return None


@fire_run_condition("false")
def _false_run(ctx, events, params) -> Optional[List[int]]:
    return []


def _seen_set(ctx) -> set:
    """The exactly-once dedup index as an in-memory set.

    Checkpoints serialize it as a sorted list (``context.jsonable``); a
    recovered context therefore holds a list, converted back on first use.
    Kept as a set in memory so 10k-event joins don't scan a list per event
    (the old O(n²) behavior)."""
    seen = ctx.get("seen_ids")
    if isinstance(seen, set):
        return seen
    seen = set(seen) if seen else set()
    ctx["seen_ids"] = seen
    return seen


def _dedup(ctx, event, params) -> bool:
    """Returns True if this event was already counted (skip it)."""
    if not params.get("exactly_once", False):
        return False
    seen = _seen_set(ctx)
    if event.id in seen:
        return True
    seen.add(event.id)
    ctx["seen_ids"] = seen  # same object; assignment marks the key dirty
    return False


@condition("counter")
def _counter(ctx, event, params) -> bool:
    """Composite-event aggregation: fire after ``expected`` activations.

    ``expected`` is read from the context first so an upstream Map action can
    set it dynamically via introspection (§5.1); falls back to params.
    Aggregates each event's result into ``ctx['results']`` unless
    ``aggregate=False`` (pure join counters for the Table 1 load test).
    """
    if event.type == TYPE_FAILURE:
        # failures never satisfy a join; a companion failure trigger handles them
        ctx["failures"] = ctx.get("failures", 0) + 1
        return False
    if _dedup(ctx, event, params):
        return ctx.get("count", 0) >= int(ctx.get("expected", params.get("expected", 1)))
    cnt = ctx.get("count", 0) + 1
    ctx["count"] = cnt
    if params.get("aggregate", True):
        results = ctx.get("results") or []
        results.append(_result_of(event))
        ctx["results"] = results
    expected = int(ctx.get("expected", params.get("expected", 1)))
    if cnt >= expected:
        # snapshot for the action, then optionally reset so persistent join
        # triggers can be re-fired (ASL loops, FL rounds)
        ctx["fired_results"] = ctx.get("results") or []
        if params.get("reset_on_fire"):
            ctx["count"] = 0
            ctx["results"] = []
            if params.get("exactly_once"):
                ctx["seen_ids"] = set()
        return True
    return False


def _count_slice(ctx, events, cnt: int, threshold: int,
                 aggregate: bool) -> Optional[int]:
    """Shared counting core of the batched aggregators: advance ``count``
    over the slice (appending results when aggregating) and return the fire
    index where the running count reaches ``threshold``, or None.  When the
    count is already at/over the threshold the first event fires — matching
    the scalar aggregators, which keep returning True once satisfied."""
    n = len(events)
    if cnt + n < threshold:
        ctx["count"] = cnt + n
        if aggregate:
            results = ctx.get("results") or []
            results.extend(_result_of(e) for e in events)
            ctx["results"] = results
        return None
    fire_idx = max(0, threshold - cnt - 1)
    take = fire_idx + 1
    ctx["count"] = cnt + take
    if aggregate:
        results = ctx.get("results") or []
        results.extend(_result_of(e) for e in events[:take])
        ctx["results"] = results
    return fire_idx


@batched_condition("counter")
def _counter_batch(ctx, events, params) -> Optional[int]:
    if events[0].type == TYPE_FAILURE:
        # type-uniform slice: every event is a failure notification
        ctx["failures"] = ctx.get("failures", 0) + len(events)
        return None
    if params.get("exactly_once", False):
        # redelivery dedup interleaves with counting — scalar is the oracle
        return scalar_sweep(_counter, ctx, events, params)
    expected = int(ctx.get("expected", params.get("expected", 1)))
    fire_idx = _count_slice(ctx, events, ctx.get("count", 0), expected,
                            params.get("aggregate", True))
    if fire_idx is None:
        return None
    ctx["fired_results"] = ctx.get("results") or []
    if params.get("reset_on_fire"):
        ctx["count"] = 0
        ctx["results"] = []
    return fire_idx


@fire_run_condition("counter")
def _counter_run(ctx, events, params) -> Optional[List[int]]:
    """Whole-slice counter evaluation: every fire position in one call.

    Exactly the scalar fold collapsed: counts advance arithmetically, results
    aggregate in C-level comprehensions, and ``fired_results`` lands on the
    value the *last* fire's snapshot would have left behind."""
    if events[0].type == TYPE_FAILURE:
        # type-uniform slice: every event is a failure notification
        ctx["failures"] = ctx.get("failures", 0) + len(events)
        return []
    if params.get("exactly_once", False):
        return None  # redelivery dedup interleaves with counting
    cnt = ctx.get("count", 0)
    expected = int(ctx.get("expected", params.get("expected", 1)))
    n = len(events)
    aggregate = params.get("aggregate", True)
    first = max(0, expected - cnt - 1)
    if first >= n or not params.get("reset_on_fire"):
        # no reset involved: counts and results simply advance over the slice
        ctx["count"] = cnt + n
        if aggregate:
            results = ctx.get("results") or []
            results.extend(_result_of(e) for e in events)
            ctx["results"] = results
        if first >= n:  # the threshold is not reached inside this slice
            return []
        # once satisfied the scalar fn keeps returning True: the tail fires
        ctx["fired_results"] = ctx.get("results") or []
        return list(range(first, n))
    fires = list(range(first, n, max(1, expected)))
    last = fires[-1]
    ctx["count"] = n - last - 1  # events consumed since the last reset
    if aggregate:
        if len(fires) == 1:
            snapshot = ctx.get("results") or []
        else:
            snapshot = []
        snapshot = snapshot + [_result_of(e) for e in events[
            (fires[-2] + 1 if len(fires) > 1 else 0):last + 1]]
        ctx["fired_results"] = snapshot
        ctx["results"] = [_result_of(e) for e in events[last + 1:]]
    else:
        # the last fire snapshots pre-reset results: the pre-run value for a
        # single fire, [] (reset by the previous fire) for multiple
        ctx["fired_results"] = (ctx.get("results") or []) if len(fires) == 1 else []
        ctx["results"] = []
    return fires


@condition("threshold_join")
def _threshold_join(ctx, event, params) -> bool:
    """Federated-learning style aggregation (§5.4): fire when ``fraction`` of
    the expected events arrived, or immediately on a timeout event — so
    stragglers and failed clients cannot hang the workflow."""
    if event.type == TYPE_TIMEOUT:
        ctx["timed_out"] = True
        return ctx.get("count", 0) >= int(params.get("min_events", 1))
    if event.type == TYPE_FAILURE:
        ctx["failures"] = ctx.get("failures", 0) + 1
        return False
    if _dedup(ctx, event, params):
        return False
    cnt = ctx.get("count", 0) + 1
    ctx["count"] = cnt
    results = ctx.get("results") or []
    results.append(_result_of(event))
    ctx["results"] = results
    expected = int(ctx.get("expected", params.get("expected", 1)))
    frac = float(params.get("fraction", 1.0))
    return cnt >= max(1, math.ceil(expected * frac))


@batched_condition("threshold_join")
def _threshold_join_batch(ctx, events, params) -> Optional[int]:
    et = events[0].type
    if et == TYPE_FAILURE:
        ctx["failures"] = ctx.get("failures", 0) + len(events)
        return None
    if et == TYPE_TIMEOUT or params.get("exactly_once", False):
        return scalar_sweep(_threshold_join, ctx, events, params)
    expected = int(ctx.get("expected", params.get("expected", 1)))
    frac = float(params.get("fraction", 1.0))
    threshold = max(1, math.ceil(expected * frac))
    return _count_slice(ctx, events, ctx.get("count", 0), threshold, True)


@fire_run_condition("threshold_join")
def _threshold_join_run(ctx, events, params) -> Optional[List[int]]:
    et = events[0].type
    if et == TYPE_FAILURE:
        ctx["failures"] = ctx.get("failures", 0) + len(events)
        return []
    if et == TYPE_TIMEOUT or params.get("exactly_once", False):
        return None
    cnt = ctx.get("count", 0)
    expected = int(ctx.get("expected", params.get("expected", 1)))
    threshold = max(1, math.ceil(expected * float(params.get("fraction", 1.0))))
    n = len(events)
    ctx["count"] = cnt + n
    results = ctx.get("results") or []
    results.extend(_result_of(e) for e in events)
    ctx["results"] = results
    first = max(0, threshold - cnt - 1)
    # the scalar fn keeps returning True once satisfied: the tail fires
    return list(range(first, n)) if first < n else []


_OPS = {
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "is_present": lambda a, b: a is not None,
    "str_eq": lambda a, b: str(a) == str(b),
    "bool_eq": lambda a, b: bool(a) == bool(b),
}


def _extract(data: Any, var: str) -> Any:
    """ASL-ish '$.a.b' JSON-path extraction."""
    cur = data
    for part in var.lstrip("$.").split("."):
        if not part:
            continue
        if isinstance(cur, dict):
            cur = cur.get(part)
        else:
            return None
    return cur


@condition("rules")
def _rules(ctx, event, params) -> bool:
    """ASF Choice-state rules (§5.2): first matching rule decides the next
    state, recorded in ``ctx['matched_next']`` for the action to read."""
    data = event.data if isinstance(event.data, dict) else {"result": event.data}
    for rule in params.get("rules", []):
        val = _extract(data, rule["var"])
        try:
            ok = _OPS[rule["op"]](val, rule.get("value"))
        except TypeError:
            ok = False
        if ok:
            ctx["matched_next"] = rule["next"]
            return True
    if params.get("default"):
        ctx["matched_next"] = params["default"]
        return True
    return False


@condition("event_type")
def _event_type(ctx, event, params) -> bool:
    return event.type == params.get("type", "")


@condition("python")
def _python(ctx, event, params) -> bool:
    """Escape hatch for programmable conditions: a restricted expression over
    ``event`` / ``context`` (extensibility demo; used in tests)."""
    expr = params.get("expr", "True")
    return bool(
        eval(  # noqa: S307 - deliberate, restricted namespace
            expr,
            {"__builtins__": {"len": len, "min": min, "max": max, "sum": sum}},
            {"event": event, "context": ctx, "data": event.data},
        )
    )
