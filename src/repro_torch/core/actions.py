"""Action registry (paper §3.2: Actions are user-defined computations fired
when a Condition matches).

An action is ``fn(context, event, params) -> None``.  Like conditions, actions
are referenced by registry name + JSON params.  The generic ``pyfunc`` action
dispatches to runtime-registered callables — that is the extension point the
DAG / state-machine / workflow-as-code orchestrators build on.

Batched-action protocol (the worker's action plane)
---------------------------------------------------
An action may additionally register a *batched* implementation
``fn_batch(ctx, events, params) -> None`` via
``register_action(name, fn, batched=fn_batch)``.  The contract:

* ``events`` is the non-empty run of events that *fired* one trigger within
  one ``(subject, type)`` slice, in arrival order.
* The batched fn must be observably identical to folding the scalar fn over
  the run (``for e in events: fn(ctx, e, params)``); it exists purely to
  amortize the per-fire interpreter dispatch (one registry lookup, one
  context access pattern, one bulk ``produce``/publish instead of N).
* Batched implementations must not assume per-fire interleaving with the
  condition: when the worker takes the action plane, *all* condition
  evaluations of the run happen before the batched action runs.  Actions
  whose scalar form depends on that interleaving (``invoke`` result chains
  through external state, ``intercepted`` cancel flags, ``pyfunc`` user
  code) simply do not register a batched form and keep the exact scalar
  path — the worker falls back automatically.
* A batched fn should be *slice-isolating*: an error for one event must not
  silently swallow the rest of the run (prefer per-event try/except or
  building the whole output before any side effect).
* A batched fn must not disable its own trigger mid-run: by the time the
  worker can observe the disable, every fire's action has already run,
  whereas the per-fire oracle stops at the disabling fire.  An action that
  needs self-disable (or any per-fire trigger-state choreography) simply
  must not register a batched form — the worker then keeps the exact
  per-fire path, which re-checks ``enabled`` between fires.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from .events import CloudEvent, termination_event

ActionFn = Callable[[Any, CloudEvent, Dict[str, Any]], None]
BatchedActionFn = Callable[[Any, List[CloudEvent], Dict[str, Any]], None]

ACTIONS: Dict[str, ActionFn] = {}
#: Opt-in batched implementations, keyed like ``ACTIONS``.
BATCHED_ACTIONS: Dict[str, BatchedActionFn] = {}
# Runtime-registered python callables used by the ``pyfunc`` action.
PYFUNCS: Dict[str, Callable] = {}


def action(name: str, batched: Optional[BatchedActionFn] = None
           ) -> Callable[[ActionFn], ActionFn]:
    def deco(fn: ActionFn) -> ActionFn:
        register_action(name, fn, batched=batched)
        return fn

    return deco


def register_action(name: str, fn: ActionFn,
                    batched: Optional[BatchedActionFn] = None) -> None:
    """Third-party extension point.  ``batched`` opts the action into the
    worker's action plane; without it every fire runs the scalar fn."""
    ACTIONS[name] = fn
    if batched is not None:
        BATCHED_ACTIONS[name] = batched
    else:
        # re-registering without a batched impl must not leave a stale one
        BATCHED_ACTIONS.pop(name, None)


def batched_action(name: str) -> Callable[[BatchedActionFn], BatchedActionFn]:
    """Attach a batched implementation to an already-registered action."""
    def deco(fn: BatchedActionFn) -> BatchedActionFn:
        BATCHED_ACTIONS[name] = fn
        return fn

    return deco


def register_pyfunc(name: str, fn: Callable) -> None:
    PYFUNCS[name] = fn


def pyfunc(name: str) -> Callable[[Callable], Callable]:
    def deco(fn: Callable) -> Callable:
        PYFUNCS[name] = fn
        return fn

    return deco


@action("noop")
def _noop(ctx, event, params) -> None:
    return None


@batched_action("noop")
def _noop_batch(ctx, events, params) -> None:
    return None


@action("invoke")
def _invoke(ctx, event, params) -> None:
    """Asynchronously invoke a backend 'serverless function'.

    Input chaining (§5.2): if ``pass_result`` is set, the previous state's
    output (the activating event's result) becomes this function's input.
    """
    args = params.get("args")
    if params.get("pass_result") and isinstance(event.data, dict):
        args = event.data.get("result")
    ctx.invoke(params["fn"], args, params["subject"], delay=params.get("delay", 0.0))


@action("map_invoke")
def _map_invoke(ctx, event, params) -> None:
    """Fan out N invocations and *introspect* the downstream join trigger to
    set its expected aggregation count (§5.1: dynamic condition update —
    the map width may be unknown until execution)."""
    items = params.get("items")
    if items is None and isinstance(event.data, dict):
        items = event.data.get("result")
    items = list(items if items is not None else [])
    join_trigger = params.get("join_trigger")
    if join_trigger:
        ctx.get_trigger_context(join_trigger)["expected"] = len(items)
    for it in items:
        ctx.invoke(params["fn"], it, params["subject"], delay=params.get("delay", 0.0))


@action("produce")
def _produce(ctx, event, params) -> None:
    """Produce a termination event into the worker's internal sink (§5.2)."""
    result = params.get("result")
    if params.get("pass_result") and isinstance(event.data, dict):
        result = event.data.get("result")
    ctx.produce(termination_event(params["subject"], result=result))


@batched_action("produce")
def _produce_batch(ctx, events, params) -> None:
    """Build the whole run's termination events, then sink them in one bulk
    publish (one append per partition / one commit-log write, not one per
    event).  Building first keeps the run slice-isolating: a bad event fails
    before any side effect lands."""
    subject = params["subject"]
    default = params.get("result")
    if params.get("pass_result"):
        out = [termination_event(
            subject,
            e.data.get("result") if isinstance(e.data, dict) else default)
            for e in events]
    else:
        out = [termination_event(subject, default) for _ in events]
    ctx.produce_batch(out)


@action("workflow_end")
def _workflow_end(ctx, event, params) -> None:
    result = params.get("result")
    if params.get("pass_result") and isinstance(event.data, dict):
        result = event.data.get("result")
    status = params.get("status", "succeeded")
    ctx.workflow_result({"status": status, "result": result})


@batched_action("workflow_end")
def _workflow_end_batch(ctx, events, params) -> None:
    # Exact scalar fold: ``set_result`` runs per fire (last one wins), so a
    # re-fired end trigger observes identical store-write semantics.
    for e in events:
        _workflow_end(ctx, e, params)


@action("chain")
def _chain(ctx, event, params) -> None:
    for spec in params.get("actions", []):
        run_action(spec, ctx, event)


@batched_action("chain")
def _chain_batch(ctx, events, params) -> None:
    """A single-action chain batches its sub-action directly.  Multi-action
    chains keep the scalar per-event interleaving (a1(e1) a2(e1) a1(e2) …):
    reordering to a1(e1) a1(e2) a2(e1) … could flip same-subject sink order,
    which the ordering contract does guarantee."""
    specs = params.get("actions", [])
    if len(specs) == 1:
        run_action_batch(specs[0], ctx, events)
        return
    for e in events:
        for spec in specs:
            run_action(spec, ctx, e)


@action("intercepted")
def _intercepted(ctx, event, params) -> None:
    """Dynamic trigger interception (Def. 5): run the interceptor, then the
    original action unless the interceptor cancelled it via context."""
    run_action(params["interceptor"], ctx, event)
    if not ctx.get("cancel_inner", False):
        run_action(params["inner"], ctx, event)


@action("pyfunc")
def _pyfunc(ctx, event, params) -> None:
    PYFUNCS[params["func"]](ctx, event, params)


def run_action(spec: Dict[str, Any], ctx, event: CloudEvent) -> None:
    ACTIONS[spec["name"]](ctx, event, spec)


def run_action_batch(spec: Dict[str, Any], ctx, events: List[CloudEvent]) -> None:
    """Run a fire run through the batched impl, or fold the scalar fn."""
    bafn = BATCHED_ACTIONS.get(spec["name"])
    if bafn is not None:
        bafn(ctx, events, spec)
        return
    fn = ACTIONS[spec["name"]]
    for e in events:
        fn(ctx, e, spec)


def batchable_action(spec: Dict[str, Any]) -> bool:
    """True when the whole action tree has batched implementations — the
    worker's gate for the action plane.  A ``chain`` is only batchable when
    every sub-action is: a chain-wrapped scalar-only action (``pyfunc``,
    ``invoke``, ``intercepted``) must keep the exact per-fire path, where
    the worker re-checks trigger state between fires."""
    if spec["name"] not in BATCHED_ACTIONS:
        return False
    if spec["name"] == "chain":
        return all(batchable_action(s) for s in spec.get("actions", []))
    return True


def run_condition(spec: Dict[str, Any], ctx, event: CloudEvent) -> bool:
    return _CONDITIONS()[spec["name"]](ctx, event, spec)


_conditions_registry = None


def _CONDITIONS():
    # conditions.py imports nothing from here, but resolve lazily-once anyway
    # to keep import order flexible; the per-call import this replaces showed
    # up as ~5% of the worker hot loop.
    global _conditions_registry
    if _conditions_registry is None:
        from .conditions import CONDITIONS as reg

        _conditions_registry = reg
    return _conditions_registry
