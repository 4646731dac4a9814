"""§5.1 — Directed Acyclic Graph orchestration on top of triggers.

Airflow-style *Operator* abstraction.  Deployment registers one trigger per
vertex, activated by the termination events of its *upstream relatives*, with
a counter condition joining them.  Map operators dynamically set the expected
join count on their downstream triggers via context introspection.  Failure
events route to per-task error triggers which halt the workflow (and can
resume it by re-producing the missed event, §5.1 error handling).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from .actions import register_pyfunc
from .events import TYPE_FAILURE
from .service import Triggerflow
from .triggers import Trigger, make_trigger


class Operator:
    """Base operator: a named task with dependencies."""

    kind = "call_async"

    def __init__(self, task_id: str, fn: Optional[Callable] = None, args: Any = None,
                 retries: int = 0):
        self.task_id = task_id
        self.fn = fn
        self.args = args
        self.retries = retries
        self.upstream: List["Operator"] = []
        self.downstream: List["Operator"] = []

    def __rshift__(self, other):  # a >> b
        if isinstance(other, (list, tuple)):
            for o in other:
                self.__rshift__(o)
            return other
        self.downstream.append(other)
        other.upstream.append(self)
        return other

    def __lshift__(self, other):  # a << b
        if isinstance(other, (list, tuple)):
            for o in other:
                self.__lshift__(o)
            return other
        other.__rshift__(self)
        return other

    # subjects
    @property
    def done(self) -> str:
        return f"{self.task_id}.done"


class PythonOperator(Operator):
    kind = "call_async"


class MapOperator(Operator):
    """Fan out ``fn`` over an iterable (static ``items`` or the upstream
    result).  Downstream joins aggregate len(items) events."""

    kind = "map"

    def __init__(self, task_id: str, fn: Callable, items: Any = None, **kw):
        super().__init__(task_id, fn, **kw)
        self.items = items


class DAG:
    def __init__(self, dag_id: str):
        self.dag_id = dag_id
        self.tasks: Dict[str, Operator] = {}

    def add(self, op: Operator) -> Operator:
        if op.task_id in self.tasks:
            raise ValueError(f"duplicate task {op.task_id}")
        self.tasks[op.task_id] = op
        return op

    def roots(self) -> List[Operator]:
        return [t for t in self.tasks.values() if not t.upstream]

    def leaves(self) -> List[Operator]:
        return [t for t in self.tasks.values() if not t.downstream]

    def validate(self) -> None:
        """Reject cycles (a DAG must be acyclic)."""
        state: Dict[str, int] = {}

        def visit(op: Operator) -> None:
            if state.get(op.task_id) == 1:
                raise ValueError(f"cycle through {op.task_id}")
            if state.get(op.task_id) == 2:
                return
            state[op.task_id] = 1
            for d in op.downstream:
                visit(d)
            state[op.task_id] = 2

        for r in self.roots():
            visit(r)
        if len(state) != len(self.tasks):
            raise ValueError("disconnected tasks never reachable from a root")

    # -- compile the DAG to a trigger set Δ (paper Def. 3) ----------------------
    def deploy(self, tf: Triggerflow, workflow: str, on_failure: str = "halt") -> None:
        self.validate()
        tf.create_workflow(workflow, {"kind": "dag", "dag_id": self.dag_id})
        triggers: List[Trigger] = []
        for op in self.tasks.values():
            tf.backend.register(f"{workflow}:{op.task_id}", op.fn or (lambda x: x))
            subjects = [u.done for u in op.upstream] or ["$init"]
            n_map = sum(1 for u in op.upstream if isinstance(u, MapOperator))
            n_static = len(op.upstream) - n_map
            # join-count is dynamic when any upstream is a Map: the map action
            # sets ctx['expected'] via introspection before fanning out (§5.1).
            expected = max(1, len(op.upstream)) if n_map == 0 else 10 ** 9
            action = self._action_for(tf, workflow, op)
            trg = make_trigger(
                subjects,
                condition={"name": "counter", "expected": expected, "aggregate": True},
                action=action,
                trigger_id=f"{workflow}/{op.task_id}",
                context={"retries_left": op.retries, "expected_static": n_static},
            )
            triggers.append(trg)
            # failure handling trigger (halts; resumable by re-producing event)
            trg_fail = make_trigger(
                [op.done],
                condition={"name": "event_type", "type": TYPE_FAILURE},
                action={"name": "pyfunc", "func": "dag.on_failure", "workflow": workflow,
                        "task": op.task_id, "policy": on_failure,
                        "fn": f"{workflow}:{op.task_id}"},
                trigger_id=f"{workflow}/{op.task_id}/onfail",
                context={"retries_left": op.retries},
                transient=False,
                event_type=TYPE_FAILURE,
            )
            triggers.append(trg_fail)
        # workflow completion: join of all leaf tasks
        leaves = self.leaves()
        n_map_leaves = sum(1 for l in leaves if isinstance(l, MapOperator))
        triggers.append(
            make_trigger(
                [l.done for l in leaves],
                condition={"name": "counter",
                           "expected": len(leaves) if n_map_leaves == 0 else 10 ** 9},
                action={"name": "workflow_end", "pass_result": True},
                trigger_id=f"{workflow}/$end",
                context={"expected_static": len(leaves) - n_map_leaves},
            )
        )
        # Map leaves: their fan-out sets $end's expected dynamically.
        tf.add_trigger(workflow, triggers)

    def _action_for(self, tf: Triggerflow, workflow: str, op: Operator) -> Dict[str, Any]:
        downstream_joins = [f"{workflow}/{d.task_id}" for d in op.downstream]
        if not op.downstream:
            downstream_joins = [f"{workflow}/$end"]
        if isinstance(op, MapOperator):
            return {
                "name": "pyfunc", "func": "dag.map_exec",
                "fn": f"{workflow}:{op.task_id}",
                "items": op.items, "subject": op.done,
                "join_triggers": downstream_joins,
            }
        return {
            "name": "pyfunc", "func": "dag.call_async",
            "fn": f"{workflow}:{op.task_id}", "args": op.args,
            "subject": op.done, "n_upstream": len(op.upstream),
            "map_upstream": any(isinstance(u, MapOperator) for u in op.upstream),
        }

    def run(self, tf: Triggerflow, workflow: str, timeout: float = 60.0,
            data: Any = None) -> Any:
        tf.init_workflow(workflow, data=data)
        return tf.run_until_complete(workflow, timeout=timeout)


# -- pyfunc implementations ------------------------------------------------------
def _dag_call_async(ctx, event, params) -> None:
    args = params.get("args")
    if args is None:
        results = ctx.get("results") or []
        if params.get("n_upstream", 0) <= 1 and not params.get("map_upstream"):
            args = results[-1] if results else (
                event.data.get("result") if isinstance(event.data, dict) else event.data)
        else:
            args = list(results)  # joined upstreams (incl. map fan-in) pass all
    ctx.invoke(params["fn"], args, params["subject"])


def _dag_map_exec(ctx, event, params) -> None:
    items = params.get("items")
    if items is None:
        results = ctx.get("results") or []
        items = results[-1] if results else None
    items = list(items if items is not None else [])
    for join_id in params.get("join_triggers", []):
        jctx = ctx.get_trigger_context(join_id)
        # Accumulate: static upstream count + every map's dynamic width.
        base = jctx.get("expected", jctx.get("expected_static", 0))
        base = base if base < 10 ** 9 else jctx.get("expected_static", 0)
        jctx["expected"] = base + len(items)
    for it in items:
        ctx.invoke(params["fn"], it, params["subject"])


def _dag_on_failure(ctx, event, params) -> None:
    err = (event.data or {}).get("error") if isinstance(event.data, dict) else str(event.data)
    retries = ctx.get("retries_left", 0)
    if retries > 0:
        ctx["retries_left"] = retries - 1
        ctx.invoke(params["fn"], None, event.subject)
        return
    if params.get("policy") == "halt":
        ctx["halted_error"] = err
        ctx.workflow_result({"status": "failed", "error": err, "task": params.get("task")})


register_pyfunc("dag.call_async", _dag_call_async)
register_pyfunc("dag.map_exec", _dag_map_exec)
register_pyfunc("dag.on_failure", _dag_on_failure)
