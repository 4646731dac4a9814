"""§5.2 — Amazon States Language (ASL) state machines on top of triggers.

Supported state types: Task, Pass, Choice, Parallel, Map, Wait, Succeed, Fail.
Every state transition becomes a trigger (paper Def. 3).  Parallel/Map states
run *sub-state machines* identified by a unique scope tag; sub-machine
termination is itself an event (substitution principle, Def. 4), so state
machines nest seamlessly.  Map sub-machines are deployed **dynamically** at
execution time because the iterator width is unknown until then (§5.2), via
dynamic trigger creation through the Context; the map join's expected count is
set by introspection.  State outputs chain to the next state's input through
the termination events.  Choice rules live in the trigger *condition*.

ASL loops (Choice back-edges) are supported: triggers are persistent and join
counters reset on fire.

Subjects:   ``enter|<scope>|<state>``  state activation (carries the input)
            ``done|<scope>|<state>``   state termination (carries the output)
            ``end|<scope>``            sub-state-machine termination
            ``mapend|<scope>|<state>`` per-item terminations of a Map state
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional

from .actions import register_pyfunc
from .events import termination_event
from .service import Triggerflow
from .triggers import Trigger, make_trigger

# Deployed machine registry: pyfunc actions resolve definitions at runtime.
_MACHINES: Dict[str, "StateMachine"] = {}
# Wait states / timeouts need the service's timer source, keyed by workflow.
_TIMERS: Dict[str, Any] = {}
_scope_counter = itertools.count()


def _result_of(event) -> Any:
    if isinstance(event.data, dict) and "result" in event.data:
        return event.data["result"]
    return event.data


class StateMachine:
    def __init__(self, definition: Dict[str, Any], sm_id: Optional[str] = None):
        self.definition = definition
        self.sm_id = sm_id or f"sm-{next(_scope_counter):x}"
        _MACHINES[self.sm_id] = self

    # -- deployment --------------------------------------------------------------
    def deploy(self, tf: Triggerflow, workflow: str) -> None:
        tf.create_workflow(workflow, {"kind": "statemachine", "sm_id": self.sm_id})
        _TIMERS[workflow] = tf.timers
        triggers = self._compile(workflow, self.definition, scope="root")
        triggers.append(make_trigger(
            "$init",
            action={"name": "pyfunc", "func": "asl.enter_start", "sm": self.sm_id,
                    "workflow": workflow, "scope": "root",
                    "start_at": self.definition["StartAt"]},
            trigger_id=f"{workflow}/root/$init", transient=False))
        triggers.append(make_trigger(
            "end|root",
            action={"name": "workflow_end", "pass_result": True},
            trigger_id=f"{workflow}/root/$done", transient=False))
        tf.add_trigger(workflow, triggers)

    def _compile(self, workflow: str, definition: Dict[str, Any],
                 scope: str) -> List[Trigger]:
        triggers: List[Trigger] = []
        for name, state in definition["States"].items():
            triggers.extend(self._compile_state(workflow, name, state, scope))
        return triggers

    def _compile_state(self, workflow: str, name: str, state: Dict[str, Any],
                       scope: str) -> List[Trigger]:
        stype = state["Type"]
        triggers: List[Trigger] = []
        enter_subject = f"enter|{scope}|{name}"
        done_subject = f"done|{scope}|{name}"
        base = {"sm": self.sm_id, "workflow": workflow, "scope": scope, "state": name}

        if stype == "Choice":
            rules = [{"var": r.get("Variable", "$.result"), "op": r["Op"],
                      "value": r.get("Value"), "next": r["Next"]}
                     for r in state.get("Choices", [])]
            triggers.append(make_trigger(
                enter_subject,
                condition={"name": "rules", "rules": rules,
                           "default": state.get("Default")},
                action={"name": "pyfunc", "func": "asl.choice", **base},
                trigger_id=f"{workflow}/{scope}/{name}", transient=False))
            return triggers

        # the enter trigger executes the state
        triggers.append(make_trigger(
            enter_subject,
            action={"name": "pyfunc", "func": "asl.exec_state", **base},
            trigger_id=f"{workflow}/{scope}/{name}", transient=False))

        needs_done_router = stype in ("Task", "Wait", "Parallel", "Map")
        if stype == "Parallel":
            branches = state["Branches"]
            for i, br in enumerate(branches):
                triggers.extend(self._compile(workflow, br, f"{scope}/{name}[{i}]"))
            triggers.append(make_trigger(
                [f"end|{scope}/{name}[{i}]" for i in range(len(branches))],
                condition={"name": "counter", "expected": len(branches),
                           "reset_on_fire": True},
                action={"name": "pyfunc", "func": "asl.join_done", **base},
                trigger_id=f"{workflow}/{scope}/{name}/join", transient=False))
        elif stype == "Map":
            # per-item sub-machines are deployed dynamically at exec time;
            # the join trigger is static, its expected count set by introspection
            triggers.append(make_trigger(
                f"mapend|{scope}|{name}",
                condition={"name": "counter", "expected": 10 ** 9,
                           "reset_on_fire": True},
                action={"name": "pyfunc", "func": "asl.join_done", **base},
                trigger_id=f"{workflow}/{scope}/{name}/join", transient=False))
        if needs_done_router:
            triggers.append(make_trigger(
                done_subject,
                action={"name": "pyfunc", "func": "asl.route_next", **base},
                trigger_id=f"{workflow}/{scope}/{name}/done", transient=False))
        if stype not in ("Task", "Wait", "Parallel", "Map", "Pass", "Succeed", "Fail"):
            raise ValueError(f"unsupported state type {stype}")
        return triggers

    def run(self, tf: Triggerflow, workflow: str, data: Any = None,
            timeout: float = 60.0) -> Any:
        tf.init_workflow(workflow, data=data)
        return tf.run_until_complete(workflow, timeout=timeout)


# -- runtime pyfuncs ---------------------------------------------------------------
def _state_def(params) -> Dict[str, Any]:
    """Walk the definition along the scope path root/S[i]/T[j]… ('#k' execution
    counters in Map scopes are ignored for definition lookup)."""
    node: Any = _MACHINES[params["sm"]].definition
    scope = params["scope"]
    if scope != "root":
        for part in scope.split("/")[1:]:
            sname = part.split("[")[0].split("#")[0]
            idx = int(part.split("[")[1][:-1])
            st = node["States"][sname]
            node = st["Branches"][idx] if st["Type"] == "Parallel" else st["Iterator"]
    return node["States"][params["state"]]


def _enter_start(ctx, event, params) -> None:
    data = _result_of(event) if isinstance(event.data, dict) else event.data
    ctx.produce(termination_event(
        f"enter|{params['scope']}|{params['start_at']}", result=data))


def _route(ctx, params, state: Dict[str, Any], result: Any) -> None:
    if state.get("End") or "Next" not in state:
        ctx.produce(termination_event(f"end|{params['scope']}", result=result))
    else:
        ctx.produce(termination_event(
            f"enter|{params['scope']}|{state['Next']}", result=result))


def _exec_state(ctx, event, params) -> None:
    state = _state_def(params)
    stype = state["Type"]
    inp = _result_of(event)
    scope, name, wf = params["scope"], params["state"], params["workflow"]
    if stype == "Task":
        ctx.invoke(state["Resource"], inp, f"done|{scope}|{name}",
                   delay=state.get("SimulatedDelay", 0.0))
    elif stype == "Pass":
        _route(ctx, params, state, state.get("Result", inp))
    elif stype == "Wait":
        _TIMERS[wf].after(wf, float(state.get("Seconds", 0)),
                          termination_event(f"done|{scope}|{name}", result=inp))
    elif stype == "Parallel":
        for i, br in enumerate(state["Branches"]):
            ctx.produce(termination_event(
                f"enter|{scope}/{name}[{i}]|{br['StartAt']}", result=inp))
    elif stype == "Map":
        items = list(inp if inp is not None else [])
        exec_n = ctx.get("exec_n", 0)
        ctx["exec_n"] = exec_n + 1
        jctx = ctx.get_trigger_context(f"{wf}/{scope}/{name}/join")
        jctx["expected"] = len(items)  # dynamic width via introspection (§5.2)
        if not items:
            ctx.produce(termination_event(f"done|{scope}|{name}", result=[]))
            return
        sm = _MACHINES[params["sm"]]
        iterator = state["Iterator"]
        for i, item in enumerate(items):
            iscope = f"{scope}/{name}#{exec_n}[{i}]"
            for trg in sm._compile(wf, iterator, iscope):
                ctx.add_trigger(trg)
            # alias the item machine's end to the map join subject
            ctx.add_trigger(make_trigger(
                f"end|{iscope}",
                action={"name": "produce", "subject": f"mapend|{scope}|{name}",
                        "pass_result": True},
                trigger_id=f"{wf}/{iscope}/$alias"))
            ctx.produce(termination_event(
                f"enter|{iscope}|{iterator['StartAt']}", result=item))
    elif stype == "Succeed":
        ctx.produce(termination_event(f"end|{scope}", result=inp))
    elif stype == "Fail":
        ctx.workflow_result({"status": "failed", "error": state.get("Error", "Fail"),
                             "cause": state.get("Cause")})


def _route_next(ctx, event, params) -> None:
    from .events import TYPE_FAILURE

    state = _state_def(params)
    if event.type == TYPE_FAILURE:
        # ASL error handling: Catch → next state, else the execution fails
        err = (event.data or {}).get("error") if isinstance(event.data, dict) else None
        catch = state.get("Catch")
        if catch:
            ctx.produce(termination_event(
                f"enter|{params['scope']}|{catch[0]['Next']}",
                result={"error": err}))
            return
        ctx.workflow_result({"status": "failed", "error": err or "States.TaskFailed",
                             "state": params["state"]})
        return
    _route(ctx, params, state, _result_of(event))


def _join_done(ctx, event, params) -> None:
    results = list(ctx.get("fired_results") or [])
    ctx.produce(termination_event(
        f"done|{params['scope']}|{params['state']}", result=results))


def _choice(ctx, event, params) -> None:
    nxt = ctx.get("matched_next")
    if nxt is None:
        ctx.workflow_result({"status": "failed", "error": "States.NoChoiceMatched"})
        return
    ctx.produce(termination_event(
        f"enter|{params['scope']}|{nxt}", result=_result_of(event)))


register_pyfunc("asl.enter_start", _enter_start)
register_pyfunc("asl.exec_state", _exec_state)
register_pyfunc("asl.route_next", _route_next)
register_pyfunc("asl.join_done", _join_done)
register_pyfunc("asl.choice", _choice)


def register_timer_source(workflow: str, timers) -> None:
    _TIMERS[workflow] = timers
