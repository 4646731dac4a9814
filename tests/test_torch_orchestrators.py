"""The four §5 orchestrators of the port (``repro_torch.core``: ``dag``,
``statemachine``, ``workflow_as_code``, ``fedlearn``) against the
reference's.

The 14 cases of tests/test_orchestrators.py, each run on both packages over
the in-process facade (the port's on ``device="cpu"``): the results are
equal, and equal to what the reference's test expects.  These workflows keep
their event log, so their workers run no vector join.
"""
import time
from types import SimpleNamespace

import pytest

import repro.core as ref_core
import repro.core.dag as ref_dag
import repro.core.fedlearn as ref_fedlearn
import repro.core.statemachine as ref_statemachine
import repro.core.workflow_as_code as ref_wac
import repro_torch.core as port_core
import repro_torch.core.dag as port_dag
import repro_torch.core.fedlearn as port_fedlearn
import repro_torch.core.statemachine as port_statemachine
import repro_torch.core.workflow_as_code as port_wac

PKGS = {
    "port": SimpleNamespace(core=port_core, dag=port_dag, sm=port_statemachine,
                            wac=port_wac, fl=port_fedlearn, dev={"device": "cpu"}),
    "ref": SimpleNamespace(core=ref_core, dag=ref_dag, sm=ref_statemachine,
                           wac=ref_wac, fl=ref_fedlearn, dev={}),
}


def on_both(case):
    """Run ``case(p)`` on each package; the two results must be equal."""
    out = {name: case(p) for name, p in PKGS.items()}
    assert out["port"] == out["ref"]
    return out["port"]


def _tf(p):
    return p.core.Triggerflow(inline_functions=True, **p.dev)


def _outcome(res):
    return {k: res.get(k) for k in ("status", "result", "error")}


# ------------------------------------------------------------------- DAG ----
def test_dag_diamond():
    def case(p):
        tf = _tf(p)
        dag = p.dag.DAG("diamond")
        a = dag.add(p.dag.PythonOperator("a", lambda x: 1))
        b = dag.add(p.dag.PythonOperator("b", lambda x: x + 10))
        c = dag.add(p.dag.PythonOperator("c", lambda x: x + 100))
        d = dag.add(p.dag.PythonOperator("d", lambda xs: sorted(xs)))
        a >> [b, c]
        b >> d
        c >> d
        dag.deploy(tf, "diamond")
        return _outcome(dag.run(tf, "diamond", timeout=10))

    res = on_both(case)
    assert res["status"] == "succeeded" and res["result"] == [11, 101]


def test_dag_map_join_chain():
    def case(p):
        tf = _tf(p)
        dag = p.dag.DAG("mj")
        g = dag.add(p.dag.PythonOperator("g", lambda x: list(range(7))))
        m = dag.add(p.dag.MapOperator("m", lambda x: x + 1))
        r = dag.add(p.dag.PythonOperator("r", sum))
        g >> m >> r
        dag.deploy(tf, "mj")
        return _outcome(dag.run(tf, "mj", timeout=10))

    assert on_both(case)["result"] == 28


def test_dag_cycle_rejected():
    def case(p):
        dag = p.dag.DAG("cyc")
        a = dag.add(p.dag.PythonOperator("a", None))
        b = dag.add(p.dag.PythonOperator("b", None))
        a >> b
        b >> a
        with pytest.raises(ValueError) as info:
            dag.validate()
        return str(info.value)

    on_both(case)


def test_dag_failure_halts_workflow():
    def case(p):
        tf = _tf(p)
        dag = p.dag.DAG("fail")

        def boom(x):
            raise RuntimeError("boom")

        a = dag.add(p.dag.PythonOperator("a", boom))
        b = dag.add(p.dag.PythonOperator("b", lambda x: x))
        a >> b
        dag.deploy(tf, "fail")
        return _outcome(dag.run(tf, "fail", timeout=10))

    res = on_both(case)
    assert res["status"] == "failed" and "boom" in res["error"]


def test_dag_retry_then_succeed():
    def case(p):
        tf = _tf(p)
        attempts = {"n": 0}

        def flaky(x):
            attempts["n"] += 1
            if attempts["n"] == 1:
                raise RuntimeError("transient")
            return 42

        dag = p.dag.DAG("retry")
        dag.add(p.dag.PythonOperator("a", flaky, retries=1))
        dag.deploy(tf, "retry")
        return _outcome(dag.run(tf, "retry", timeout=10)), attempts["n"]

    res, attempts = on_both(case)
    assert res["status"] == "succeeded" and res["result"] == 42
    assert attempts == 2


# ------------------------------------------------------------- ASF / ASL ----
def _sm_run(p, definition, workflow, extra=None):
    tf = _tf(p)
    tf.backend.register("inc", lambda x: (x or 0) + 1)
    tf.backend.register("dbl", lambda x: (x or 0) * 2)
    for name, fn in (extra or {}).items():
        tf.backend.register(name, fn)
    sm = p.sm.StateMachine(definition)
    sm.deploy(tf, workflow)
    return _outcome(sm.run(tf, workflow, timeout=10))


def test_asl_sequence_pass_task():
    res = on_both(lambda p: _sm_run(p, {
        "StartAt": "P",
        "States": {
            "P": {"Type": "Pass", "Result": 5, "Next": "T"},
            "T": {"Type": "Task", "Resource": "dbl", "End": True},
        }}, "sm1"))
    assert res["result"] == 10


def test_asl_choice_loop():
    res = on_both(lambda p: _sm_run(p, {
        "StartAt": "Init",
        "States": {
            "Init": {"Type": "Pass", "Result": 0, "Next": "Inc"},
            "Inc": {"Type": "Task", "Resource": "inc", "Next": "Gate"},
            "Gate": {"Type": "Choice",
                     "Choices": [{"Variable": "$.result", "Op": "lt", "Value": 4,
                                  "Next": "Inc"}],
                     "Default": "Done"},
            "Done": {"Type": "Succeed"},
        }}, "sm2"))
    assert res["result"] == 4


def test_asl_parallel_and_nested_map():
    def case(p):
        res = _sm_run(p, {
            "StartAt": "Par",
            "States": {
                "Par": {"Type": "Parallel", "Next": "Map",
                        "Branches": [
                            {"StartAt": "X", "States": {
                                "X": {"Type": "Pass", "Result": [1, 2], "End": True}}},
                            {"StartAt": "Y", "States": {
                                "Y": {"Type": "Pass", "Result": [3], "End": True}}},
                        ]},
                "Map": {"Type": "Pass", "Next": "Flat"},
                "Flat": {"Type": "Task", "Resource": "flatten", "Next": "M2"},
                "M2": {"Type": "Map", "Next": "Done", "Iterator": {
                    "StartAt": "D", "States": {
                        "D": {"Type": "Task", "Resource": "dbl", "End": True}}}},
                "Done": {"Type": "Succeed"},
            }}, "sm3", {"flatten": lambda xs: [v for sub in xs for v in sub]})
        # the map's branches finish in thread order: compare as a set
        return dict(res, result=sorted(res["result"]))

    res = on_both(case)
    assert res["status"] == "succeeded" and res["result"] == [2, 4, 6]


def test_asl_map_empty_iterable():
    res = on_both(lambda p: _sm_run(p, {
        "StartAt": "P",
        "States": {
            "P": {"Type": "Pass", "Result": [], "Next": "M"},
            "M": {"Type": "Map", "Next": "Done", "Iterator": {
                "StartAt": "D", "States": {
                    "D": {"Type": "Task", "Resource": "dbl", "End": True}}}},
            "Done": {"Type": "Succeed"},
        }}, "sm4"))
    assert res["result"] == []


def test_asl_fail_state():
    res = on_both(lambda p: _sm_run(p, {
        "StartAt": "F",
        "States": {"F": {"Type": "Fail", "Error": "Custom.Err"}}}, "sm5"))
    assert res["status"] == "failed" and res["error"] == "Custom.Err"


def test_asl_wait_state():
    def case(p):
        t0 = time.perf_counter()
        res = _sm_run(p, {
            "StartAt": "W",
            "States": {
                "W": {"Type": "Wait", "Seconds": 0.2, "Next": "T"},
                "T": {"Type": "Task", "Resource": "inc", "End": True},
            }}, "sm6")
        return res, time.perf_counter() - t0 >= 0.2

    res, waited = on_both(case)
    assert res["status"] == "succeeded" and waited


# --------------------------------------------------------- workflow as code ----
@pytest.mark.parametrize("scheduler", ["native", "external"])
def test_wac_suspend_replay(scheduler):
    def case(p):
        tf = _tf(p)
        tf.backend.register("add", lambda x: x + 1)
        tf.backend.register("sq", lambda x: x * x)

        def orch(ex):
            a = ex.call_async("add", 1).result()
            parts = ex.map("sq", [a, a + 1]).result()
            return sum(parts)

        wac = p.wac.WorkflowAsCode(tf, f"wac-{scheduler}", orch, scheduler=scheduler)
        wac.deploy()
        return _outcome(wac.run(timeout=10)), wac.replays

    res, replays = on_both(case)
    assert res["result"] == 4 + 9
    assert replays == 3  # initial + 2 wakes


def test_wac_invocations_not_duplicated_across_replays():
    def case(p):
        tf = _tf(p)
        calls = {"n": 0}

        def counted(x):
            calls["n"] += 1
            return x

        tf.backend.register("counted", counted)

        def orch(ex):
            a = ex.call_async("counted", 1).result()
            b = ex.call_async("counted", 2).result()
            return a + b

        wac = p.wac.WorkflowAsCode(tf, "wac-dup", orch)
        wac.deploy()
        return _outcome(wac.run(timeout=10)), calls["n"]

    res, calls = on_both(case)
    assert res["result"] == 3
    assert calls == 2  # event sourcing: no re-invocation on replay


# ---------------------------------------------------------------- fedlearn ----
def test_fedlearn_threshold_and_timeout():
    def case(p):
        tf = p.core.Triggerflow(**p.dev)  # threaded: clients run concurrently
        store = p.fl.ObjectStore()

        def client(args):
            if args["round"] == 1 and args["client"] < 3:
                raise RuntimeError("down")
            w = store.get(args["model"])
            k = store.put(f"d/{args['round']}/{args['client']}", w + 1.0)
            return {"round": args["round"], "result": k}

        def agg(keys, st):
            vals = [st.get(k) for k in keys]
            return sum(vals) / len(vals)

        fl = p.fl.FederatedLearningOrchestrator(
            tf, "fl-test", client, agg, n_clients=6, rounds=2, threshold=0.5,
            round_timeout=2.0, object_store=store)
        fl.deploy()
        try:
            out = fl.start(init_model=0.0, timeout=30)
        finally:
            tf.shutdown()
        return out["status"], store.get(out["result"]["model"])

    status, model = on_both(case)
    assert status == "succeeded" and model == 2.0
