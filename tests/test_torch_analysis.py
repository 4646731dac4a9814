"""The port's copy of the tfcheck analysis plane (``repro_torch.analysis``),
held to ``tests/test_analysis.py``'s cases, and its own entry point
``python -m repro_torch.analysis.cli``.

Static half: every rule fires on its bad fixture (``tests/analysis_fixtures``,
shared with the reference's tests) and stays silent on its good twin; the
pragma fixture scans clean; the baseline ratchet forgives exactly the
baselined count; the CLI gates the port's core, bus and chaos against the
committed baseline (which it never writes) and fails on a seeded
violation.  Dynamic half: the port's lock tracer records acquisition order
across real threads, flags AB/BA inversions and sleep-under-lock, installs
nothing when the env flag is unset, and, in a fresh interpreter (it patches
``threading.Lock`` process-wide), traces a Table-1 join and a 2-shard
drain of the port's runtime on the CPU: an acyclic graph and no sleep
under a bus lock.
"""
import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from repro_torch.analysis import (ALL_RULES, load_baseline, load_paths, ratchet,
                                  rules_by_id, run_rules, write_baseline)
from repro_torch.analysis import locktrace
from repro_torch.analysis.lockrules import build_lock_graph, find_cycle

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "analysis_fixtures")
REPO = os.path.dirname(HERE)
SRC = os.path.join(REPO, "src")

RULE_FIXTURES = {
    "lock-discipline": "lock_discipline",
    "lock-order": "lock_order",
    "durability-ordering": "durability",
    "fencing": "fencing",
    "obs-discipline": "obs_discipline",
    "seam-safety": "seam_safety",
}


def _scan(rule_id, basename):
    files = load_paths([os.path.join(FIXTURES, basename + ".py")], root=REPO)
    return rules_by_id()[rule_id].check(files)


# -- static rules over the fixture corpus ----------------------------------------

@pytest.mark.parametrize("rule_id", sorted(RULE_FIXTURES))
def test_rule_fires_on_bad_fixture(rule_id):
    findings = _scan(rule_id, RULE_FIXTURES[rule_id] + "_bad")
    assert findings, "%s found nothing in its bad fixture" % rule_id
    assert all(f.rule == rule_id for f in findings)


@pytest.mark.parametrize("rule_id", sorted(RULE_FIXTURES))
def test_rule_silent_on_good_fixture(rule_id):
    findings = _scan(rule_id, RULE_FIXTURES[rule_id] + "_good")
    assert findings == [], "%s false-positives on its good fixture: %s" % (
        rule_id, [f.render() for f in findings])


def test_bad_fixture_finding_counts():
    assert len(_scan("lock-discipline", "lock_discipline_bad")) == 5
    assert len(_scan("durability-ordering", "durability_bad")) == 4
    assert len(_scan("fencing", "fencing_bad")) == 2
    assert len(_scan("obs-discipline", "obs_discipline_bad")) == 2
    assert len(_scan("seam-safety", "seam_safety_bad")) == 2
    assert len(_scan("lock-order", "lock_order_bad")) == 1


def test_catalogue_matches_the_reference():
    """The copy carries the reference's rules, in its order."""
    from repro.analysis import ALL_RULES as REF_RULES

    assert [(r.id, r.invariant) for r in ALL_RULES] == \
        [(r.id, r.invariant) for r in REF_RULES]


def test_pragma_blesses_findings():
    files = load_paths([os.path.join(FIXTURES, "pragma_keep.py")], root=REPO)
    assert run_rules(files) == []


def test_pragma_is_rule_scoped():
    src = open(os.path.join(FIXTURES, "pragma_keep.py"), encoding="utf-8").read()
    mangled = src.replace("allow[seam-safety]", "allow[lock-discipline]")
    from repro_torch.analysis.core import SourceFile
    sf = SourceFile("pragma_keep.py", "pragma_keep.py", mangled)
    assert [f.rule for f in run_rules([sf])] == ["seam-safety"]


def test_lock_order_cycle_reports_both_edges():
    files = load_paths([os.path.join(FIXTURES, "lock_order_bad.py")], root=REPO)
    (finding,) = rules_by_id()["lock-order"].check(files)
    assert "Pool._a_lock" in finding.message
    assert "Pool._b_lock" in finding.message


def test_lock_graph_is_dag_on_good_fixture():
    files = load_paths([os.path.join(FIXTURES, "lock_order_good.py")], root=REPO)
    adj, _ = build_lock_graph(files)
    assert find_cycle(adj) is None
    assert all(a not in bs for a, bs in adj.items())


# -- baseline / ratchet ----------------------------------------------------------

def test_ratchet_forgives_baselined_counts(tmp_path):
    files = load_paths([os.path.join(FIXTURES, "obs_discipline_bad.py")], root=REPO)
    findings = rules_by_id()["obs-discipline"].check(files)
    assert len(findings) == 2
    path = str(tmp_path / "baseline.json")
    write_baseline(findings, path)
    baseline = load_baseline(path)
    assert ratchet(findings, baseline) == []
    assert ratchet(findings + [findings[0]], baseline) == [findings[0]]
    assert ratchet(findings, {}) == findings


def test_baseline_roundtrip(tmp_path):
    files = load_paths([os.path.join(FIXTURES, "seam_safety_bad.py")], root=REPO)
    findings = run_rules(files)
    path = str(tmp_path / "b.json")
    write_baseline(findings, path)
    data = json.loads(open(path, encoding="utf-8").read())
    assert data["version"] == 1
    assert sum(data["findings"].values()) == len(findings)
    assert load_baseline(str(tmp_path / "missing.json")) == {}


# -- the port's entry point --------------------------------------------------------

def _cli(*argv):
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis.cli", *argv],
                          cwd=REPO, env=dict(os.environ, PYTHONPATH=SRC),
                          capture_output=True, text=True, timeout=300)


def test_gate_clean_on_the_port():
    """The port's core, bus and chaos pass against the committed baseline."""
    proc = _cli()
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_gate_fails_on_seeded_violation(tmp_path):
    bad = open(os.path.join(FIXTURES, "obs_discipline_bad.py"), encoding="utf-8").read()
    seeded = tmp_path / "seeded"
    seeded.mkdir()
    (seeded / "seeded_violation.py").write_text(bad)
    proc = _cli(str(seeded))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "obs-discipline" in proc.stdout


def test_cli_usage_errors_and_the_read_only_baseline(tmp_path):
    """A missing path exits 2; --write-baseline refuses the committed file
    (exit 2, the file unchanged) and writes to another path."""
    assert _cli(str(tmp_path / "missing")).returncode == 2
    committed = os.path.join(REPO, "tfcheck-baseline.json")
    before = open(committed, "rb").read()
    proc = _cli("--write-baseline")
    assert proc.returncode == 2 and "read-only" in proc.stderr
    assert open(committed, "rb").read() == before
    out = tmp_path / "b.json"
    proc = _cli("--write-baseline", "--baseline", str(out))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(out.read_text())["version"] == 1


def test_list_rules_covers_every_rule():
    proc = _cli("--list-rules")
    assert proc.returncode == 0
    for rule in ALL_RULES:
        assert rule.id in proc.stdout


# -- dynamic half: the lock tracer -----------------------------------------------

_session_traced = pytest.mark.skipif(
    bool(os.environ.get("TFCHECK_TRACE_LOCKS")),
    reason="session-wide tracer active; these tests own the tracer state")


@pytest.fixture
def traced():
    """Fresh tracer installation; never leaks patched factories."""
    locktrace.uninstall()
    locktrace.install()
    yield
    locktrace.uninstall()


@_session_traced
def test_locktrace_noop_when_env_unset(monkeypatch):
    monkeypatch.delenv("TFCHECK_TRACE_LOCKS", raising=False)
    assert not locktrace.enabled_by_env()
    locktrace.maybe_install()
    try:
        assert not locktrace.is_installed()
        assert threading.Lock is locktrace._real_Lock
    finally:
        locktrace.uninstall()


@_session_traced
def test_locktrace_records_edges(traced):
    a = threading.Lock()
    b = threading.Lock()
    with a:
        with b:
            pass
    rep = locktrace.report()
    assert rep["acquisitions"] >= 2
    assert len(rep["edges"]) == 1
    assert locktrace.find_cycle() is None
    locktrace.check()


@_session_traced
def test_locktrace_flags_inversion_across_threads(traced):
    a = threading.Lock()
    b = threading.Lock()

    def forward():
        with a:
            with b:
                pass

    def backward():
        with b:
            with a:
                pass

    for fn in (forward, backward):
        t = threading.Thread(target=fn)
        t.start()
        t.join()
    assert locktrace.find_cycle() is not None
    with pytest.raises(AssertionError, match="lock-order cycle"):
        locktrace.check()


@_session_traced
def test_locktrace_rlock_reentry_is_not_an_edge(traced):
    lk = threading.RLock()
    with lk:
        with lk:
            pass
    assert locktrace.report()["edges"] == {}
    locktrace.check()


@_session_traced
def test_locktrace_flags_sleep_under_lock(traced):
    lk = threading.Lock()
    with lk:
        time.sleep(0.001)
    assert locktrace.report()["sleep_violations"]
    with pytest.raises(AssertionError, match="sleep"):
        locktrace.check()


@_session_traced
def test_locktrace_sleep_outside_lock_ok(traced):
    lk = threading.Lock()
    with lk:
        pass
    time.sleep(0.001)
    locktrace.check()


_TRACED_RUN = textwrap.dedent("""
    import json
    from repro_torch.analysis import locktrace
    locktrace.install()          # before the runtime creates a lock

    from repro_torch import bus, core

    def triggers(n, each):
        return [core.make_trigger(f"j{t}", condition={"name": "counter",
                "expected": each, "aggregate": False}, action={"name": "noop"},
                trigger_id=f"jt{t}", transient=False) for t in range(n)]

    # the Table-1 join's shape through the facade's worker, on the CPU
    tf = core.Triggerflow(inline_functions=True, commit_policy="every_batch",
                          device="cpu")
    tf.create_workflow("join")
    for trg in triggers(20, 50):
        tf.add_trigger("join", trg)
    tf.event_store.publish_batch("join", [core.termination_event(f"j{i % 20}", i)
                                          for i in range(1000)])
    w = tf.worker("join")
    done = 0
    while done < 1000:
        done += w.run_once(256)
    fires = w.stats.fires
    tf.shutdown()

    # a drain over 2 shards of a partitioned store
    store = bus.PartitionedEventStore(4)
    tf = core.Triggerflow(event_store=store, inline_functions=True,
                          commit_policy="every_batch", device="cpu")
    tf.create_workflow("w")
    for trg in triggers(8, 25):
        tf.add_trigger("w", trg)
    store.publish_batch("w", [core.termination_event(f"j{i % 8}", i) for i in range(200)])
    tf.pool.set_shard_count("w", 2)
    tf.pool.drive("w", timeout=30)
    lag = tf.pool.metrics("w")["total_lag"]
    tf.shutdown()

    rep = locktrace.report()
    locktrace.check()            # raises on a cycle or a sleep under a bus lock
    print(json.dumps({"fires": fires, "lag": lag, "nodes": len(rep["nodes"]),
                      "edges": len(rep["edges"]), "acquisitions": rep["acquisitions"],
                      "cycle": locktrace.find_cycle(),
                      "sleep_violations": len(rep["sleep_violations"])}))
""")


def test_locktrace_over_the_port_runtime_in_a_fresh_interpreter():
    proc = subprocess.run([sys.executable, "-c", _TRACED_RUN], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["fires"] == 20 and out["lag"] == 0, out
    assert out["cycle"] is None and out["sleep_violations"] == 0, out
    assert out["acquisitions"] > 0 and out["edges"] > 0, out
