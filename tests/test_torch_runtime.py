"""The port's copy of the Triggerflow runtime, against the JAX package's.

* The Table-1 join (benchmarks/load_test.py's ``bench_join`` shape, cut to
  20 triggers × 200 events) through the port's worker on the ``torch`` join
  backend and the reference's worker on ``numpy``: same fires, same
  contexts.
* The triage parity case of tests/test_batch_plane.py on the port.
* A join that fails in its backend raises out of ``run_once``; a screening
  error (a non-numeric ``expected``) still takes the exact path, as in the
  reference.
* ``Triggerflow(num_shards=2)`` and ``Triggerflow(num_partitions=4)`` drain
  a small join on the CPU.
* Guards for the copy: the port imports neither jax nor ``repro``; each
  copied module equals its reference source but for the hunks listed in
  ``EDITS``; tfcheck passes over the copy.
"""
import ast
import difflib
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.core import MemoryEventStore as RefMemoryEventStore
from repro.core import MemoryStateStore as RefMemoryStateStore
from repro.core import Triggerflow as RefTriggerflow
from repro.core import make_trigger as ref_make_trigger
from repro.core import termination_event as ref_termination_event
from repro.core.functions import FunctionBackend as RefFunctionBackend
from repro.core.worker import TFWorker as RefTFWorker
from repro_torch.core import (MemoryEventStore, MemoryStateStore, Triggerflow,
                              make_trigger, termination_event)
from repro_torch.core.functions import FunctionBackend
from repro_torch.core.worker import TFWorker

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src"


# ------------------------------------------------------------ Table-1 join ----
def _join_worker(tf_cls, worker_cls, make, term, vector_join, n_triggers,
                 events_each, **tf_kwargs):
    tf = tf_cls(inline_functions=True, commit_policy="every_batch", **tf_kwargs)
    tf.create_workflow("join")
    for t in range(n_triggers):
        tf.add_trigger("join", make(
            f"j{t}", condition={"name": "counter", "expected": events_each,
                                "aggregate": False},
            action={"name": "noop"}, trigger_id=f"jt{t}", transient=False))
    tf.event_store.publish_batch("join", [term(f"j{i % n_triggers}", i)
                                          for i in range(n_triggers * events_each)])
    w = worker_cls("join", tf.event_store, tf.state_store, tf.backend,
                   commit_policy="every_batch", vector_join=vector_join,
                   **({"device": tf.device} if tf_kwargs else {}))
    w.keep_event_log = False
    done = 0
    while done < n_triggers * events_each:
        done += w.run_once(512)
    return w


def test_table1_join_matches_reference():
    n, each = 20, 200
    port = _join_worker(Triggerflow, TFWorker, make_trigger, termination_event,
                        "torch", n, each, device="cpu")
    ref = _join_worker(RefTriggerflow, RefTFWorker, ref_make_trigger,
                       ref_termination_event, "numpy", n, each)
    assert port._vector_plane.backend == "torch"
    assert port._vector_plane.calls > 0
    assert port.stats.fires == ref.stats.fires == n
    assert port.stats.activations == ref.stats.activations == n * each
    for tid in ref.triggers:
        assert dict(port.context_of(tid)) == dict(ref.context_of(tid))


# ---------------------------------------------------------- triage parity ----
def _observables(w):
    return {
        "fires": w.stats.fires,
        "activations": w.stats.activations,
        "events": w.stats.events_processed,
        "dlq": w.stats.dlq_events,
        "contexts": {tid: dict(w.context_of(tid)) for tid in w.triggers},
        "enabled": {tid: t.enabled for tid, t in w.triggers.items()},
        "store_dlq": w.event_store.dlq_size("w"),
        "lag": w.event_store.lag("w"),
    }


def _triage_run(store_cls, state_cls, backend_cls, worker_cls, make, term,
                vector_join, **kw):
    es = store_cls()
    w = worker_cls("w", es, state_cls(), backend_cls(es, inline=True),
                   commit_policy="every_batch", vector_join=vector_join, **kw)
    w.keep_event_log = False  # the vector plane only runs without the event log
    for i in range(20):
        w.add_trigger(make(f"s{i}", condition={"name": "counter", "expected": 40,
                                               "aggregate": False},
                           action={"name": "noop"}, trigger_id=f"t{i}",
                           transient=False))
    w.event_store.publish_batch("w", [term(f"s{i % 20}", i) for i in range(20 * 40)])
    for _ in range(200):
        if w.run_once(256) == 0 and not w._sink:
            break
    return w


def test_vector_plane_torch_matches_disabled_plane_and_reference():
    port = [_triage_run(MemoryEventStore, MemoryStateStore, FunctionBackend,
                        TFWorker, make_trigger, termination_event, vj, device="cpu")
            for vj in ("off", "torch")]
    ref = _triage_run(RefMemoryEventStore, RefMemoryStateStore, RefFunctionBackend,
                      RefTFWorker, ref_make_trigger, ref_termination_event, "numpy")
    assert port[1]._vector_plane.calls > 0
    assert _observables(port[0]) == _observables(port[1]) == _observables(ref)


def test_device_argument_and_no_fallback(monkeypatch):
    tf = Triggerflow(device="cpu")
    assert tf.device == torch.device("cpu")
    assert tf.worker("wf")._vector_plane.backend == "torch"  # auto on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Triggerflow(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):  # auto on a CUDA device
        TFWorker("w", MemoryEventStore(), MemoryStateStore(),
                 FunctionBackend(MemoryEventStore(), inline=True), device="cuda",
                 vector_join="auto")
    # the sharded bus: both ways of asking for it drain a small join
    for kw, shards in (({"num_shards": 2}, 2), ({"num_partitions": 4}, 1)):
        tf = Triggerflow(device="cpu", inline_functions=True,
                         commit_policy="every_batch", **kw)
        assert tf.pool.device == torch.device("cpu")
        tf.create_workflow("w")
        tf.pool.set_shard_count("w", shards)
        for t in range(4):
            tf.add_trigger("w", make_trigger(
                f"j{t}", condition={"name": "counter", "expected": 20,
                                    "aggregate": False},
                action={"name": "noop"}, trigger_id=f"jt{t}", transient=False))
        tf.event_store.publish_batch("w", [termination_event(f"j{i % 4}", i)
                                           for i in range(80)])
        tf.pool.drive("w", timeout=20)
        assert tf.pool.total_fires("w") == 4
        assert tf.event_store.lag("w") == 0
        assert tf.worker("w").device == torch.device("cpu")
        tf.shutdown()


# ------------------------------------------- a join-backend failure raises ----
def _join_triggers(w, make, poison=False):
    for i in range(3):
        w.add_trigger(make(f"s{i}", condition={"name": "counter", "expected": 50,
                                               "aggregate": False},
                           action={"name": "noop"}, trigger_id=f"t{i}", transient=False))
    if poison:  # introspection writing a non-numeric expected
        w.context_of("t0")["expected"] = "not-a-number"


def test_join_backend_failure_raises_out_of_run_once(monkeypatch):
    """A join that fails in its backend fails the batch: ``run_once``
    raises, and the Python path does not take the batch over (no count
    moves, nothing commits)."""
    from repro_torch.kernels.event_join import ops
    from repro_torch.kernels.event_join.dispatch import JoinBackendError

    es = MemoryEventStore()
    w = TFWorker("w", es, MemoryStateStore(), FunctionBackend(es, inline=True),
                 commit_policy="every_batch", vector_join="torch", device="cpu")
    w.keep_event_log = False
    _join_triggers(w, make_trigger)
    es.publish_batch("w", [termination_event(f"s{i % 3}", i) for i in range(9)])

    def broken(*args):
        raise RuntimeError("injected join failure")

    monkeypatch.setattr(ops, "event_join", broken)
    with pytest.raises(JoinBackendError) as info:
        w.run_once(256)
    assert isinstance(info.value.__cause__, RuntimeError)
    assert w._vector_plane.calls == 0
    assert w.stats.activations == w.stats.fires == 0
    assert all(w.context_of(f"t{i}").get("count", 0) == 0 for i in range(3))
    assert es.lag("w") == 9


def test_screening_error_still_takes_the_exact_path():
    """The fallback the reference keeps, for what its comment names: a
    non-numeric ctx["expected"] raises in screening, before any context is
    mutated, and the exact path takes the batch; the port gives the
    reference's observables."""
    obs = []
    for store_cls, state_cls, backend_cls, worker_cls, make, term, vj, kw in (
            (MemoryEventStore, MemoryStateStore, FunctionBackend, TFWorker,
             make_trigger, termination_event, "torch", {"device": "cpu"}),
            (RefMemoryEventStore, RefMemoryStateStore, RefFunctionBackend,
             RefTFWorker, ref_make_trigger, ref_termination_event, "numpy", {})):
        es = store_cls()
        w = worker_cls("w", es, state_cls(), backend_cls(es, inline=True),
                       commit_policy="every_batch", vector_join=vj, **kw)
        w.keep_event_log = False
        _join_triggers(w, make, poison=True)
        es.publish_batch("w", [term(f"s{i % 3}", i) for i in range(9)])
        for _ in range(50):
            if w.run_once(256) == 0 and not w._sink:
                break
        obs.append(_observables(w))
    assert obs[0] == obs[1]
    assert obs[0]["lag"] == 0
    assert obs[0]["contexts"]["t1"]["count"] == 3


@pytest.mark.parametrize("vector_join", [None, "auto", "cuda", "cuda:1"])
def test_cuda_join_binds_the_worker_device(monkeypatch, vector_join):
    """A worker on ``cuda:1`` runs its join on cuda:1, not on the current
    device: ``auto`` and bare ``cuda`` both take the worker's device, and
    the backend holds that device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    if vector_join is None:  # the facade's worker
        w = Triggerflow(device="cuda:1").worker("wf")
    else:
        es = MemoryEventStore()
        w = TFWorker("w", es, MemoryStateStore(), FunctionBackend(es, inline=True),
                     device="cuda:1", vector_join=vector_join)
    assert w.device == torch.device("cuda", 1)
    assert w._vector_plane.backend == "cuda:1"
    assert w._vector_plane._join.device == torch.device("cuda", 1)


def test_bare_cuda_worker_fixes_its_card_once(monkeypatch):
    """``device="cuda"`` names the current card when the worker is built;
    a later change of the current device moves neither worker nor join."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    tf = Triggerflow(device="cuda")
    w = tf.worker("wf")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert tf.device == w.device == w._vector_plane._join.device == torch.device("cuda", 1)
    assert w._vector_plane.backend == "cuda:1"


# ----------------------------------------------------------- import guards ----
_HOOK = r"""
import importlib, pkgutil, sys

def refused(name):
    root = name.split(".")[0]
    return root in ("repro", "jaxlib") or root == "jax" or root.startswith("jax")

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if refused(name):
            raise ImportError("refused import of " + name)
        return None

sys.meta_path.insert(0, Refuse())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if refused(m))
assert not bad, bad
print(len(names))
"""


def test_port_imports_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _HOOK], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 65


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_repro_import_in_port_sources():
    files = sorted((SRC / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = [(str(f.relative_to(REPO)), mod) for f in files for mod in _imports(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad


# ------------------------------------------------------------- drift guard ----
# Every copied module equals the reference's source once ``repro.`` reads
# ``repro_torch.`` in its import lines, except for these hunks:
# module -> [(reason, removed lines, added lines)], lines stripped.
EDITS = {
    "core/worker.py": [
        ("device argument", [], ["from .device import resolve_device"]),
        ("a join-backend failure raises", [], [
            "from ..kernels.event_join.dispatch import JoinBackendError"]),
        ("device argument", [], ['device="cuda",']),
        ("device argument", [], ["self.device = resolve_device(device)"]),
        ("auto and bare cuda follow the worker's device", [], [
            "# auto (resolved here alone) and bare cuda follow the worker's",
            "# device: the CUDA kernel on its own card, the plain torch",
            "# version on the CPU",
            'if mode == "auto" or (mode == "cuda" and self.device.type == "cuda"):',
            'mode = str(self.device) if self.device.type == "cuda" else "torch"']),
        ("join setup raises instead of falling back", [
            "try:", "from .batch import VectorJoinPlane"], [
            "# no fallback: a backend that cannot be built raises here",
            "from .batch import VectorJoinPlane"]),
        ("join setup raises instead of falling back", [
            "self._vector_plane = VectorJoinPlane(backend=mode)",
            "except Exception:  # noqa: BLE001",
            'if mode != "auto":',
            "# an explicitly requested backend must fail loudly",
            "raise",
            "self._vector_plane = None  # auto: numpy missing, plane off"], [
            "self._vector_plane = VectorJoinPlane(backend=mode)"]),
        ("a join-backend failure raises", [], [
            "except JoinBackendError:",
            "# the join itself failed: the batch fails with it, and",
            "# no other path takes it over",
            "raise"]),
    ],
    "core/service.py": [
        ("device argument", [], ["from .device import resolve_device"]),
        ("device argument", [], ['device: str = "cuda",']),
        ("device argument", [], [
            "# The device the workload runs on (the counterpart of JAX's implicit",
            "# placement): the worker's join backend and the serving engine take",
            "# it from here.  A CUDA device without CUDA raises; nothing falls back.",
            "self.device = resolve_device(device)"]),
        ("device argument: the threaded pool's shards", [], ["device=self.device,"]),
        ("device argument", [], ["device=self.device,"]),
    ],
    "bus/pool.py": [
        ("device argument", [], ["from ..core.device import resolve_device"]),
        ("device argument", [], ['device="cuda",']),
        ("device argument", [], [
            "# every shard's worker, and so its join backend, on this one device",
            "self.device = resolve_device(device)"]),
        ("device argument", [], ["device=self.device,"]),
    ],
    "bus/proc.py": [
        ("the start method on a CUDA device", [
            "Start method: ``fork`` where available (fast; inherits registered",
            "conditions/actions/pyfuncs), else ``spawn`` (``child_init`` and any custom",
            "registrations must then be importable/picklable).  Event-id uniqueness",
            "across forked processes is guaranteed by the per-process id prefix in",
            "``repro.core.events``."], [
            "Start method: on the CPU, ``fork`` where available (fast; inherits",
            "registered conditions/actions/pyfuncs), else ``spawn``.  On a CUDA device,",
            "``forkserver``, its server preloading ``torch`` and this module: a CUDA",
            "context does not survive a fork, and the server never starts one, so every",
            "shard makes its own, and a shard forks from the server in well under a",
            "second where a spawned one first imports torch.  An explicit ``fork``",
            "raises there once the parent has initialised CUDA.  Under ``spawn`` and",
            "``forkserver`` ``child_init`` and any custom registrations must be",
            "importable/picklable.  Every shard runs on the pool's device, named with",
            "its index (``cuda:0``), whatever the child's current device.  Event-id",
            "uniqueness across forked processes is guaranteed by the per-process id",
            "prefix in ``repro.core.events``."]),
        ("device argument", [], ["import torch", "", "from ..core.device import resolve_device"]),
        ("device argument: the child's worker", [], ['device=cfg["device"],']),
        ("device argument", [], ['device="cuda",']),
        ("device argument and the start method on a CUDA device", [], [
            "# one device for every shard, fixed here with its index, and a start",
            "# method that gives each shard on a card a fresh CUDA context",
            "self.device = resolve_device(device)",
            'on_cuda = self.device.type == "cuda"',
            "if start_method is None and on_cuda:",
            'start_method = "forkserver"',
            'mp.get_context(start_method).set_forkserver_preload(["torch", __name__])',
            'elif start_method == "fork" and on_cuda and torch.cuda.is_initialized():',
            "raise ValueError(",
            "\"start_method='fork' on %s: CUDA is initialised in this process \"",
            "\"and a forked shard cannot use it; use 'spawn' or 'forkserver'\"",
            "% self.device)"]),
        ("device argument: handed to the child with its index", [],
         ['"device": str(self.device),']),
    ],
    "chaos/soak.py": [
        ("device argument", ["tracer=None) -> Dict[str, Any]:"],
         ['tracer=None, device="cuda") -> Dict[str, Any]:']),
        ("device argument", ["keep_event_log=False, tracer=tracer)"],
         ["keep_event_log=False, tracer=tracer, device=device)"]),
        ("device argument", ["fsync: bool = True) -> Dict[str, Any]:"],
         ['fsync: bool = True, device="cuda") -> Dict[str, Any]:']),
        ("device argument", ["child_init=soak_child_init,"],
         ["child_init=soak_child_init, device=device,"]),
        ("device argument", ["timeout: float = 60.0) -> Dict[str, Any]:"],
         ['timeout: float = 60.0, device="cuda") -> Dict[str, Any]:']),
        ("device argument", ["keep_event_log=False)"],
         ["keep_event_log=False, device=device)"]),
        ("device argument", ["fsync: bool = False) -> Dict[str, Any]:"],
         ['fsync: bool = False, device="cuda") -> Dict[str, Any]:']),
        ("device argument", ["child_init=soak_child_init, replicate=True, lease=True,"],
         ["child_init=soak_child_init, replicate=True, lease=True, device=device,"]),
    ],
    "configs/__init__.py": [
        ("an architecture of the port's alone", [], [
            "from . import nemotron_3_nano_30b_a3b"]),
        ("an architecture of the port's alone", [], [
            "# the port's alone (no family of the JAX package's computes them): in",
            "# ``get_config`` and ``ALL_ARCHS``, not in ``ARCHS``, which the tests hold",
            "# against the JAX package",
            '_MODULES["nemotron-3-nano-30b-a3b"] = nemotron_3_nano_30b_a3b',
            "ALL_ARCHS = list(_MODULES.keys())"]),
    ],
}
COPIED = ([f"core/{m}.py" for m in (
    "codec", "events", "triggers", "policy", "conditions", "context", "actions",
    "eventstore", "statestore", "functions", "batch", "worker", "service",
    "autoscaler", "dag", "statemachine", "workflow_as_code", "fedlearn", "__init__")]
    + [f"bus/{m}.py" for m in ("group", "replicate", "partitioned", "pool", "proc",
                               "__init__")]
    + [f"chaos/{m}.py" for m in ("faults", "soak", "__init__")]
    + [f"obs/{m}.py" for m in ("trace", "metrics", "__init__")]
    + [f"analysis/{m}.py" for m in ("core", "durability", "fencing", "lockrules",
                                    "locktrace", "obsrules", "seams", "__init__")]
    + ["training/data.py", "distributed/compression.py"]
    + [f"configs/{p.name}" for p in sorted((SRC / "repro" / "configs").glob("*.py"))])
_IMPORT = re.compile(r"^(\s*)(from|import)\s+repro\.")


@pytest.mark.parametrize("module", COPIED)
def test_copied_module_has_not_drifted(module):
    ref = [(_IMPORT.sub(r"\1\2 repro_torch.", line)).rstrip()
           for line in (SRC / "repro" / module).read_text().splitlines()]
    port = [line.rstrip() for line in (SRC / "repro_torch" / module).read_text().splitlines()]
    hunks = [([s.strip() for s in ref[i1:i2]], [s.strip() for s in port[j1:j2]])
             for tag, i1, i2, j1, j2
             in difflib.SequenceMatcher(None, ref, port, autojunk=False).get_opcodes()
             if tag != "equal"]
    assert hunks == [(rm, add) for _reason, rm, add in EDITS.get(module, [])]


def test_tfcheck_passes_over_the_copy():
    """The port's own entry point, with its copy of the rules, over its
    default scope: the port's core, bus and chaos."""
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis.cli"],
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=str(SRC)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("tfcheck: clean ("), out.stdout
