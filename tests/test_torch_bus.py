"""The port's sharded bus (``repro_torch.bus``) against the reference's.

* Cases of tests/test_bus.py and tests/test_proc_pool.py, each run on both
  packages (``pkg``): the thread pool drains and counts once, a crash
  rebalances exactly once, thread and process shards agree on the join, a
  SIGKILLed shard recovers exactly once, a restarted pool recovers from
  disk, and the facade works over thread shards.  The process join's
  observables (fires, contexts, committed events, lag) are equal across
  the packages.
* The device: both pools carry it to every shard; a process shard is
  handed the pool's device with its index; on a CUDA device the default
  start method is ``forkserver`` (its server preloading torch) and ``fork``
  raises once CUDA is initialised;
  a shard whose join backend fails crashes, and the pool records it.
* One process pool started with ``spawn`` and one with ``forkserver`` on
  the CPU.

Every wait is bounded (``wait_drained``'s timeout, explicit deadlines), and
every process pool is stopped in a ``finally``.
"""
import time
from types import SimpleNamespace

import pytest
import torch

import repro.bus as ref_bus
import repro.core as ref_core
import repro_torch.bus as port_bus
import repro_torch.core as port_core
from repro_torch.bus import proc as port_proc

PKGS = {
    "port": SimpleNamespace(bus=port_bus, core=port_core, dev={"device": "cpu"}),
    "ref": SimpleNamespace(bus=ref_bus, core=ref_core, dev={}),
}
pkgs = pytest.mark.parametrize("pkg", sorted(PKGS))


def _sharded_tf(p, partitions=8, commit_policy="every_batch"):
    store = p.bus.PartitionedEventStore(partitions)
    tf = p.core.Triggerflow(event_store=store, inline_functions=True,
                            commit_policy=commit_policy, **p.dev)
    return tf, store


def _proc_pool(p, root, **kw):
    kw.setdefault("num_partitions", 8)
    kw.setdefault("batch_size", 256)
    return p.bus.ProcessShardPool(str(root), **p.dev, **kw)


def _join_triggers(p, n_subj, per_subj, exactly_once=False):
    cond = {"name": "counter", "expected": per_subj, "aggregate": False}
    if exactly_once:
        cond["exactly_once"] = True
    return [p.core.make_trigger(f"s{i}", condition=dict(cond),
                                action={"name": "noop"}, trigger_id=f"t{i}",
                                transient=False) for i in range(n_subj)]


# ------------------------------------------------------------ thread pool ----
@pkgs
def test_pool_drains_and_counts_once(pkg):
    p = PKGS[pkg]
    tf, store = _sharded_tf(p)
    tf.create_workflow("w")
    for s in range(8):
        tf.add_trigger("w", p.core.make_trigger(
            f"s{s}", condition={"name": "true"}, action={"name": "noop"},
            trigger_id=f"t{s}", transient=False))
    store.publish_batch("w", [p.core.termination_event(f"s{i % 8}", i)
                              for i in range(500)])
    tf.pool.set_shard_count("w", 3)
    tf.pool.drive("w", timeout=20)
    m = tf.pool.metrics("w")
    assert m["total_lag"] == 0
    assert sum(m["events_processed"].values()) == 500
    assert sum(m["commit_offsets"]) == 500
    tf.shutdown()


@pkgs
def test_crash_rebalance_exactly_once(pkg):
    p = PKGS[pkg]
    tf, store = _sharded_tf(p)
    tf.create_workflow("w")
    n_subj, per_subj = 4, 20
    for trg in _join_triggers(p, n_subj, per_subj, exactly_once=True):
        tf.add_trigger("w", trg)
    store.publish_batch("w", [p.core.termination_event(f"s{i % n_subj}", i)
                              for i in range(n_subj * per_subj)])
    members = tf.pool.set_shard_count("w", 2)
    assert tf.pool.run_shard_once("w", members[0], 10) > 0
    tf.pool.crash_shard("w", members[0])
    assert tf.pool.shard_count("w") == 1
    tf.pool.drive("w", timeout=20)
    assert store.lag("w") == 0
    assert tf.pool.total_fires("w") == n_subj
    for s in range(n_subj):
        assert tf.pool.trigger_context("w", f"t{s}").get("count") == per_subj
    tf.shutdown()


@pkgs
def test_pool_worker_backed_service_api(pkg):
    """The Fig. 1 facade over thread shards (tests/test_bus.py)."""
    p = PKGS[pkg]
    tf, _ = _sharded_tf(p)
    tf.create_workflow("w")
    tf.pool.set_shard_count("w", 2)
    tf.add_trigger("w", p.core.make_trigger(
        "go", condition={"name": "true"}, action={"name": "noop"},
        trigger_id="tg", transient=False))
    tf.publish("w", p.core.termination_event("go", 1))
    tf.pool.drive("w", timeout=10)
    assert tf.pool.total_fires("w") == 1
    assert tf.worker("w") is not None
    tf.shutdown()


# ----------------------------------------------------------- process pool ----
def _process_join(p, root, n_subj=8, per_subj=50, **kw):
    events = [p.core.termination_event(f"s{i % n_subj}", i)
              for i in range(n_subj * per_subj)]
    pool = _proc_pool(p, root, **kw)
    try:
        pool.create_workflow("w")
        for trg in _join_triggers(p, n_subj, per_subj):
            pool.add_trigger("w", trg)
        pool.publish_batch("w", events)
        pool.start_shards("w", 2)
        pool.wait_drained("w", timeout=60)
        return {"fires": pool.total_fires("w"),
                "contexts": {i: pool.trigger_context("w", f"t{i}")
                             for i in range(n_subj)},
                "committed": sorted((e.subject, e.data["result"])
                                    for e in pool.event_store.committed_events("w")),
                "lag": pool.lag("w")}
    finally:
        pool.stop_all()


@pkgs
def test_thread_process_parity_join(pkg, tmp_path):
    p = PKGS[pkg]
    n_subj, per_subj = 8, 50
    proc = _process_join(p, tmp_path / "pool", n_subj, per_subj)
    tf, store = _sharded_tf(p)
    tf.create_workflow("w")
    for trg in _join_triggers(p, n_subj, per_subj):
        tf.add_trigger("w", trg)
    store.publish_batch("w", [p.core.termination_event(f"s{i % n_subj}", i)
                              for i in range(n_subj * per_subj)])
    tf.pool.set_shard_count("w", 2)
    tf.pool.drive("w", timeout=30)
    assert proc["fires"] == tf.pool.total_fires("w") == n_subj
    for i in range(n_subj):
        assert proc["contexts"][i].get("count") == per_subj \
            == tf.pool.trigger_context("w", f"t{i}").get("count")
    tf.shutdown()


def test_process_join_matches_reference(tmp_path):
    """The same join through process shards of both packages: equal fires,
    contexts, committed events and lag."""
    port = _process_join(PKGS["port"], tmp_path / "port")
    ref = _process_join(PKGS["ref"], tmp_path / "ref")
    assert port == ref
    assert port["fires"] == 8 and port["lag"] == 0
    assert len(port["committed"]) == 400


@pkgs
def test_sigkill_crash_recovery_exactly_once(pkg, tmp_path):
    p = PKGS[pkg]
    n_subj, per_subj = 8, 300
    total = n_subj * per_subj
    pool = _proc_pool(p, tmp_path / "pool", batch_size=64)
    try:
        pool.create_workflow("w")
        for trg in _join_triggers(p, n_subj, per_subj, exactly_once=True):
            pool.add_trigger("w", trg)
        pool.publish_batch("w", [p.core.termination_event(f"s{i % n_subj}", i)
                                 for i in range(total)])
        members = pool.start_shards("w", 2)
        deadline = time.monotonic() + 60
        while pool.lag("w") > total * 0.6:
            assert time.monotonic() < deadline, "stream never started draining"
            time.sleep(0.002)
        pool.crash_shard("w", members[0])
        assert pool.shard_count("w") == 1
        assert pool.metrics("w")["crashes"] == 1
        pool.start_shards("w", 2)
        pool.wait_drained("w", timeout=60)
        ids = [e.id for e in pool.event_store.committed_events("w")]
        assert len(ids) == len(set(ids)) == total
        for i in range(n_subj):
            assert pool.trigger_context("w", f"t{i}").get("count") == per_subj
    finally:
        pool.stop_all()


@pkgs
def test_restarted_pool_recovers_from_disk(pkg, tmp_path):
    p = PKGS[pkg]
    root = tmp_path / "pool"
    pool = _proc_pool(p, root, batch_size=64)
    try:
        pool.create_workflow("w")
        pool.add_trigger("w", p.core.make_trigger(
            "s0", condition={"name": "counter", "expected": 100,
                             "aggregate": False, "exactly_once": True},
            action={"name": "noop"}, trigger_id="t0", transient=False))
        pool.publish_batch("w", [p.core.termination_event("s0", i) for i in range(60)])
        pool.start_shards("w", 1)
        pool.wait_drained("w", timeout=60)
    finally:
        pool.stop_all()
    pool2 = _proc_pool(p, root, batch_size=64)
    try:
        pool2.publish_batch("w", [p.core.termination_event("s0", 60 + i)
                                  for i in range(40)])
        pool2.start_shards("w", 1)
        pool2.wait_drained("w", timeout=60)
        assert pool2.trigger_context("w", "t0").get("count") == 100
        assert pool2.total_fires("w") >= 1
    finally:
        pool2.stop_all()


# ----------------------------------------------------------------- device ----
def test_pools_carry_the_device_to_their_shards(monkeypatch, tmp_path):
    store = port_bus.PartitionedEventStore(4)
    es_backend = port_core.FunctionBackend(store, inline=True)
    pool = port_bus.ShardedWorkerPool(store, port_core.MemoryStateStore(), es_backend,
                                      device="cpu")
    pool.set_shard_count("w", 2)
    workers = [pool._wfs["w"].shards[m] for m in pool.shard_ids("w")]
    assert pool.device == torch.device("cpu")
    assert [w.device for w in workers] == [torch.device("cpu")] * 2
    assert [w._vector_plane.backend for w in workers] == ["torch"] * 2
    proc = port_bus.ProcessShardPool(str(tmp_path / "pool"), device="cpu")
    assert proc._cfg["device"] == "cpu"
    assert proc.start_method == "fork"  # the reference's rule on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls, args in ((port_bus.ShardedWorkerPool,
                       (store, port_core.MemoryStateStore(), es_backend)),
                      (port_bus.ProcessShardPool, (str(tmp_path / "cuda"),))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(*args, device="cuda")


@pytest.fixture
def fake_cuda(monkeypatch):
    """A parent that sees two cards, current device 0, CUDA initialised;
    nothing here touches a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)


def test_cuda_pool_forks_from_a_server_and_refuses_fork(fake_cuda, tmp_path):
    import multiprocessing.forkserver as forkserver

    pool = port_bus.ProcessShardPool(str(tmp_path / "a"), device="cuda")
    assert pool.start_method == "forkserver"
    assert "torch" in forkserver._forkserver._preload_modules
    assert pool._cfg["device"] == "cuda:0"  # bare cuda fixed with its index
    assert port_bus.ProcessShardPool(str(tmp_path / "b"), device="cuda:1",
                                     start_method="spawn").start_method == "spawn"
    with pytest.raises(ValueError, match="fork"):
        port_bus.ProcessShardPool(str(tmp_path / "c"), device="cuda",
                                  start_method="fork")


class _Pipe:
    """The child's end of the command pipe: one ``stop`` command."""

    def __init__(self):
        self.sent = []
        self._inbox = [("stop",)]

    def send(self, msg):
        self.sent.append(msg)

    def poll(self, timeout=0):
        return bool(self._inbox)

    def recv(self):
        return self._inbox.pop(0)


def test_shard_on_cuda1_is_handed_cuda1(fake_cuda, monkeypatch, tmp_path):
    """The shard entry point builds its worker on the device in its
    ``cfg`` (``cuda:1``), not on the child's current device (0), and the
    worker's join backend is bound to that card."""
    pool = port_bus.ProcessShardPool(str(tmp_path / "pool"), device="cuda:1")
    built = []

    class Recording(port_proc.ShardWorker):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    monkeypatch.setattr(port_proc, "ShardWorker", Recording)
    conn = _Pipe()
    port_proc._shard_main("proc-0", "w", pool.bus_root, pool.state_root, 8, conn,
                          pool._cfg)
    (w,) = built
    assert w.device == torch.device("cuda", 1)
    assert w._vector_plane.backend == "cuda:1"
    assert w._vector_plane._join.device == torch.device("cuda", 1)
    assert [m[0] for m in conn.sent] == ["ready", "stopped"]


def test_shard_whose_join_fails_crashes(monkeypatch, tmp_path):
    """A join backend that fails inside a shard process crashes the shard
    (the pool reaps an error exit, its breaker records it) and nothing
    drains on the Python path."""
    from repro_torch.kernels.event_join import ops

    def broken(*args):
        raise RuntimeError("injected join failure")

    monkeypatch.setattr(ops, "event_join", broken)  # forked shards inherit it
    p = PKGS["port"]
    pool = _proc_pool(p, tmp_path / "pool", num_partitions=2)
    try:
        pool.create_workflow("w")
        for trg in _join_triggers(p, 4, 50):
            pool.add_trigger("w", trg)
        pool.publish_batch("w", [p.core.termination_event(f"s{i % 4}", i)
                                 for i in range(40)])
        pool.start_shards("w", 1)
        crashed, deadline = 0, time.monotonic() + 30
        while not crashed:
            assert time.monotonic() < deadline, "the shard never crashed"
            crashed = pool.reap("w")["crashed"]
            time.sleep(0.01)
        assert pool.metrics("w")["crashes"] >= 1
        assert pool.breaker_of("w").streak >= 1
        assert pool.lag("w") == 40
        assert pool.total_fires("w") == 0
    finally:
        pool.stop_all()


@pytest.mark.parametrize("method", ["spawn", "forkserver"])
def test_fresh_interpreter_shards_on_the_cpu(method, tmp_path):
    """The CPU tests' only pools whose shards do not fork from the test
    process: from a fresh interpreter (``spawn``) and from a server
    (``forkserver``, preloaded as the pool preloads it on a card); both give
    the forked pool's join."""
    import multiprocessing as mp

    mp.get_context("forkserver").set_forkserver_preload(["torch", port_proc.__name__])
    p = PKGS["port"]
    fresh = _process_join(p, tmp_path / method, n_subj=4, per_subj=20,
                          start_method=method)
    forked = _process_join(p, tmp_path / "fork", n_subj=4, per_subj=20)
    assert fresh == forked
    assert fresh["fires"] == 4
