"""The port's chaos harness (``repro_torch.chaos``) against the reference's.

* The thread soak: one seed gives the port the reference's world (results,
  quarantine, committed ids, fault history, crashes, lag, obs counters).
* The process soak (seeded SIGKILLs plus a torn segment tail): its
  invariants hold on the port, and its shards build the CPU's join backend
  (``torch``).  Its triggers are ``true`` conditions, which the vector join
  plane never claims, so its shards make no join call, as in the reference.
* The Table-1 join's shape under seeded SIGKILLs and a torn tail, on
  process shards of both packages: the bus's guarantees for a plain counter
  hold (no event lost, none committed twice, every count at least its
  events: at-least-once), and the port's shards run the vector plane.
"""
import multiprocessing as mp
import time
from types import SimpleNamespace

import pytest

import repro.bus as ref_bus
import repro.chaos.soak as ref_soak
import repro.core as ref_core
import repro_torch.bus as port_bus
import repro_torch.chaos.soak as port_soak
import repro_torch.core as port_core
from repro_torch.chaos import tear_segment_tail

PKGS = {
    "port": SimpleNamespace(bus=port_bus, core=port_core, soak=port_soak,
                            dev={"device": "cpu"}),
    "ref": SimpleNamespace(bus=ref_bus, core=ref_core, soak=ref_soak, dev={}),
}


class JoinCounts:
    """``child_init`` for the port's process shards (forked here): counts,
    summed over every shard, the join planes built, those whose backend is
    not ``want``, the join calls, and the kernel launches those calls made
    (``ops.launches``, the wrapper's own count).  Each shard writes only
    its own slot, with no lock, so a SIGKILLed shard leaves no lock held;
    slots are handed out under a lock before a shard reports ready, and the
    tests kill a shard only after ``start_shards`` returned."""

    FIELDS = ("planes", "wrong", "calls", "launches")

    def __init__(self, want, inner=None, slots=64):
        ctx = mp.get_context("fork")
        self.want, self.inner = want, inner
        self.next_slot = ctx.Value("i", 0)
        self.counts = ctx.RawArray("q", slots * len(self.FIELDS))

    def total(self, name):
        """One field summed over every shard's slot."""
        n = len(self.FIELDS)
        return sum(self.counts[self.FIELDS.index(name)::n])

    def __call__(self, backend):
        from repro_torch.kernels.event_join import dispatch, ops

        if self.inner is not None:
            self.inner(backend)
        with self.next_slot.get_lock():
            slot = self.next_slot.value
            self.next_slot.value += 1
        c, i0 = self.counts, slot * len(self.FIELDS)
        resolve, join = dispatch.resolve_join_backend, dispatch.join_counts_segments

        def resolved(name):
            out = resolve(name)
            c[i0] += 1
            c[i0 + 1] += out[0] != self.want
            return out

        def counted(lens, counts, expected, fn):
            before = ops.launches
            out = join(lens, counts, expected, fn)
            c[i0 + 2] += 1
            c[i0 + 3] += ops.launches - before
            return out

        dispatch.resolve_join_backend = resolved
        dispatch.join_counts_segments = counted


# ------------------------------------------------------------ thread soak ----
@pytest.mark.parametrize("seed", [11, 13])
def test_thread_soak_same_seed_same_world_as_reference(seed):
    port = port_soak.run_soak(seed=seed, device="cpu")
    ref = ref_soak.run_soak(seed=seed)
    for key in ("done", "dlq_by_reason", "committed_ids", "faults", "history",
                "crashes", "lag", "obs"):
        assert port[key] == ref[key], key
    assert sum(port["faults"].values()) > 0


# ----------------------------------------------------------- process soak ----
def test_proc_soak_sigkill_and_torn_tail(monkeypatch, tmp_path):
    counts = JoinCounts("torch", inner=port_soak.soak_child_init)
    monkeypatch.setattr(port_soak, "soak_child_init", counts)
    s = port_soak.run_soak_proc(str(tmp_path / "soak"), seed=3, device="cpu")
    assert s["crashes"] >= 1
    assert s["dlq_by_reason"] == {"poison:action-error": 3}
    assert s["lag"] == 0
    # (assert_invariants ran inside run_soak_proc.)  Every shard built the
    # CPU's backend; the soak's `true` triggers never reach it
    assert counts.total("planes") >= 2 and counts.total("wrong") == 0
    assert counts.total("calls") == 0


# ------------------------------------------- the join under SIGKILL chaos ----
def chaos_join(p, root, seed=3, n_subj=32, per_subj=50, kills=2, child_init=None):
    """The Table-1 join's shape (more subjects than partitions, so a batch
    of one partition holds several: the vector plane needs two) on process
    shards with seeded SIGKILLs and a torn segment tail after the first;
    returns what the bus guarantees a plain (not ``exactly_once``)
    counter."""
    total = n_subj * per_subj
    pool = p.bus.ProcessShardPool(
        str(root), num_partitions=8, batch_size=64, child_init=child_init,
        breaker={"backoff_base": 0.02, "backoff_max": 0.1, "cooldown": 0.05},
        **p.dev)
    try:
        pool.create_workflow("w")
        for i in range(n_subj):
            pool.add_trigger("w", p.core.make_trigger(
                f"s{i}", condition={"name": "counter", "expected": per_subj,
                                    "aggregate": False},
                action={"name": "noop"}, trigger_id=f"t{i}", transient=False))
        pool.publish_batch("w", [p.core.termination_event(f"s{i % n_subj}", i)
                                 for i in range(total)])
        pool.start_shards("w", 2)
        deadline = time.monotonic() + 60
        for k in range(kills):
            u = p.soak._u(seed, "kill", k)
            target = int(total * (0.15 + 0.6 * u) * (k + 1) / kills)
            while sum(pool.event_store.commit_offsets("w")) < target and pool.lag("w"):
                assert time.monotonic() < deadline, pool.failure_diagnostics("w")
                time.sleep(0.002)
            members = pool.shard_ids("w")
            if members:
                pool.crash_shard("w", members[int(u * len(members)) % len(members)])
            if k == 0:
                tear_segment_tail(pool.bus_root, suffix=".log")
            pool.start_shards("w", 2)
        pool.wait_drained("w", timeout=max(5.0, deadline - time.monotonic()))
        ids = [e.id for e in pool.event_store.committed_events("w")]
        counts = [pool.trigger_context("w", f"t{i}").get("count", 0)
                  for i in range(n_subj)]
        return {"committed": len(ids), "unique": len(set(ids)), "total": total,
                "lag": pool.lag("w"), "counts": counts, "per_subj": per_subj,
                "crashes": pool.metrics("w")["crashes"]}
    finally:
        pool.stop_all()


def assert_at_least_once(r):
    assert r["lag"] == 0
    assert r["committed"] == r["unique"] == r["total"]  # none lost, none twice
    # every trigger reached its threshold, so fired; a batch redelivered
    # after a kill between its checkpoint and its commit may count again
    assert min(r["counts"]) >= r["per_subj"]
    assert r["crashes"] >= 1


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_join_under_sigkill_and_torn_tail(pkg, tmp_path):
    p = PKGS[pkg]
    counts = JoinCounts("torch") if pkg == "port" else None
    r = chaos_join(p, tmp_path / "pool", child_init=counts)
    assert_at_least_once(r)
    if counts is not None:  # the port's shards ran the plain K1 on the CPU
        assert counts.total("wrong") == 0 and counts.total("calls") > 0
        assert counts.total("launches") == 0  # the CPU wrapper launches nothing
