"""Seeded chaos soak: a fan-out workflow under deterministic faults.

Shape of the workload (the paper's aggregation pattern, §5.2, with the
failure-policy plane turned on):

* ``n_root`` root events on subject ``fan``; the ``chaos_fanout`` action
  produces one child per root with a *deterministic id* (``kid-<i>`` or
  ``poison-<i>`` every ``poison_every``-th root), routed over ``n_subj``
  subjects.
* One recording trigger per subject runs ``chaos_record`` under a
  ``RetryPolicy``: the action deterministically fails its first
  ``k(seed, id)`` attempts (flaky), always fails for ``poison-*`` ids, and
  on success records the event *exactly once* into durable context
  (idempotent-by-id — the same dedup discipline the built-in
  ``exactly_once`` counter uses, which is what makes the results exact
  under at-least-once redelivery).

``run_soak`` (thread runtime) drives a ``ShardedWorkerPool`` whose stores
are wrapped in ``ChaosEventStore``/``ChaosStateStore``: publish, commit and
checkpoint calls fail on a seeded schedule, and each ``InjectedFault`` that
escapes a batch crashes the shard (``crash_shard``: the in-flight batch
discards its commit) before a replacement is added.  The drive loop is
single-threaded and every retry backoff is zero, so the whole run — fault
schedule, crash points, committed results — is a pure function of the seed:
``run_soak(seed=s)`` twice returns identical summaries, history included.

``run_soak_proc`` (process runtime) runs the same workload on a real
``ProcessShardPool`` with seeded SIGKILL points and an optional torn
segment tail between kill and restart.  OS scheduling makes the interleaving
(and therefore the history) machine-dependent there, so it asserts the
*invariants* only: every child recorded exactly once at its deterministic
attempt number, quarantine bounded at exactly the poison set, no committed
id duplicated, lag zero.
"""
from __future__ import annotations

import time
import zlib
from typing import Any, Dict, List, Optional

from ..core.actions import register_action
from ..core.events import CloudEvent
from ..core.policy import RETRY_STATE_KEY, REASON_ACTION_ERROR
from ..core.triggers import make_trigger
from .faults import ChaosEventStore, ChaosStateStore, FaultPlan, InjectedFault, \
    tear_segment_tail

WORKFLOW = "chaos-soak"

# Seeded store-seam fault rates for the thread soak; every seam is capped so
# the run provably terminates (a fault consumes budget, budgets are finite).
DEFAULT_RATES = {"store.publish": 0.12, "store.commit": 0.10,
                 "state.checkpoint": 0.08, "store.consume": 0.05}
DEFAULT_MAX_FAULTS = {"store.publish": 6, "store.commit": 5,
                      "state.checkpoint": 4, "store.consume": 3}

# The replicated soak adds the host-loss fault domain's seams: dropped
# replication frames/acks (healed, never crashing) and injected lease-expiry
# clock skew (a loud FencedWrite, cleared only by sanctioned re-assignment).
REPLICATED_RATES = dict(DEFAULT_RATES, **{
    "replicate.send": 0.08, "replicate.ack": 0.06, "lease.expire": 0.04})
REPLICATED_MAX_FAULTS = dict(DEFAULT_MAX_FAULTS, **{
    "replicate.send": 4, "replicate.ack": 3, "lease.expire": 2})


def _u(seed: int, *parts: Any) -> float:
    h = zlib.crc32(":".join(str(p) for p in (seed,) + parts).encode())
    return h / 2 ** 32


def fail_budget(seed: int, event_id: str, fail_pct: int,
                max_consecutive: int = 2) -> int:
    """How many leading attempts of ``event_id`` fail (0 = never flaky).
    Pure function of (seed, id): every delivery — original, retry, or
    post-crash replay — computes the same schedule."""
    h = zlib.crc32(f"{seed}:flaky:{event_id}".encode())
    if (h % 100) >= fail_pct:
        return 0
    return 1 + (h >> 8) % max_consecutive


def _attempt_number(ctx, event) -> int:
    """This delivery's 1-based attempt number, from the durable retry state
    (the policy plane records attempt N *after* attempt N fails)."""
    rec = (ctx.get(RETRY_STATE_KEY) or {}).get(event.id)
    return (rec[0] if rec else 0) + 1


def _chaos_fanout(ctx, event, params) -> None:
    """Produce one deterministic-id child per root event (§5.2 fan-out).
    Child ids are stable across runs and replays, so chaos decisions keyed
    on them — and the final committed id set — are seed-reproducible."""
    i = event.data["i"]
    poison_every = params.get("poison_every", 0)
    poison = poison_every and i % poison_every == 0
    kid = CloudEvent(
        subject="s%d" % (i % params["n_subj"]),
        data={"result": i},
        id=("poison-%d" % i) if poison else ("kid-%d" % i))
    ctx.produce(kid)


def _chaos_record(ctx, event, params) -> None:
    """Deterministically flaky recorder: fail the first ``k(seed, id)``
    attempts, always fail poison ids, then record exactly once by id."""
    if event.id.startswith("poison-"):
        raise InjectedFault("poison event %s" % event.id)
    attempt = _attempt_number(ctx, event)
    k = fail_budget(params["seed"], event.id, params.get("fail_pct", 0),
                    params.get("max_consecutive", 2))
    if attempt <= k:
        raise InjectedFault(
            "flaky %s attempt %d/%d" % (event.id, attempt, k))
    done = dict(ctx.get("done") or {})
    if event.id not in done:  # idempotent by id: exact under redelivery
        done[event.id] = attempt
        ctx["done"] = done


def register_soak_functions() -> None:
    register_action("chaos_fanout", _chaos_fanout)
    register_action("chaos_record", _chaos_record)


register_soak_functions()


def soak_child_init(backend) -> None:
    """`child_init` for spawn-started shard processes: importing this module
    registers the chaos actions (fork children inherit them for free)."""
    register_soak_functions()


def _soak_triggers(seed: int, n_subj: int, poison_every: int, fail_pct: int,
                   max_attempts: int = 4):
    # zero backoff + zero jitter: retries re-enter on the very next batch, so
    # the thread soak's schedule is timing-independent (seed-deterministic)
    policy = {"max_attempts": max_attempts, "backoff_base": 0.0,
              "backoff_factor": 1.0, "backoff_max": 0.0, "jitter": 0.0}
    trgs = [make_trigger(
        "fan", condition={"name": "true"},
        action={"name": "chaos_fanout", "n_subj": n_subj,
                "poison_every": poison_every},
        trigger_id="t-fan", transient=False, retry=policy)]
    for j in range(n_subj):
        trgs.append(make_trigger(
            f"s{j}", condition={"name": "true"},
            action={"name": "chaos_record", "seed": seed,
                    "fail_pct": fail_pct, "max_consecutive": 2},
            trigger_id=f"t-rec-{j}", transient=False, retry=policy))
    return trgs


def expected_results(seed: int, n_root: int, n_subj: int, poison_every: int,
                     fail_pct: int) -> Dict[str, Dict[str, int]]:
    """The oracle: per-subject ``{kid id: success attempt}`` maps."""
    out: Dict[str, Dict[str, int]] = {f"s{j}": {} for j in range(n_subj)}
    for i in range(n_root):
        if poison_every and i % poison_every == 0:
            continue
        kid = "kid-%d" % i
        out["s%d" % (i % n_subj)][kid] = 1 + fail_budget(seed, kid, fail_pct)
    return out


def n_poison(n_root: int, poison_every: int) -> int:
    if not poison_every:
        return 0
    return len(range(0, n_root, poison_every))


def assert_invariants(summary: Dict[str, Any], seed: int, n_root: int,
                      n_subj: int, poison_every: int, fail_pct: int) -> None:
    """The soak's acceptance bar — exactly-once results, bounded quarantine,
    nothing stuck — shared by both runtimes."""
    assert summary["lag"] == 0, f"stuck partitions: {summary}"
    oracle = expected_results(seed, n_root, n_subj, poison_every, fail_pct)
    assert summary["done"] == oracle, (
        f"committed results drifted from the oracle:\n"
        f"  got      {summary['done']}\n  expected {oracle}")
    poison = n_poison(n_root, poison_every)
    want_dlq = {REASON_ACTION_ERROR: poison} if poison else {}
    assert summary["dlq_by_reason"] == want_dlq, (
        f"quarantine not bounded at the poison set: {summary['dlq_by_reason']}"
        f" != {want_dlq}")
    ids = summary["committed_ids"]
    assert len(ids) == len(set(ids)), "an event id committed twice"
    missing = {f"soak-{i}" for i in range(n_root)} - set(ids)
    assert not missing, f"root events never committed: {sorted(missing)}"


def _lose_tree(path: str, timeout: float = 5.0) -> None:
    """rmtree that tolerates racing writers — the host-loss simulation.

    A zombie shard may recreate a file between rmtree's directory scan and
    the final rmdir (Errno 39).  It can only win that race a bounded number
    of times: its next commit reads the missing lease, fences, and exits.
    """
    import shutil
    deadline = time.monotonic() + timeout
    while True:
        try:
            shutil.rmtree(path)
            return
        except FileNotFoundError:
            return
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.01)


def _collect(pool, store, n_subj: int) -> Dict[str, Any]:
    done = {}
    for j in range(n_subj):
        ctx = pool.trigger_context(WORKFLOW, f"t-rec-{j}")
        done[f"s{j}"] = dict(ctx.get("done") or {})
    return {
        "done": done,
        "dlq_by_reason": store.dlq_by_reason(WORKFLOW),
        "committed_ids": sorted(e.id for e in store.committed_events(WORKFLOW)),
        "lag": store.lag(WORKFLOW),
        "obs": pool.obs_snapshot(WORKFLOW)["counters"],
    }


def run_soak(seed: int = 0, n_root: int = 39, n_subj: int = 4,
             poison_every: int = 13, fail_pct: int = 35, shards: int = 2,
             rates: Optional[Dict[str, float]] = None,
             max_faults: Optional[Dict[str, int]] = None,
             batch_size: int = 16, timeout: float = 30.0,
             tracer=None, device="cuda") -> Dict[str, Any]:
    """Thread-runtime soak: deterministic drive under seeded store faults.

    Returns a summary (already asserted against the oracle) whose every
    field — including the fault ``history`` — is a pure function of the
    arguments: run it twice with one seed and compare.
    """
    from ..bus import PartitionedEventStore, ShardedWorkerPool
    from ..core.functions import FunctionBackend
    from ..core.statestore import MemoryStateStore

    plan = FaultPlan(seed,
                     rates if rates is not None else DEFAULT_RATES,
                     max_faults if max_faults is not None else DEFAULT_MAX_FAULTS)
    inner = PartitionedEventStore(n_subj)
    store = ChaosEventStore(inner, plan)
    state = ChaosStateStore(MemoryStateStore(), plan)
    pool = ShardedWorkerPool(
        store, state, FunctionBackend(store, inline=True),
        commit_policy="every_batch", batch_size=batch_size,
        keep_event_log=False, tracer=tracer, device=device)
    for trg in _soak_triggers(seed, n_subj, poison_every, fail_pct):
        pool.add_trigger(WORKFLOW, trg)
    inner.publish_batch(WORKFLOW, [
        CloudEvent(subject="fan", data={"i": i}, id=f"soak-{i}")
        for i in range(n_root)])
    pool.set_shard_count(WORKFLOW, shards)

    deadline = time.monotonic() + timeout
    crashes = 0
    while True:
        progressed = 0
        for member in pool.shard_ids(WORKFLOW):
            try:
                progressed += pool.run_shard_once(WORKFLOW, member)
            except InjectedFault:
                # the batch's checkpoint/commit (or a mid-fire publish that
                # escaped the retry budget) tore: treat it as a shard crash —
                # discard the in-flight commit, rebalance, replay
                pool.crash_shard(WORKFLOW, member)
                crashes += 1
        if pool.shard_count(WORKFLOW) < shards:
            pool.set_shard_count(WORKFLOW, shards)
            continue
        if progressed == 0 and inner.lag(WORKFLOW) == 0:
            break
        if time.monotonic() > deadline:
            raise TimeoutError("chaos soak did not drain: "
                               + pool.failure_diagnostics(WORKFLOW))

    summary = _collect(pool, inner, n_subj)
    summary["faults"] = plan.faults_injected()
    summary["history"] = list(plan.history)
    summary["crashes"] = crashes
    assert_invariants(summary, seed, n_root, n_subj, poison_every, fail_pct)
    return summary


def run_soak_proc(root: str, seed: int = 0, n_root: int = 24, n_subj: int = 4,
                  poison_every: int = 9, fail_pct: int = 30, shards: int = 2,
                  kills: int = 2, torn_tail: bool = True,
                  batch_size: int = 16, timeout: float = 90.0,
                  fsync: bool = True, device="cuda") -> Dict[str, Any]:
    """Process-runtime soak: the same workload over the durable file bus
    with seeded SIGKILL points (and a torn segment tail after the first
    kill).  Asserts the shared invariants; interleaving-dependent fields
    (history) do not exist here."""
    from ..bus import ProcessShardPool

    pool = ProcessShardPool(
        root, num_partitions=n_subj, batch_size=batch_size, fsync=fsync,
        child_init=soak_child_init, device=device,
        # soften the breaker so deliberate kills never stall the restart
        # schedule past the soak timeout (the kills are the test, not a
        # genuine crash loop)
        breaker={"backoff_base": 0.02, "backoff_max": 0.1, "cooldown": 0.05})
    try:
        pool.create_workflow(WORKFLOW)
        for trg in _soak_triggers(seed, n_subj, poison_every, fail_pct):
            pool.add_trigger(WORKFLOW, trg)
        pool.publish_batch(WORKFLOW, [
            CloudEvent(subject="fan", data={"i": i}, id=f"soak-{i}")
            for i in range(n_root)])
        pool.start_shards(WORKFLOW, shards)

        # Seeded kill-at-point schedule: each kill waits for a seed-chosen
        # share of the final commit volume, SIGKILLs a seed-chosen victim,
        # optionally tears a segment tail, then restarts capacity.
        total_commits = n_root + (n_root - n_poison(n_root, poison_every))
        deadline = time.monotonic() + timeout
        for k in range(kills):
            u = _u(seed, "kill", k)
            target = int(total_commits * (0.15 + 0.6 * u) * (k + 1) / kills)
            while (sum(pool.event_store.commit_offsets(WORKFLOW)) < target
                   and pool.lag(WORKFLOW) > 0):
                if time.monotonic() > deadline:
                    raise TimeoutError("soak never reached kill point %d: %s"
                                       % (k, pool.failure_diagnostics(WORKFLOW)))
                time.sleep(0.002)
            members = pool.shard_ids(WORKFLOW)
            if not members:
                pool.start_shards(WORKFLOW, shards)
                continue
            pool.crash_shard(WORKFLOW, members[int(u * len(members)) % len(members)])
            if torn_tail and k == 0:
                tear_segment_tail(pool.bus_root, suffix=".log")
            pool.start_shards(WORKFLOW, shards)
        pool.wait_drained(WORKFLOW, timeout=max(5.0, deadline - time.monotonic()))

        summary = _collect(pool, pool.event_store, n_subj)
        summary["crashes"] = pool.metrics(WORKFLOW)["crashes"]
        assert_invariants(summary, seed, n_root, n_subj, poison_every, fail_pct)
        return summary
    finally:
        pool.stop_all()


def _files_equal(a_dir: str, b_dir: str, skip=("pub.notify",)) -> List[str]:
    """Names under ``a_dir`` whose bytes differ from (or are missing in)
    ``b_dir``.  Empty list ⇒ the replica truly mirrors the primary."""
    import os
    diff: List[str] = []
    for fn in sorted(os.listdir(a_dir)):
        if fn in skip or not os.path.isfile(os.path.join(a_dir, fn)):
            continue
        a = os.path.join(a_dir, fn)
        b = os.path.join(b_dir, fn)
        try:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                if fa.read() != fb.read():
                    diff.append(fn)
        except OSError:
            diff.append(fn)
    return diff


def run_soak_replicated(root: str, seed: int = 0, n_root: int = 30,
                        n_subj: int = 4, poison_every: int = 11,
                        fail_pct: int = 30, shards: int = 2,
                        rates: Optional[Dict[str, float]] = None,
                        max_faults: Optional[Dict[str, int]] = None,
                        batch_size: int = 16,
                        timeout: float = 60.0, device="cuda") -> Dict[str, Any]:
    """Thread-runtime soak over the *replicated, lease-fenced* file bus.

    Same deterministic drive as ``run_soak`` — plus the host-loss fault
    domain's seams: replication frames/acks drop on the seeded schedule
    (healed, never crashing a writer), lease-expiry clock skew fences owner
    writes (``FencedWrite`` crashes the shard; the replacement's rebalance
    re-acquires with a bumped epoch), and at a seed-chosen commit volume the
    primary's segment root is DELETED and rebuilt from the replica
    (``restore_from_replica``), after which the run resumes exactly-once.

    Every field of the summary — fault history, fence count, the recovery
    point — is a pure function of the arguments; the determinism test runs
    it twice and compares.  Before the loss the replica is healed to lag
    zero (semi-sync replication's acked offset IS the recovery point; the
    in-flight-lag data-loss window is pinned by the transport tests, not
    here, so the oracle stays exact for every seed).
    """
    import os

    from ..bus import FencedWrite, ReplicaServer, ShardedWorkerPool
    from ..bus.partitioned import FilePartitionedEventStore
    from ..core.functions import FunctionBackend
    from ..core.statestore import MemoryStateStore

    plan = FaultPlan(
        seed,
        rates if rates is not None else REPLICATED_RATES,
        max_faults if max_faults is not None else REPLICATED_MAX_FAULTS)
    replica_root = os.path.join(root, "replica")
    server = ReplicaServer(replica_root)
    inner = FilePartitionedEventStore(
        os.path.join(root, "bus"), n_subj, fsync=False,
        replicate_to=server.address, replicate_sync=True,
        lease_owner="node-a",
        lease_skew_hook=lambda wf, p: plan.decide(
            "lease.expire", f"{wf}:{p}"),
        replicate_fault_hook=plan.check)
    store = ChaosEventStore(inner, plan)
    state = ChaosStateStore(MemoryStateStore(), plan)
    pool = ShardedWorkerPool(
        store, state, FunctionBackend(store, inline=True),
        commit_policy="every_batch", batch_size=batch_size,
        keep_event_log=False, device=device)
    try:
        inner.create_stream(WORKFLOW)
        for trg in _soak_triggers(seed, n_subj, poison_every, fail_pct):
            pool.add_trigger(WORKFLOW, trg)
        inner.publish_batch(WORKFLOW, [
            CloudEvent(subject="fan", data={"i": i}, id=f"soak-{i}")
            for i in range(n_root)])
        pool.set_shard_count(WORKFLOW, shards)

        total_commits = n_root + (n_root - n_poison(n_root, poison_every))
        loss_at = int(total_commits * (0.2 + 0.5 * _u(seed, "host-loss")))
        deadline = time.monotonic() + timeout
        crashes = recoveries = 0
        lost = False
        while True:
            progressed = 0
            for member in pool.shard_ids(WORKFLOW):
                try:
                    progressed += pool.run_shard_once(WORKFLOW, member)
                except (InjectedFault, FencedWrite):
                    # an injected fault tore the batch, or the owner's lease
                    # was superseded/skew-expired mid-write: either way the
                    # shard dies loudly and the replacement replays
                    pool.crash_shard(WORKFLOW, member)
                    crashes += 1
            if not lost and \
                    sum(inner.commit_offsets(WORKFLOW)) >= loss_at:
                lost = True
                # heal the replica to lag zero (drop caps make this
                # converge), then lose the host: segment root deleted,
                # rebuilt from the replica, every worker replaced
                for _ in range(8):
                    inner.heal_replication(WORKFLOW)
                    inner.drain_replication(10.0)
                    if inner.replication_stats()["lag_bytes"] == 0:
                        break
                _lose_tree(inner._wf_dir(WORKFLOW))
                inner.restore_from_replica(WORKFLOW, replica_root)
                for member in pool.shard_ids(WORKFLOW):
                    pool.crash_shard(WORKFLOW, member)
                recoveries += 1
            if pool.shard_count(WORKFLOW) < shards:
                pool.set_shard_count(WORKFLOW, shards)
                continue
            if progressed == 0 and inner.lag(WORKFLOW) == 0:
                break
            if time.monotonic() > deadline:
                raise TimeoutError("replicated chaos soak did not drain: "
                                   + pool.failure_diagnostics(WORKFLOW))

        # final reconcile: the replica must end byte-identical to the
        # primary (modulo the advisory notify/lease/meta files)
        for _ in range(8):
            inner.heal_replication(WORKFLOW)
            inner.drain_replication(10.0)
            if inner.replication_stats()["lag_bytes"] == 0:
                break
        wf_dirname = WORKFLOW.replace("/", "_")
        diverged = [
            fn for fn in _files_equal(
                inner._wf_dir(WORKFLOW),
                os.path.join(replica_root, wf_dirname))
            if fn.rpartition(".")[2] in ("log", "committed", "dlq")]
        assert not diverged, f"replica diverged from primary: {diverged}"

        summary = _collect(pool, inner, n_subj)
        summary["faults"] = plan.faults_injected()
        summary["history"] = list(plan.history)
        summary["crashes"] = crashes
        summary["fenced"] = inner.fenced_writes
        summary["dropped_frames"] = inner._rep.dropped if inner._rep else 0
        summary["recoveries"] = recoveries
        assert recoveries == 1, "the host-loss point never fired"
        assert_invariants(summary, seed, n_root, n_subj, poison_every,
                          fail_pct)
        return summary
    finally:
        if inner._rep is not None:
            inner._rep.close()
        server.close()


def run_soak_host_loss(root: str, seed: int = 0, n_root: int = 24,
                       n_subj: int = 4, poison_every: int = 9,
                       fail_pct: int = 30, shards: int = 2,
                       batch_size: int = 16, timeout: float = 120.0,
                       recovery_bound: float = 15.0,
                       fsync: bool = False, device="cuda") -> Dict[str, Any]:
    """Process-runtime host-loss soak: run the chaos workload on a
    replicated, lease-fenced ``ProcessShardPool``; at a seed-chosen commit
    volume DELETE the workflow's segment root out from under the live shard
    processes (unlinked inodes: the nastiest version of losing the disk),
    then ``recover_host_loss`` — SIGKILL the zombies, rehydrate from the
    replica, restart with bumped lease epochs — and drain to the exact
    oracle.  Asserts recovery lands under ``recovery_bound`` seconds."""
    import os

    from ..bus import ProcessShardPool

    pool = ProcessShardPool(
        root, num_partitions=n_subj, batch_size=batch_size, fsync=fsync,
        child_init=soak_child_init, replicate=True, lease=True, device=device,
        breaker={"backoff_base": 0.02, "backoff_max": 0.1, "cooldown": 0.05})
    try:
        pool.create_workflow(WORKFLOW)
        for trg in _soak_triggers(seed, n_subj, poison_every, fail_pct):
            pool.add_trigger(WORKFLOW, trg)
        pool.publish_batch(WORKFLOW, [
            CloudEvent(subject="fan", data={"i": i}, id=f"soak-{i}")
            for i in range(n_root)])
        pool.start_shards(WORKFLOW, shards)

        total_commits = n_root + (n_root - n_poison(n_root, poison_every))
        target = int(total_commits * (0.2 + 0.5 * _u(seed, "host-loss")))
        deadline = time.monotonic() + timeout
        while (sum(pool.event_store.commit_offsets(WORKFLOW)) < target
               and pool.lag(WORKFLOW) > 0):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    "host-loss soak never reached the loss point: "
                    + pool.failure_diagnostics(WORKFLOW))
            time.sleep(0.002)

        _lose_tree(os.path.join(
            pool.bus_root, WORKFLOW.replace("/", "_")))
        recovery_seconds = pool.recover_host_loss(WORKFLOW, count=shards)
        assert recovery_seconds < recovery_bound, (
            f"recovery took {recovery_seconds:.2f}s "
            f"(bound {recovery_bound}s)")

        pool.wait_drained(
            WORKFLOW, timeout=max(5.0, deadline - time.monotonic()))
        summary = _collect(pool, pool.event_store, n_subj)
        m = pool.metrics(WORKFLOW)
        summary["crashes"] = m["crashes"]
        summary["recoveries"] = m["node_recoveries"]
        summary["recovery_seconds"] = recovery_seconds
        summary["leases"] = pool.event_store.lease_holders(WORKFLOW)
        assert summary["recoveries"] == 1
        assert summary["obs"].get("tf_node_recoveries_total") == 1
        assert_invariants(summary, seed, n_root, n_subj, poison_every,
                          fail_pct)
        return summary
    finally:
        pool.stop_all()
        pool.close_replication()
