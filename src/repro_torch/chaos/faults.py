"""Deterministic fault injectors for the failure-policy plane.

Chaos here is *replayable*: every injection decision is a pure function of
``(seed, seam, key, n-th encounter)`` — no wall clock, no ``random`` module
state.  Two runs with the same seed and the same logical call sequence draw
the same fault schedule, which is what lets the soak assert *identical
committed results* across runs instead of merely "it survived".

The injectors wrap the real seams the runtime already hardens:

* ``ChaosEventStore`` — ``publish``/``publish_batch`` (an action's produced
  events vanish mid-fire: with a retry policy this surfaces as a retryable
  action error) and ``commit``/``commit_partitions`` (the §3.4 torn window:
  checkpointed but uncommitted, the batch must replay without double
  counting).
* ``ChaosStateStore`` — ``put_contexts_delta`` (a failed checkpoint: the
  worker keeps its dirty tracking and re-emits the deltas next attempt, or
  the shard dies and the replacement replays).
* ``tear_segment_tail`` — appends a torn (half-written) record to a durable
  segment file, the crash-mid-append state the locked-writer repair path
  must truncate.

Faults raise ``InjectedFault`` *before* the real call — the worst case for
the caller, which cannot know whether the operation happened.
"""
from __future__ import annotations

import os
import zlib
from typing import Any, Dict, List, Optional, Tuple


class InjectedFault(RuntimeError):
    """A fault deliberately injected by a FaultPlan (never a real error)."""


class FaultPlan:
    """A seeded, replayable fault schedule.

    ``rates`` maps seam name → injection probability; ``max_faults`` caps
    injections per seam (bounds quarantine growth and guarantees the soak
    terminates).  Decisions are keyed by the *stable identity* of the
    operation (e.g. the event id) plus a per-key encounter counter, so a
    redelivered event draws a fresh number on each encounter — identical
    across runs, independent of shard interleaving.
    """

    def __init__(self, seed: int, rates: Optional[Dict[str, float]] = None,
                 max_faults: Optional[Dict[str, int]] = None) -> None:
        self.seed = int(seed)
        self.rates = dict(rates or {})
        self.max_faults = dict(max_faults or {})
        self._fired: Dict[str, int] = {}        # seam -> injections so far
        self._encounters: Dict[Tuple[str, str], int] = {}
        self.history: List[Tuple[str, str, int]] = []  # (seam, key, encounter)

    def _u(self, seam: str, key: str, n: int) -> float:
        h = zlib.crc32(f"{self.seed}:{seam}:{key}:{n}".encode())
        return h / 2 ** 32

    def decide(self, seam: str, key: str) -> bool:
        """True ⇒ inject a fault at ``seam`` for operation identity ``key``.

        The (seam, key) pair carries its own encounter counter: the first
        commit of event X and the replayed commit of event X are distinct
        draws, so a faulted operation does not fault forever.
        """
        rate = self.rates.get(seam, 0.0)
        if rate <= 0.0:
            return False
        cap = self.max_faults.get(seam)
        if cap is not None and self._fired.get(seam, 0) >= cap:
            return False
        k = (seam, key)
        n = self._encounters.get(k, 0)
        self._encounters[k] = n + 1
        if self._u(seam, key, n) < rate:
            self._fired[seam] = self._fired.get(seam, 0) + 1
            self.history.append((seam, key, n))
            return True
        return False

    def check(self, seam: str, key: str) -> None:
        """``decide`` + raise: the one-liner the store wrappers use."""
        if self.decide(seam, key):
            raise InjectedFault(f"{seam}[{key}] (seed={self.seed})")

    def faults_injected(self) -> Dict[str, int]:
        return dict(self._fired)


def _batch_key(events) -> str:
    """Stable identity of a publish/commit batch: its first member."""
    if not events:
        return "-"
    first = events[0]
    return first if isinstance(first, str) else first.id


class ChaosEventStore:
    """Wraps any event store; injects at the publish, commit and consume
    seams.

    A consume fault fires *before* the inner call ever runs, so the shard's
    mirror replay has not advanced — the §3.4 contract degenerates to "the
    poll never happened" and redelivery is automatic.  Everything else (DLQ,
    partition routing, lag…) passes through, so the wrapper satisfies
    whatever store protocol the inner one does — including
    ``ShardedWorkerPool``'s ``consume_partitions`` check.
    """

    def __init__(self, inner: Any, plan: FaultPlan) -> None:
        self._inner = inner
        self._plan = plan

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)

    def publish(self, workflow: str, event) -> None:
        self._plan.check("store.publish", event.id)
        return self._inner.publish(workflow, event)

    def publish_batch(self, workflow: str, events) -> None:
        self._plan.check("store.publish", _batch_key(events))
        return self._inner.publish_batch(workflow, events)

    def commit(self, workflow: str, event_ids) -> None:
        self._plan.check("store.commit", _batch_key(event_ids))
        return self._inner.commit(workflow, event_ids)

    def commit_partitions(self, workflow: str, partitions, event_ids) -> None:
        self._plan.check("store.commit", _batch_key(event_ids))
        return self._inner.commit_partitions(workflow, partitions, event_ids)

    # consume seam: the fault fires BEFORE the inner call, so no mirror
    # offset has advanced — the poll simply failed, and the next one sees
    # exactly the events this one would have.  Keyed by workflow+partitions
    # (a consume has no stable event identity before it returns).
    def consume(self, workflow: str, max_events: int = 512):
        self._plan.check("store.consume", workflow)
        return self._inner.consume(workflow, max_events)

    def consume_partition(self, workflow: str, partition: int,
                          max_events: int = 512):
        self._plan.check("store.consume", f"{workflow}:{partition}")
        return self._inner.consume_partition(workflow, partition, max_events)

    def consume_partitions(self, workflow: str, partitions,
                           max_events: int = 512):
        parts = list(partitions)
        self._plan.check(
            "store.consume",
            f"{workflow}:{','.join(str(p) for p in parts)}")
        return self._inner.consume_partitions(workflow, parts, max_events)


class ChaosStateStore:
    """Wraps any state store; injects at the checkpoint seam."""

    def __init__(self, inner: Any, plan: FaultPlan) -> None:
        self._inner = inner
        self._plan = plan

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)

    def put_contexts_delta(self, workflow: str,
                           deltas: Dict[str, Dict[str, Any]]) -> None:
        self._plan.check("state.checkpoint", ":".join(sorted(deltas)))
        return self._inner.put_contexts_delta(workflow, deltas)


#: A torn *binary* record: the varint length prefix promises a 64-byte
#: payload but the crash left only a crc fragment and a few payload bytes.
#: ``codec.iter_records`` must refuse to advance past it.
TORN_BINARY_RECORD = b"\x40\xde\xad\xbe\xef\x00Ctorn"


def tear_segment_tail(root: str, suffix: str = ".log",
                      garbage: bytes = b'{"id":"torn-tail","su') -> List[str]:
    """Append a torn (half-written) record to every segment file under
    ``root`` — the on-disk state a crash mid-append leaves behind.  The
    tear matches each file's wire format (sniffed per file, like
    ``SegmentLog`` itself): a TFB1 segment gets a binary record cut
    mid-payload, a text segment the truncated-JSON ``garbage``.  Readers
    must stop before the torn record and the next locked writer must
    truncate it.  Returns the files torn."""
    from ..core import codec

    torn: List[str] = []
    for dirpath, _dirs, files in os.walk(root):
        for fname in files:
            if not fname.endswith(suffix):
                continue
            path = os.path.join(dirpath, fname)
            with open(path, "ab+") as f:
                f.seek(0)
                head = f.read(len(codec.MAGIC))
                f.write(TORN_BINARY_RECORD if head == codec.MAGIC
                        else garbage)
            torn.append(path)
    return torn
