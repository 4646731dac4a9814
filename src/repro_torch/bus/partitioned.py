"""Partitioned event bus (paper §4: Kafka partitions / Redis Streams).

A partitioned store is N independent ``StreamShard`` commit logs per
workflow, with pluggable key→partition routing.  The default router is a
stable hash of the event *subject*, so a workflow's causally-related events
(everything addressed to the same trigger subject) stay totally ordered
within one partition — the same per-key ordering guarantee Kafka gives for
keyed topics.

Consumers address partitions explicitly (``consume_partitions`` /
``commit_partitions``): that is what lets a consumer group hand disjoint
partition subsets to worker shards and scale horizontally without breaking
the per-subject ordering or the at-least-once commit contract.

Two backends share the routing and consumer-API orchestration
(``PartitionedStoreBase``); they differ only in the per-partition
primitives:

* ``PartitionedEventStore`` — in-memory, the thread-shard fast path.
  Locking is **striped per partition**: every ``StreamShard`` carries its
  own lock and each operation takes only the locks of the partitions it
  touches, so shard workers draining disjoint partition sets never
  serialize on the store — they contend only on the interpreter itself.
  (The pre-striping behavior — one global RLock serializing all
  partitions — is kept behind ``striped=False`` as the contention baseline
  the benchmarks A/B against.)

* ``FilePartitionedEventStore`` — durable and **cross-process**: one
  append-only segment log (+ committed-offset log + DLQ ledger) per
  partition, file-locked per partition, with a ``StreamShard`` mirror per
  partition kept in sync by incremental replay.  This is what the
  multiprocess shard runtime (``repro.bus.proc``) runs on: the striped
  in-process locks become striped *file* locks, so independent partitions
  never contend across processes either.

Aggregate reads (``lag``, ``partition_lags`` …) visit partitions one lock
at a time and are therefore momentary snapshots, exactly like Kafka
consumer-lag metrics; nothing in the worker/autoscaler contract needs a
cross-partition atomic view.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterable, List, Optional

try:
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX: in-process locks only
    fcntl = None  # type: ignore[assignment]

from ..core import codec
from ..core.events import CloudEvent, stamp_publish_time
from ..core.eventstore import EventStore, SegmentLog, StreamShard, fsync_dir
from .replicate import ReplicationClient

# subject -> partition. Stable across processes/restarts (crc32, not hash()).
Partitioner = Callable[[str, int], int]


class FencedWrite(RuntimeError):
    """A stale partition owner tried to write past its lease.

    Raised (loudly) instead of appending: the partition's lease file carries
    a higher epoch (or a different owner) than the one this store instance
    acquired, which means ownership moved on — a paused/SIGSTOPped/netsplit
    node resuming must never silently interleave its writes with the new
    owner's.  The fence *latches*: once fenced, every further owner write to
    that partition is rejected until the runtime explicitly re-acquires the
    lease through a sanctioned assignment."""


def subject_partitioner(subject: str, num_partitions: int) -> int:
    return zlib.crc32(subject.encode("utf-8")) % num_partitions


class PartitionedStoreBase(EventStore):
    """Routing + the partition-scoped consumer API, over abstract
    per-partition primitives (``_*_p`` methods).

    Per-partition guarantees (mirroring the single-stream ``StreamShard``):
    arrival order preserved, at-least-once redelivery of uncommitted events,
    commit offsets isolated per partition, per-partition DLQ + redrive.
    Cross-partition order is deliberately unspecified (as in Kafka).
    """

    #: ``consume`` never returns committed events, so an *exclusive* consumer
    #: (partition owner in a consumer group) may skip per-event is_committed
    #: checks and dedup only against its own in-flight set.
    UNCOMMITTED_ONLY = True

    def __init__(self, num_partitions: int = 8,
                 partitioner: Optional[Partitioner] = None) -> None:
        if num_partitions < 1:
            raise ValueError("num_partitions must be >= 1")
        self.num_partitions = num_partitions
        self.partitioner: Partitioner = partitioner or subject_partitioner
        # Per-workflow partition-count overrides (``create_stream(wf, n)``).
        # ``num_partitions`` stays the store default; routing and every
        # whole-stream loop resolve the count per workflow, so a small
        # control workflow can ride the same bus as a wide data workflow
        # without inheriting its partition fan-out.
        self._np: Dict[str, int] = {}

    # -- routing ---------------------------------------------------------------
    def num_partitions_for(self, workflow: str) -> int:
        """The workflow's partition count (the autoscaler's shard cap)."""
        return self._np.get(workflow, self.num_partitions)

    def partition_for(self, subject: str, workflow: Optional[str] = None) -> int:
        n = self.num_partitions if workflow is None \
            else self.num_partitions_for(workflow)
        return self.partitioner(subject, n)

    # -- per-partition primitives (subclass responsibility) --------------------
    def _have(self, workflow: str) -> bool:
        raise NotImplementedError

    def _publish_p(self, workflow: str, p: int, events: List[CloudEvent]) -> None:
        raise NotImplementedError

    def _consume_p(self, workflow: str, p: int, max_events: int) -> List[CloudEvent]:
        raise NotImplementedError

    def _commit_p(self, workflow: str, p: int, ids: set) -> int:
        raise NotImplementedError

    def _lag_p(self, workflow: str, p: int) -> int:
        raise NotImplementedError

    def _dlq_size_p(self, workflow: str, p: int) -> int:
        raise NotImplementedError

    def _redrive_p(self, workflow: str, p: int, reasons=None) -> int:
        raise NotImplementedError

    def _dlq_by_reason_p(self, workflow: str, p: int) -> Dict[str, int]:
        raise NotImplementedError

    def _to_dlq_p(self, workflow: str, p: int, event: CloudEvent) -> None:
        raise NotImplementedError

    def _is_committed_p(self, workflow: str, p: int, event_id: str) -> bool:
        raise NotImplementedError

    def _commit_offset_p(self, workflow: str, p: int) -> int:
        raise NotImplementedError

    def _committed_events_p(self, workflow: str, p: int) -> List[CloudEvent]:
        raise NotImplementedError

    # -- EventStore contract (whole-stream view) -------------------------------
    def publish(self, workflow: str, event: CloudEvent) -> None:
        stamp_publish_time((event,))
        self._publish_p(
            workflow, self.partition_for(event.subject, workflow), [event])

    def publish_batch(self, workflow: str, events: Iterable[CloudEvent]) -> None:
        events = list(events)
        stamp_publish_time(events)
        by_part: Dict[int, List[CloudEvent]] = {}
        for e in events:
            by_part.setdefault(
                self.partition_for(e.subject, workflow), []).append(e)
        # one append per touched partition, under that partition's lock only
        for p, evs in by_part.items():
            self._publish_p(workflow, p, evs)

    def consume(self, workflow: str, max_events: int = 512) -> List[CloudEvent]:
        return self.consume_partitions(
            workflow, range(self.num_partitions_for(workflow)), max_events)

    def commit(self, workflow: str, event_ids: Iterable[str]) -> None:
        self.commit_partitions(
            workflow, range(self.num_partitions_for(workflow)), event_ids)

    def is_committed(self, workflow: str, event_id: str) -> bool:
        if not self._have(workflow):
            return False
        return any(self._is_committed_p(workflow, p, event_id)
                   for p in range(self.num_partitions_for(workflow)))

    def lag(self, workflow: str) -> int:
        return self.lag_partitions(
            workflow, range(self.num_partitions_for(workflow)))

    def to_dlq(self, workflow: str, event: CloudEvent) -> None:
        self._to_dlq_p(
            workflow, self.partition_for(event.subject, workflow), event)

    def redrive(self, workflow: str, reasons=None) -> int:
        return self.redrive_partitions(
            workflow, range(self.num_partitions_for(workflow)), reasons)

    def dlq_size(self, workflow: str) -> int:
        return self.dlq_size_partitions(
            workflow, range(self.num_partitions_for(workflow)))

    def dlq_by_reason(self, workflow: str) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for p in range(self.num_partitions_for(workflow)):
            for r, n in self._dlq_by_reason_p(workflow, p).items():
                out[r] = out.get(r, 0) + n
        return out

    def committed_events(self, workflow: str) -> List[CloudEvent]:
        """Committed events, per-partition commit order, concatenated by
        partition index (cross-partition order is unspecified)."""
        out: List[CloudEvent] = []
        if not self._have(workflow):
            return out
        for p in range(self.num_partitions_for(workflow)):
            out.extend(self._committed_events_p(workflow, p))
        return out

    # -- partition-scoped consumer API (the consumer-group fast path) ----------
    def consume_partition(
        self, workflow: str, partition: int, max_events: int = 512
    ) -> List[CloudEvent]:
        if not self._have(workflow):
            return []
        return self._consume_p(workflow, partition, max_events)

    def consume_partitions(
        self, workflow: str, partitions: Iterable[int], max_events: int = 512
    ) -> List[CloudEvent]:
        """Up to ``max_events`` uncommitted events from the given partitions,
        preserving arrival order *within* each partition."""
        if not self._have(workflow):
            return []
        out: List[CloudEvent] = []
        budget = max_events
        for p in partitions:
            if budget <= 0:
                break
            got = self._consume_p(workflow, p, budget)
            out.extend(got)
            budget -= len(got)
        return out

    def commit_partitions(
        self, workflow: str, partitions: Iterable[int], event_ids: Iterable[str]
    ) -> int:
        ids = set(event_ids)
        if not ids or not self._have(workflow):
            return 0
        # Per partition: intersect once (C-level), then the shard's bulk
        # commit handles its share — an O(batch) slice/set compare in the
        # common in-order case, degrading to prefix walk + scan only for
        # ids skipped mid-stream.
        n = 0
        want = len(ids)
        for p in partitions:
            n += self._commit_p(workflow, p, ids)
            if n == want:
                break
        return n

    def partition_lags(self, workflow: str) -> List[int]:
        """Per-partition lag vector — the autoscaler's scaling signal."""
        n = self.num_partitions_for(workflow)
        if not self._have(workflow):
            return [0] * n
        return [self._lag_p(workflow, p) for p in range(n)]

    def lag_partitions(self, workflow: str, partitions: Iterable[int]) -> int:
        if not self._have(workflow):
            return 0
        return sum(self._lag_p(workflow, p) for p in partitions)

    def commit_offsets(self, workflow: str) -> List[int]:
        """Per-partition committed-event counts (isolated commit offsets)."""
        n = self.num_partitions_for(workflow)
        if not self._have(workflow):
            return [0] * n
        return [self._commit_offset_p(workflow, p) for p in range(n)]

    def dlq_size_partitions(self, workflow: str, partitions: Iterable[int]) -> int:
        if not self._have(workflow):
            return 0
        return sum(self._dlq_size_p(workflow, p) for p in partitions)

    def redrive_partitions(self, workflow: str, partitions: Iterable[int],
                           reasons=None) -> int:
        if not self._have(workflow):
            return 0
        return sum(self._redrive_p(workflow, p, reasons) for p in partitions)


class PartitionedEventStore(PartitionedStoreBase):
    """In-memory partitioned store: one ``StreamShard`` per partition,
    striped per-partition locking (``striped=False`` restores the old
    single-global-lock mode as the contention baseline)."""

    def __init__(
        self,
        num_partitions: int = 8,
        partitioner: Optional[Partitioner] = None,
        striped: bool = True,
    ) -> None:
        super().__init__(num_partitions, partitioner)
        self.striped = striped
        # Guards only the workflow → shard-list map; every shard operation
        # synchronizes on the shard's own lock.
        self._lock = threading.Lock()
        self._parts: Dict[str, List[StreamShard]] = {}

    def _shards(self, workflow: str) -> List[StreamShard]:
        parts = self._parts.get(workflow)
        if parts is None:
            with self._lock:
                parts = self._parts.get(workflow)
                if parts is None:
                    n = self.num_partitions_for(workflow)
                    parts = [StreamShard() for _ in range(n)]
                    if not self.striped:
                        # coarse mode: all partitions share one lock — the
                        # pre-striping global-serialization baseline
                        shared = threading.Lock()
                        for s in parts:
                            s.lock = shared
                    self._parts[workflow] = parts
        return parts

    def create_stream(self, workflow: str,
                      num_partitions: Optional[int] = None) -> None:
        if num_partitions is not None:
            if num_partitions < 1:
                raise ValueError("num_partitions must be >= 1")
            with self._lock:
                current = self._np.get(workflow)
                if workflow in self._parts and \
                        num_partitions != (current or self.num_partitions):
                    raise ValueError(
                        "stream %r exists with %s partitions, create_stream "
                        "asked for %s" % (workflow,
                                          current or self.num_partitions,
                                          num_partitions))
                self._np[workflow] = num_partitions
        self._shards(workflow)

    def workflows(self) -> List[str]:
        with self._lock:
            return list(self._parts.keys())

    # -- per-partition primitives ----------------------------------------------
    def _have(self, workflow: str) -> bool:
        return workflow in self._parts

    def _publish_p(self, workflow: str, p: int, events: List[CloudEvent]) -> None:
        shard = self._shards(workflow)[p]
        with shard.lock:
            shard.publish(events)

    def _consume_p(self, workflow: str, p: int, max_events: int) -> List[CloudEvent]:
        shard = self._parts[workflow][p]
        with shard.lock:
            return shard.consume(max_events)

    def _commit_p(self, workflow: str, p: int, ids: set) -> int:
        shard = self._parts[workflow][p]
        with shard.lock:
            mine = ids & shard.pending_ids
            return shard.commit(mine) if mine else 0

    def _lag_p(self, workflow: str, p: int) -> int:
        shard = self._parts[workflow][p]
        with shard.lock:
            return shard.lag()

    def _dlq_size_p(self, workflow: str, p: int) -> int:
        shard = self._parts[workflow][p]
        with shard.lock:
            return shard.dlq_size()

    def _redrive_p(self, workflow: str, p: int, reasons=None) -> int:
        shard = self._parts[workflow][p]
        with shard.lock:
            return shard.redrive(reasons)

    def _dlq_by_reason_p(self, workflow: str, p: int) -> Dict[str, int]:
        shard = self._parts[workflow][p]
        with shard.lock:
            return shard.dlq_by_reason()

    def _to_dlq_p(self, workflow: str, p: int, event: CloudEvent) -> None:
        shard = self._shards(workflow)[p]
        with shard.lock:
            shard.to_dlq(event)

    def _is_committed_p(self, workflow: str, p: int, event_id: str) -> bool:
        shard = self._parts[workflow][p]
        with shard.lock:
            return shard.is_committed(event_id)

    def _commit_offset_p(self, workflow: str, p: int) -> int:
        shard = self._parts[workflow][p]
        with shard.lock:
            return shard.commit_offset()

    def _committed_events_p(self, workflow: str, p: int) -> List[CloudEvent]:
        shard = self._parts[workflow][p]
        with shard.lock:
            return shard.committed_events()


#: DLQ-ledger record marking "quarantined events went back into the stream"
#: (``redrive``).  A bare marker redrives everything; an optional ``reasons``
#: list restricts it to matching quarantine reasons (poison stays put).
#: Ordinary ledger records are CloudEvent dicts.
_REDRIVE_MARKER = {"__redrive__": 1}


def _encode_event_batch(seg: SegmentLog, events: List[CloudEvent]):
    """One log record per *publish batch*, in the segment's active format:
    a columnar TFB1 frame (``repro.core.codec`` — the 2x-cheaper decode) on
    a binary segment, a JSON array line on a v1 one.  Either way the
    per-record overhead amortizes across the batch and the torn-tail
    contract sits at the granularity writes actually happen (a torn batch
    was never acknowledged, so dropping it whole is exactly right)."""
    if seg.active_format() == "tfb1":
        return codec.encode_frame_payload(events)
    return json.dumps([e.to_dict() for e in events], separators=(",", ":"))


def _decode_event_batch(rec) -> List[CloudEvent]:
    """A scanned log record → events, payload-shape-blind: columnar
    frames, JSON arrays and single JSON event dicts all decode, whether
    the record arrived as bytes (tfb1) or a str line (v1).  Tolerance
    matters: a str record appended through ``SegmentLog.append`` on a
    binary segment arrives as JSON *bytes*, and hard-routing every bytes
    payload to the frame decoder would stall the scan at an acknowledged
    record forever (and the next locked writer would chop it)."""
    return codec.events_of(codec.decode_payload(rec))


#: Separator between a committed record's lease-epoch prefix and the event
#: id (``e<epoch>\x1f<id>``).  Unit separator: ids never contain it, and it
#: is a 1-byte ASCII control char so byte offsets stay equal to char counts.
_EPOCH_SEP = "\x1f"


def _encode_commit_line(event_id: str, epoch: Optional[int]) -> str:
    """A committed record; when the writer holds a lease it *carries the
    owner's epoch*, so any reader can audit that commit epochs only ever
    move forward (the fencing invariant, observable on disk)."""
    if epoch is None:
        return event_id
    return "e%d%s%s" % (epoch, _EPOCH_SEP, event_id)


def _decode_commit_line(line: str) -> str:
    """Committed record → event id (epoch prefix stripped if present)."""
    if line.startswith("e"):
        i = line.find(_EPOCH_SEP)
        if i > 1 and line[1:i].isdigit():
            return line[i + 1:]
    return line


def _commit_line_epoch(line: str) -> Optional[int]:
    """The epoch a committed record carries, if any (audit/tests)."""
    if line.startswith("e"):
        i = line.find(_EPOCH_SEP)
        if i > 1 and line[1:i].isdigit():
            return int(line[1:i])
    return None


class _FilePartition:
    """One partition's durable state + its in-process mirror.

    Files (all append-only ``SegmentLog``s, named ``p<k>.*``):

    * ``.log`` — the event segment log (publish order).
    * ``.committed`` — committed event ids, append order = commit order.
    * ``.dlq`` — quarantine ledger: event records interleaved with redrive
      markers; replaying it in order reconstructs the DLQ exactly.
    * ``.lock`` — the partition's cross-process lock file (``flock``): every
      *mutating* operation holds it exclusively, so the striped-locking
      design carries over across processes — writers to different partitions
      never contend.

    The ``StreamShard`` mirror gives consumers the same O(batch) commit/DLQ
    semantics as the in-memory bus; ``sync`` incrementally replays whatever
    the files gained since the last look (only whole, CRC-verified records
    in either wire format — a torn tail from a crashed writer is invisible
    until the next locked writer truncates it).  Readers sync lock-free;
    the mirror is private.
    """

    __slots__ = ("shard", "log", "com", "dlq", "lockf", "log_off", "com_off",
                 "dlq_off", "dlq_ids", "deferred", "last_full")

    #: How stale the committed/DLQ view of a *follower* mirror may get
    #: between full syncs.  Owners don't rely on it: every mutating op
    #: (commit / quarantine / redrive) full-syncs under the partition flock,
    #: and a partition's first sync after (re)assignment is always full.
    FULL_SYNC_INTERVAL = 0.05

    def __init__(self, base: str, fsync: bool, binary: bool = True) -> None:
        self.shard = StreamShard()
        # event + DLQ segments carry batch frames and prefer the binary
        # format for new files; the committed log stays line-oriented text —
        # its epoch-tagged id records are the on-disk fencing audit surface
        self.log = SegmentLog(base + ".log", fsync=fsync, binary=binary)
        self.com = SegmentLog(base + ".committed", fsync=fsync)
        self.dlq = SegmentLog(base + ".dlq", fsync=fsync, binary=binary)
        self.lockf = open(base + ".lock", "a")
        self.log_off = 0
        self.com_off = 0
        self.dlq_off = 0
        self.dlq_ids: set = set()
        # committed ids seen before their event's log line (the owner can
        # append log + committed between two of our scans): applied as soon
        # as the event appears.
        self.deferred: set = set()
        self.last_full = 0.0  # 0 ⇒ the very first sync is always full

    def sync(self, scan_log: bool = True, full: bool = False) -> None:
        """Replay new file records into the mirror (log → DLQ → committed:
        an id's lifecycle is publish → quarantine/redrive* → commit, so this
        order never applies an op before its subject exists; ops racing past
        the scan window land in ``deferred`` until their event shows up).

        Every file probe is a (sandbox-expensive) stat, so callers steer the
        scope: ``scan_log=False`` skips the event-log probe (the store's
        publish-notify counter already proved nothing was published), and the
        committed/DLQ ledgers are only re-probed every
        ``FULL_SYNC_INTERVAL`` seconds unless ``full`` forces it."""
        now = time.monotonic()
        if full or now - self.last_full >= self.FULL_SYNC_INTERVAL:
            full = True
            scan_log = True
            self.last_full = now
        shard = self.shard
        if scan_log:
            batches, self.log_off = self.log.scan(
                _decode_event_batch, self.log_off)
            if batches:
                pend, com, dlq = (shard.pending_ids, shard.committed_ids,
                                  self.dlq_ids)
                fresh = [e for batch in batches for e in batch
                         if e.id not in pend and e.id not in com
                         and e.id not in dlq]
                if fresh:
                    shard.publish(fresh)
        if not full:
            return
        ops, self.dlq_off = self.dlq.scan(codec.decode_payload, self.dlq_off)
        for op in ops:
            if isinstance(op, dict) and "__redrive__" in op:
                reasons = op.get("reasons")
                shard.redrive(reasons)
                self.dlq_ids = {e.id for e in shard.dlq}
            else:
                # v1: one event dict per record; tfb1: a columnar frame
                # (possibly several quarantined events per record)
                for ev in codec.events_of(op):
                    if ev.id in shard.committed_ids or ev.id in self.dlq_ids:
                        continue
                    self.dlq_ids.add(ev.id)
                    shard.to_dlq(ev)
        ids, self.com_off = self.com.scan(_decode_commit_line, self.com_off)
        if ids or self.deferred:
            want = self.deferred
            want.update(ids)
            mine = want & shard.pending_ids
            if mine:
                shard.commit(mine)
            self.deferred = want - shard.committed_ids


class FilePartitionedEventStore(PartitionedStoreBase):
    """Durable, cross-process partitioned store (the process-shard bus).

    Layout: ``<root>/<workflow>/p<k>.{log,committed,dlq,lock}`` (see
    ``_FilePartition``) plus ``<root>/bus.json`` pinning ``num_partitions``
    (subject routing must agree across every process that opens the root).

    Concurrency model: any process may *publish* to any partition (parent
    load injection, cross-partition ``ctx.produce``); consume/commit/DLQ of
    a partition come only from its consumer-group owner.  Every mutating
    operation syncs + appends under the partition's exclusive ``flock``;
    reads sync the private mirror lock-free and tolerate in-flight appends
    (whole-line scans).  A SIGKILLed writer's torn tail is truncated by the
    next locked writer before it appends (``flock`` dies with the process,
    and torn bytes are always the final bytes — every writer repairs before
    appending).

    ``fsync=False`` trades power-loss durability for throughput (the Kafka
    default-flush analogy: the OS page cache survives process SIGKILL, which
    is the failure mode the crash tests and the paper's Fig 13 exercise).
    """

    def __init__(
        self,
        root: str,
        num_partitions: int = 8,
        partitioner: Optional[Partitioner] = None,
        fsync: bool = True,
        replicate_to=None,
        replicate_sync: bool = False,
        replicate_prefix: str = "",
        lease_owner: Optional[str] = None,
        lease_ttl: float = 30.0,
        lease_skew_hook: Optional[Callable[[str, int], bool]] = None,
        replicate_fault_hook: Optional[Callable[[str, str], None]] = None,
        event_codec: str = "binary",
    ) -> None:
        super().__init__(num_partitions, partitioner)
        self.root = root
        self.fsync = fsync
        # event_codec picks the wire format for NEW event/DLQ segments:
        # "binary" (TFB1 columnar frames) or "json" (v1 array lines).  An
        # existing segment's sniffed format always wins, so mixed-version
        # processes sharing a root stay byte-compatible.
        self.event_codec = event_codec
        # -- host-loss fault domain -------------------------------------------
        # replicate_to: (host, port) of a ReplicaServer — every segment
        # mutation this process makes is shipped there (see repro.bus.replicate)
        self._rep: Optional[ReplicationClient] = None
        if replicate_to is not None:
            self._rep = ReplicationClient(
                replicate_to, root, sync=replicate_sync,
                fault_hook=replicate_fault_hook, prefix=replicate_prefix)
        # lease_owner: this process's fencing identity.  When set, owner-side
        # mutations (commit / quarantine / redrive) validate the partition's
        # lease epoch under the flock before appending; a superseded epoch
        # raises FencedWrite instead of interleaving.
        self.lease_owner = lease_owner
        self.lease_ttl = lease_ttl
        self.lease_skew_hook = lease_skew_hook  # chaos seam: force-expire
        self.fenced_writes = 0
        self._lease_epochs: Dict[Any, int] = {}  # (wf, p) -> acquired epoch
        self._fenced: set = set()                # latched (wf, p) fences
        os.makedirs(root, exist_ok=True)
        meta_p = os.path.join(root, "bus.json")
        if os.path.exists(meta_p):
            with open(meta_p) as f:
                meta = json.load(f)
            if meta.get("num_partitions") != num_partitions:
                raise ValueError(
                    "bus at %s has %s partitions, store opened with %s"
                    % (root, meta.get("num_partitions"), num_partitions))
        else:
            tmp = meta_p + ".%d.tmp" % os.getpid()
            with open(tmp, "w") as f:
                json.dump({"num_partitions": num_partitions}, f)
                f.flush()
                # the pin must be readable after a power cut, not just after
                # a process crash: os.replace publishes the *name* atomically
                # but not the bytes behind it
                os.fsync(f.fileno())
            os.replace(tmp, meta_p)
        self._lock = threading.Lock()  # guards the workflow → partitions map
        self._fps: Dict[str, List[_FilePartition]] = {}
        # publish-notify counter per workflow: one byte appended per publish
        # or redrive, so a consumer poll detects "nothing new anywhere" with
        # ONE stat instead of one per partition (syscalls are the hot cost).
        # Only *size change* carries meaning, so each writer periodically
        # resets the file to keep it O(1) on disk (readers compare != , not
        # >, so a shrink is just another change).
        self._notify_fd: Dict[str, Any] = {}
        self._notify_seen: Dict[str, int] = {}
        self._notify_bumps: Dict[str, int] = {}
        # last whole-stream lag computed by ``lag()``.  A drained (0) entry
        # lets an idle poll answer with ONE notify stat — lag can only grow
        # through publish/redrive, and both bump the notify counter.
        self._lag_cache: Dict[str, int] = {}
        self._lag_verified: Dict[str, float] = {}  # last full lag() sweep

    # -- plumbing ---------------------------------------------------------------
    def _wf_dir(self, workflow: str) -> str:
        return os.path.join(self.root, workflow.replace("/", "_"))

    def _notify_path(self, workflow: str) -> str:
        return os.path.join(self._wf_dir(workflow), "pub.notify")

    def _bump_notify(self, workflow: str) -> None:
        fd = self._notify_fd.get(workflow)
        if fd is None:
            fd = open(self._notify_path(workflow), "ab", buffering=0)
            self._notify_fd[workflow] = fd
        fd.write(b".")
        n = self._notify_bumps.get(workflow, 0) + 1
        self._notify_bumps[workflow] = n
        if n % 8192 == 0:
            # bound the counter file: a shrink is a size change too, so
            # racing readers/writers see it as an ordinary notification
            try:
                if os.path.getsize(self._notify_path(workflow)) > 65536:
                    os.truncate(self._notify_path(workflow), 0)
            except OSError:  # pragma: no cover
                pass

    def _notify_changed(self, workflow: str) -> bool:
        """One stat: did anyone publish/redrive since we last looked?"""
        try:
            size = os.path.getsize(self._notify_path(workflow))
        except OSError:
            size = 0
        if size != self._notify_seen.get(workflow):
            self._notify_seen[workflow] = size
            # whoever consumes the signal must re-probe; a cached drained
            # lag is stale the moment anything was published
            self._lag_cache.pop(workflow, None)
            return True
        return False

    def _parts(self, workflow: str) -> List[_FilePartition]:
        fps = self._fps.get(workflow)
        if fps is None:
            with self._lock:
                fps = self._fps.get(workflow)
                if fps is None:
                    n = self.num_partitions_for(workflow)
                    d = self._wf_dir(workflow)
                    os.makedirs(d, exist_ok=True)
                    fps = [
                        _FilePartition(os.path.join(d, "p%04d" % p),
                                       self.fsync,
                                       binary=self.event_codec == "binary")
                        for p in range(n)
                    ]
                    if self._rep is not None:
                        for fp in fps:
                            fp.log.replicator = self._rep
                            fp.com.replicator = self._rep
                            fp.dlq.replicator = self._rep
                    self._fps[workflow] = fps
        return fps

    def append_stats(self, workflow: Optional[str] = None) -> Dict[str, float]:
        """Durable-append accounting for the metrics plane: counts/seconds
        summed over every segment log (event/committed/DLQ) this process has
        open — the store's fsync time, as seen by the shard that paid it."""
        count = 0
        seconds = 0.0
        wfs = [workflow] if workflow is not None else list(self._fps.keys())
        for wf in wfs:
            for fp in self._fps.get(wf, ()):
                for seg in (fp.log, fp.com, fp.dlq):
                    count += seg.append_count
                    seconds += seg.append_seconds
        return {"appends": count, "append_seconds": seconds}

    def _stream_meta_path(self, workflow: str) -> str:
        return os.path.join(self._wf_dir(workflow), "stream.json")

    def num_partitions_for(self, workflow: str) -> int:
        """The workflow's pinned partition count.  ``stream.json`` (written by
        ``create_stream``) overrides the bus default, so every process that
        opens the root routes this workflow's subjects identically.  The
        answer is cached once known: create a stream (and its partition
        count) before other processes publish to it — the same ordering
        ``bus.json`` already requires for the bus default.  A workflow whose
        directory does not exist yet is NOT negative-cached: it may be
        mid-creation by another process, and poisoning the cache with the
        default would misroute its subjects forever once the pin lands."""
        n = self._np.get(workflow)
        if n is None:
            try:
                with open(self._stream_meta_path(workflow)) as f:
                    n = int(json.load(f)["num_partitions"])
            except (OSError, ValueError, KeyError, TypeError):
                n = self.num_partitions
                if not os.path.isdir(self._wf_dir(workflow)):
                    return n  # stream not created yet: don't cache the miss
            self._np[workflow] = n
        return n

    @contextmanager
    def _plock(self, fp: _FilePartition):
        """The partition's cross-process writer lock.  ``fp.shard.lock`` (the
        in-process striped lock) is always held around it, so one process
        never self-deadlocks on the flock."""
        if fcntl is None:  # pragma: no cover - non-POSIX
            yield
            return
        fcntl.flock(fp.lockf.fileno(), fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fp.lockf.fileno(), fcntl.LOCK_UN)

    def _append_clean(self, seg: SegmentLog, off: int, lines) -> int:
        """Append under the flock: truncate a (dead writer's) torn tail past
        the synced offset first, so our records land on a line boundary."""
        seg.truncate(off)
        return off + seg.append(lines)

    def _append_batch_clean(
        self, seg: SegmentLog, off: int, events: List[CloudEvent]
    ) -> int:
        """Like ``_append_clean`` for one event batch, but the record is
        encoded AFTER the repair truncate: a truncate below the binary
        magic (a crash can leave a 1–4 byte header fragment, which sniffs
        as v1) frees the file to re-commit to the preferred format, so a
        format sniffed *before* the truncate can be stale — the append
        would then frame a v1 JSON line as a TFB1 record (or vice versa)
        and poison the scan at an acknowledged offset."""
        seg.truncate(off)
        return off + seg.append([_encode_event_batch(seg, events)])

    # -- lease-fenced ownership (the host-loss fault domain) -------------------
    # One JSON lease record per partition, next to ``stream.json``:
    # ``{"partition": p, "owner": <node id>, "epoch": n, "expires": unix-ts}``.
    # The *epoch* is a per-partition monotonic counter bumped on every
    # acquisition; the runtime (consumer-group assignment / host-loss
    # recovery) force-acquires on ownership change, and every owner-side
    # mutation re-validates its epoch atomically with the append (both under
    # the partition's exclusive flock) — so a stale owner is rejected, never
    # interleaved.  Expiry is the ownerless-cleanup signal, not the safety
    # mechanism: epochs do the fencing.

    def _lease_path(self, workflow: str, p: int) -> str:
        return os.path.join(self._wf_dir(workflow), "lease.p%04d.json" % p)

    def _read_lease(self, workflow: str, p: int) -> Dict[str, Any]:
        try:
            with open(self._lease_path(workflow, p)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {"partition": p, "owner": None, "epoch": 0, "expires": 0.0}

    def _write_lease(self, workflow: str, p: int, rec: Dict[str, Any]) -> None:
        path = self._lease_path(workflow, p)
        data = json.dumps(rec, separators=(",", ":"))
        tmp = path + ".%d.tmp" % os.getpid()
        with open(tmp, "w") as f:
            f.write(data)
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if self._rep is not None:
            self._rep.ship_put(path, data)
            # ownership transitions are rare control-plane writes: push them
            # to the replica NOW, so a recovery sees the newest epochs and
            # its own bump stays strictly above any fenced zombie's
            if hasattr(self._rep, "flush"):
                self._rep.flush()

    def _acquire_lease_locked(self, workflow: str, p: int) -> int:
        cur = self._read_lease(workflow, p)
        epoch = int(cur.get("epoch", 0)) + 1
        self._write_lease(workflow, p, {
            "partition": p, "owner": self.lease_owner, "epoch": epoch,
            "expires": time.time() + self.lease_ttl})
        self._lease_epochs[(workflow, p)] = epoch
        self._fenced.discard((workflow, p))
        return epoch

    def acquire_partition_lease(self, workflow: str, p: int) -> int:
        """Force-acquire partition ``p``'s lease for this node (epoch bump).
        Called by the runtime on sanctioned ownership changes — consumer
        group assignment and host-loss recovery.  Returns the new epoch."""
        if self.lease_owner is None:
            raise ValueError("store has no lease_owner; cannot acquire")
        fp = self._parts(workflow)[p]
        with fp.shard.lock, self._plock(fp):
            return self._acquire_lease_locked(workflow, p)

    def reacquire_partition_leases(self, workflow: str,
                                   partitions: Iterable[int]) -> Dict[int, int]:
        """Acquire every given partition's lease; clears any fence latches.
        The runtime's assignment path (NOT individual writers) calls this —
        which is what lets a circuit breaker gate lease re-acquisition: no
        sanctioned assignment, no new epoch."""
        return {p: self.acquire_partition_lease(workflow, p)
                for p in partitions}

    def release_partition_lease(self, workflow: str, p: int) -> None:
        """Give the lease up cleanly (revoked partition): owner cleared,
        epoch preserved so the next acquisition still moves forward."""
        key = (workflow, p)
        epoch = self._lease_epochs.pop(key, None)
        self._fenced.discard(key)
        if epoch is None or self.lease_owner is None:
            return
        fp = self._parts(workflow)[p]
        with fp.shard.lock, self._plock(fp):
            cur = self._read_lease(workflow, p)
            if cur.get("owner") == self.lease_owner \
                    and cur.get("epoch") == epoch:
                self._write_lease(workflow, p, {
                    "partition": p, "owner": None, "epoch": epoch,
                    "expires": 0.0})

    def lease_holders(self, workflow: str) -> Dict[int, str]:
        """Current on-disk lease holder per partition (``owner@e<epoch>``),
        for diagnostics — what a stalled recovery shows in its timeout."""
        out: Dict[int, str] = {}
        for p in range(self.num_partitions_for(workflow)):
            rec = self._read_lease(workflow, p)
            if rec.get("owner") is not None:
                out[p] = "%s@e%s" % (rec["owner"], rec.get("epoch", 0))
        return out

    def _fence(self, workflow: str, p: int, why: str) -> None:
        self._fenced.add((workflow, p))
        self.fenced_writes += 1
        raise FencedWrite(
            "partition %d of %r: writes by %r fenced (%s)"
            % (p, workflow, self.lease_owner, why))

    def _check_lease(self, workflow: str, p: int) -> Optional[int]:
        """Validate (or first-acquire) this node's lease under the partition
        flock, immediately before an owner-side append.  Returns the epoch
        the append must carry, or None when leasing is off."""
        if self.lease_owner is None:
            return None
        key = (workflow, p)
        if key in self._fenced:
            self.fenced_writes += 1
            raise FencedWrite(
                "partition %d of %r: %r is fenced (lease superseded); "
                "writes stay rejected until re-assignment"
                % (p, workflow, self.lease_owner))
        epoch = self._lease_epochs.get(key)
        if epoch is None:
            return self._acquire_lease_locked(workflow, p)
        hook = self.lease_skew_hook
        if hook is not None and hook(workflow, p):
            self._fence(workflow, p,
                        "lease expired under injected clock skew")
        cur = self._read_lease(workflow, p)
        if cur.get("epoch") != epoch or cur.get("owner") != self.lease_owner:
            self._fence(workflow, p, "superseded by %s@e%s"
                        % (cur.get("owner"), cur.get("epoch")))
        if float(cur.get("expires", 0.0)) < time.time():
            # expired but unclaimed: renew in place (same epoch — only an
            # acquisition by another node moves the epoch)
            cur["expires"] = time.time() + self.lease_ttl
            self._write_lease(workflow, p, cur)
        return epoch

    def create_stream(self, workflow: str,
                      num_partitions: Optional[int] = None) -> None:
        if num_partitions is not None:
            if num_partitions < 1:
                raise ValueError("num_partitions must be >= 1")
            with self._lock:
                fps = self._fps.get(workflow)
                if fps is not None and len(fps) != num_partitions:
                    raise ValueError(
                        "stream %r already open with %d partitions, "
                        "create_stream asked for %s"
                        % (workflow, len(fps), num_partitions))
                d = self._wf_dir(workflow)
                if not os.path.isdir(d):
                    # the pin must be visible the instant the directory is:
                    # stage the dir WITH stream.json inside and rename it
                    # into place, so no observer (this process's autoscaler
                    # tick included) can ever see a pinned stream's dir
                    # without its pin and cache the bus default instead
                    tmp_d = d + ".%d.tmp" % os.getpid()
                    os.makedirs(tmp_d, exist_ok=True)
                    with open(os.path.join(tmp_d, "stream.json"), "w") as f:
                        json.dump({"num_partitions": num_partitions}, f)
                        f.flush()
                        # a power cut between the rename below and the disk
                        # writing the pin would leave the stream dir visible
                        # with an empty stream.json — every process would
                        # silently route by the bus default
                        # tfcheck: allow[lock-discipline] one-time stream creation; the pin must be durable before the rename publishes the dir
                        os.fsync(f.fileno())
                    try:
                        os.rename(tmp_d, d)
                        # the rename-into-place is the stream's creation
                        # event: fsync the parent so a crash right after
                        # cannot lose the directory entry (and the pin in it)
                        fsync_dir(self.root)
                    except OSError:  # lost the creation race: verify below
                        shutil.rmtree(tmp_d, ignore_errors=True)
                # re-read the effective pin from disk (ours, or a racing
                # creator's) and refuse a silent mismatch
                self._np.pop(workflow, None)
                pinned = self.num_partitions_for(workflow)
                if pinned != num_partitions:
                    raise ValueError(
                        "stream %r is pinned to %s partitions, create_stream "
                        "asked for %s" % (workflow, pinned, num_partitions))
                if self._rep is not None:
                    # the pin must survive host loss too: without it a
                    # restored root would fall back to the bus default and
                    # misroute every subject
                    self._rep.ship_put(
                        self._stream_meta_path(workflow),
                        json.dumps({"num_partitions": pinned}))
        self._parts(workflow)

    def workflows(self) -> List[str]:
        with self._lock:
            known = set(self._fps.keys())
        if os.path.isdir(self.root):
            known.update(
                d for d in os.listdir(self.root)
                if os.path.isdir(os.path.join(self.root, d)))
        return sorted(known)

    # -- per-partition primitives ----------------------------------------------
    def _have(self, workflow: str) -> bool:
        return workflow in self._fps or os.path.isdir(self._wf_dir(workflow))

    def _publish_p(self, workflow: str, p: int, events: List[CloudEvent]) -> None:
        fp = self._parts(workflow)[p]
        with fp.shard.lock, self._plock(fp):
            # scan_log before appending is mandatory: log_off must sit at the
            # true parseable EOF or _append_clean would chop foreign records
            fp.sync()
            fp.log_off = self._append_batch_clean(fp.log, fp.log_off, events)
            committed = fp.shard.committed_ids
            live = [e for e in events if e.id not in committed]
            if live:
                fp.shard.publish(live)
        self._bump_notify(workflow)

    def _consume_p(self, workflow: str, p: int, max_events: int) -> List[CloudEvent]:
        fp = self._parts(workflow)[p]
        with fp.shard.lock:
            fp.sync()
            return fp.shard.consume(max_events)

    def consume_partitions(
        self, workflow: str, partitions: Iterable[int], max_events: int = 512
    ) -> List[CloudEvent]:
        """The consumer hot path, syscall-gated: ONE stat on the workflow's
        publish-notify counter decides whether any partition log needs
        re-probing; otherwise events come straight from the mirrors (the
        periodic full sync inside ``_FilePartition.sync`` still bounds
        committed/DLQ staleness and backstops a publisher that died between
        its append and its notify bump)."""
        if not self._have(workflow):
            return []
        probe_logs = self._notify_changed(workflow)
        parts = self._parts(workflow)
        out: List[CloudEvent] = []
        budget = max_events
        for p in partitions:
            if budget <= 0:
                break
            fp = parts[p]
            with fp.shard.lock:
                fp.sync(scan_log=probe_logs or fp.last_full == 0.0)
                got = fp.shard.consume(budget)
            out.extend(got)
            budget -= len(got)
        return out

    def _commit_p(self, workflow: str, p: int, ids: set) -> int:
        fp = self._parts(workflow)[p]
        with fp.shard.lock:
            # cheap miss, zero syscalls: committed ids were consumed from
            # this very mirror, so "none of them pending here" is exact
            if not ids & fp.shard.pending_ids:
                return 0
            with self._plock(fp):
                fp.sync(full=True)
                mine = ids & fp.shard.pending_ids
                if not mine:
                    return 0
                epoch = self._check_lease(workflow, p)
                fp.com_off = self._append_clean(
                    fp.com, fp.com_off,
                    [_encode_commit_line(i, epoch) for i in sorted(mine)])
                return fp.shard.commit(mine)

    def _lag_p(self, workflow: str, p: int) -> int:
        fp = self._parts(workflow)[p]
        with fp.shard.lock:
            fp.sync()
            return fp.shard.lag()

    def _probe_lag(self, fp: _FilePartition, probe: bool) -> int:
        """One partition's lag after a gated sync: the event log is only
        re-scanned when the notify counter said something was published (or
        on the partition's very first look); commits (which don't bump the
        counter) surface through the periodic full sync, so a drain-watcher
        polling lag converges within FULL_SYNC_INTERVAL."""
        with fp.shard.lock:
            fp.sync(scan_log=probe or fp.last_full == 0.0)
            return fp.shard.lag()

    def lag_partitions(self, workflow: str, partitions: Iterable[int]) -> int:
        """Like the consume path, syscall-gated: one notify stat decides
        whether any partition log needs probing (see ``_probe_lag``)."""
        if not self._have(workflow):
            return 0
        probe = self._notify_changed(workflow)
        parts = self._parts(workflow)
        return sum(self._probe_lag(parts[p], probe) for p in partitions)

    #: Even a cached-drained ``lag()`` re-sweeps at least this often: the
    #: append and its notify bump are not atomic across processes (a writer
    #: can die between them, and the counter's periodic truncation can alias
    #: a regrown size), so the cached 0 is only *almost* exact.  The backstop
    #: bounds how long such an orphan publish can hide; amortized, an idle
    #: tick still costs ~1 stat.
    LAG_BACKSTOP_INTERVAL = 1.0

    def lag(self, workflow: str) -> int:
        """Whole-stream lag, publish-notify-gated end to end: once a stream
        is observed drained, an idle poll answers with ONE stat on the notify
        counter — no per-partition syncs or ledger probes.  Lag only grows
        via publish/redrive, and both bump the counter *after* their flocked
        append, so an unchanged counter plus a cached 0 means drained — up
        to the non-atomicity of append+bump, which the periodic
        ``LAG_BACKSTOP_INTERVAL`` full sweep covers.  Any other state
        re-scans (commits by shard processes only ever shrink lag, and the
        scan keeps running until the drained 0 is observed and re-cached).
        This is what keeps an idle autoscaler tick O(1) instead of
        O(partitions)."""
        if not self._have(workflow):
            return 0
        probe = self._notify_changed(workflow)
        now = time.monotonic()
        if not probe and self._lag_cache.get(workflow) == 0 and \
                now - self._lag_verified.get(workflow, 0.0) < \
                self.LAG_BACKSTOP_INTERVAL:
            return 0
        total = sum(self._probe_lag(fp, probe)
                    for fp in self._parts(workflow))
        self._lag_cache[workflow] = total
        self._lag_verified[workflow] = now
        return total

    def partition_lags(self, workflow: str) -> List[int]:
        if not self._have(workflow):
            return [0] * self.num_partitions_for(workflow)
        probe = self._notify_changed(workflow)
        return [self._probe_lag(fp, probe) for fp in self._parts(workflow)]

    def _dlq_size_p(self, workflow: str, p: int) -> int:
        fp = self._parts(workflow)[p]
        with fp.shard.lock:
            fp.sync(scan_log=False)
            return fp.shard.dlq_size()

    def _redrive_p(self, workflow: str, p: int, reasons=None) -> int:
        fp = self._parts(workflow)[p]
        with fp.shard.lock, self._plock(fp):
            fp.sync(full=True)
            if not fp.shard.dlq_size():
                return 0
            epoch = self._check_lease(workflow, p)
            marker = dict(_REDRIVE_MARKER)
            if reasons is not None:
                marker["reasons"] = list(reasons)
            if epoch is not None:
                marker["epoch"] = epoch
            n = fp.shard.redrive(reasons)
            if not n:
                return 0
            # Ledger marker goes in regardless of how many matched on *this*
            # mirror — other mirrors replay the same selection against their
            # own state.
            fp.dlq_off = self._append_clean(
                fp.dlq, fp.dlq_off, [json.dumps(marker)])
            fp.dlq_ids = {e.id for e in fp.shard.dlq}
        self._bump_notify(workflow)
        return n

    def _dlq_by_reason_p(self, workflow: str, p: int) -> Dict[str, int]:
        fp = self._parts(workflow)[p]
        with fp.shard.lock:
            fp.sync(scan_log=False)
            return fp.shard.dlq_by_reason()

    def _to_dlq_p(self, workflow: str, p: int, event: CloudEvent) -> None:
        fp = self._parts(workflow)[p]
        with fp.shard.lock, self._plock(fp):
            fp.sync(full=True)
            self._check_lease(workflow, p)
            # truncate BEFORE sniffing the format (see _append_batch_clean):
            # a sub-magic repair truncate can flip the active format
            fp.dlq.truncate(fp.dlq_off)
            if fp.dlq.active_format() == "tfb1":
                rec = codec.encode_frame_payload([event])
            else:
                rec = event.to_json()  # legacy ledger shape: one event dict
            fp.dlq_off += fp.dlq.append([rec])
            fp.dlq_ids.add(event.id)
            fp.shard.to_dlq(event)

    def _is_committed_p(self, workflow: str, p: int, event_id: str) -> bool:
        fp = self._parts(workflow)[p]
        with fp.shard.lock:
            fp.sync(full=True)
            return fp.shard.is_committed(event_id)

    def _commit_offset_p(self, workflow: str, p: int) -> int:
        fp = self._parts(workflow)[p]
        with fp.shard.lock:
            fp.sync(full=True)
            return fp.shard.commit_offset()

    def _committed_events_p(self, workflow: str, p: int) -> List[CloudEvent]:
        fp = self._parts(workflow)[p]
        with fp.shard.lock:
            fp.sync(full=True)
            return fp.shard.committed_events()

    # -- replication surface + host-loss recovery ------------------------------
    def replica_lags(self, workflow: str) -> List[int]:
        """Per-partition unacked replication bytes (shipped by THIS process
        minus acked by the replica).  Zeros when replication is off."""
        n = self.num_partitions_for(workflow)
        out = [0] * n
        if self._rep is None:
            return out
        wfd = workflow.replace("/", "_")
        for rel, lag in self._rep.lag_by_rel().items():
            head, _, fn = rel.rpartition(os.sep)
            if os.path.basename(head) == wfd and fn.startswith("p") \
                    and fn[1:5].isdigit():
                p = int(fn[1:5])
                if p < n:
                    out[p] += lag
        return out

    def replication_stats(self) -> Dict[str, int]:
        if self._rep is None:
            return {"ships": 0, "errors": 0, "lag_bytes": 0}
        return {"ships": self._rep.ships, "errors": self._rep.errors,
                "lag_bytes": self._rep.replica_lag_bytes()}

    def drain_replication(self, timeout: float = 10.0) -> bool:
        """Wait for every shipped frame to be acked; True if drained."""
        if self._rep is None:
            return True
        return self._rep.drain(timeout)

    def heal_replication(self, workflow: str) -> None:
        """Force-reconcile the replica with the local files: ship a
        zero-length append at each segment's local EOF — a gap (e.g. from a
        dropped frame whose file was never appended to again) NACKs and
        heals from the local file."""
        if self._rep is None:
            return
        d = self._wf_dir(workflow)
        if not os.path.isdir(d):
            return
        for fn in sorted(os.listdir(d)):
            if fn.rpartition(".")[2] in ("log", "committed", "dlq"):
                path = os.path.join(d, fn)
                self._rep.ship_append(path, os.path.getsize(path), "")

    def restore_from_replica(self, workflow: str, replica_root: str) -> int:
        """Host-loss recovery: rebuild the workflow's segment root from a
        replica root (same layout, written by a ``ReplicaServer``).

        Copies the replica's files into place, then drops every in-memory
        mirror/cache so the next access replays the restored segments from
        offset zero through the ordinary torn-tail-tolerant ``sync`` path —
        recovery IS the crash-replay path, just fed from the replica's
        bytes.  Lease memory for the workflow is dropped too: ownership
        comes back only through explicit re-acquisition (epoch bump).
        Returns the number of bytes restored."""
        src = os.path.join(os.path.abspath(replica_root),
                           workflow.replace("/", "_"))
        dst = self._wf_dir(workflow)
        restored = 0
        with self._lock:
            fps = self._fps.pop(workflow, None)
            if fps:
                for fp in fps:
                    for seg in (fp.log, fp.com, fp.dlq):
                        seg.reset()
                    try:
                        fp.lockf.close()
                    except OSError:  # pragma: no cover
                        pass
            fd = self._notify_fd.pop(workflow, None)
            if fd is not None:
                try:
                    fd.close()
                except OSError:  # pragma: no cover
                    pass
            self._notify_seen.pop(workflow, None)
            self._lag_cache.pop(workflow, None)
            self._lag_verified.pop(workflow, None)
            for key in [k for k in self._lease_epochs if k[0] == workflow]:
                del self._lease_epochs[key]
            self._fenced = {k for k in self._fenced if k[0] != workflow}
            os.makedirs(dst, exist_ok=True)
            if os.path.isdir(src):
                for fn in sorted(os.listdir(src)):
                    if fn == "pub.notify":
                        continue
                    s = os.path.join(src, fn)
                    if not os.path.isfile(s):
                        continue
                    shutil.copyfile(s, os.path.join(dst, fn))
                    restored += os.path.getsize(s)
            fsync_dir(dst)
        # wake pollers: everything under the workflow changed
        self._bump_notify(workflow)
        return restored
