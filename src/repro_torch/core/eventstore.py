"""At-least-once event stores + Dead Letter Queue (paper §3.4, §4.2).

The contract every store implements (mirroring Kafka/Redis-Streams usage in
the paper):

* ``publish`` appends events to a per-workflow stream.
* ``consume`` returns *uncommitted* events in arrival order.  Events may be
  re-delivered after a crash/restart (at-least-once) — consumers must dedup
  by event id and tolerate reordering.
* ``commit`` marks events processed; committed events are never re-delivered.
* A per-workflow DLQ holds events whose trigger is currently disabled
  (out-of-order sequences, §3.4); they are re-enqueued on ``redrive``.

Two backends: in-memory (fast path, Table 1 load tests) and a durable
append-only JSONL file store (crash/restart fault tolerance, Fig 13).
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional

try:
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX: single-process only
    fcntl = None  # type: ignore[assignment]

from . import codec
from .events import CloudEvent, stamp_publish_time


class StreamShard:
    """One totally-ordered stream: the commit/DLQ primitive.

    This is the unit both ``MemoryEventStore`` (one shard per workflow) and
    ``repro.bus.PartitionedEventStore`` (one shard per workflow *partition*)
    are built from.  Not thread-safe on its own — the owning store serializes
    access.

    * the pending log — an append-only list with a consume ``head`` offset
      (compacted periodically); ``consume`` peeks without removing
      (at-least-once: events stay until committed).
    * ``commit`` — removes events and records them in commit order.  The
      common case — a worker committing exactly the batch it consumed — is a
      single C-level slice/set comparison + bulk set/list update (O(batch)
      with no per-event interpreter work); ids committed out of arrival order
      (events skipped into the DLQ mid-batch, grouped batch-plane commits
      interleaved with sink events) fall back to a per-event prefix walk and
      finally an O(pending) scan.
    * ``dlq`` — quarantine for events whose trigger is disabled (§3.4);
      ``redrive`` re-appends them to the stream.
    * ``lock`` — carried but never taken here: the owning store decides the
      locking granularity (``MemoryEventStore`` serializes whole-store,
      ``PartitionedEventStore`` stripes on exactly this per-shard lock so
      independent partitions never contend).
    """

    __slots__ = ("_log", "head", "pending_ids", "committed_ids",
                 "_committed_log", "dlq", "_has_dups", "lock")

    #: Compact the consumed prefix of the log once it exceeds this length.
    COMPACT_AT = 8192

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self._log: List[CloudEvent] = []
        self.head = 0  # index of the first uncommitted event in _log
        self.pending_ids: set = set()
        self.committed_ids: set = set()
        self._committed_log: List[CloudEvent] = []  # commit order
        self.dlq: deque = deque()
        # True while the log may hold two copies of one id (a broker-style
        # redelivery via re-publish).  Only then do consume/commit pay the
        # dedup-filtering slow path.
        self._has_dups = False

    def _compact(self) -> None:
        if self.head >= self.COMPACT_AT:
            del self._log[:self.head]
            self.head = 0

    def publish(self, events: Iterable[CloudEvent]) -> None:
        events = list(events)
        if self.dlq:
            # Quarantine is sticky by id: a re-published copy of a DLQ'd
            # event (e.g. a replayed producer re-emitting a poison child)
            # never re-enters the stream — only redrive() can.  Mirrors the
            # durable store's replay filter, which skips dlq_ids.
            dlq_ids = {e.id for e in self.dlq}
            events = [e for e in events if e.id not in dlq_ids]
            if not events:
                return
        self._log.extend(events)
        ids = [e.id for e in events]
        pids = self.pending_ids
        before = len(pids)
        pids.update(ids)
        # C-level dup detection: re-published pending ids, duplicates within
        # the batch, or a copy of an already-committed id.
        if len(pids) - before != len(ids) or not self.committed_ids.isdisjoint(ids):
            self._has_dups = True

    def consume(self, max_events: int) -> List[CloudEvent]:
        batch = self._log[self.head:self.head + max_events]
        if self._has_dups and batch:
            committed = self.committed_ids
            batch = [e for e in batch if e.id not in committed]
        return batch

    def commit_prefix(self, event_ids: set) -> int:
        """Commit the in-order head of the stream that is in ``event_ids``.
        O(committed) — the common case, since consumers process in order.
        Duplicate copies of an already-committed id are consumed from the log
        but committed (logged/counted) only once."""
        log = self._log
        head = self.head
        end = len(log)
        cids = self.committed_ids
        clog = self._committed_log
        n = 0
        while head < end:
            e = log[head]
            eid = e.id
            if eid not in event_ids:
                break
            if eid not in cids:
                cids.add(eid)
                clog.append(e)
                n += 1
            head += 1
        if head != self.head:
            self.pending_ids.difference_update(
                e.id for e in log[self.head:head])
            self.head = head
            self._compact()
        return n

    def commit_scan(self, event_ids: set) -> int:
        """Commit out-of-order ids (events skipped mid-stream, e.g. after a
        DLQ quarantine).  O(pending) — the rare fallback."""
        leftover = event_ids & self.pending_ids
        if not leftover:
            return 0
        n = 0
        keep: List[CloudEvent] = []
        cids = self.committed_ids
        clog = self._committed_log
        for e in self._log[self.head:]:
            if e.id in leftover:
                # duplicate copies are dropped but committed only once
                if e.id not in cids:
                    cids.add(e.id)
                    clog.append(e)
                    n += 1
            else:
                keep.append(e)
        self.pending_ids.difference_update(leftover)
        self._log = keep
        self.head = 0
        return n

    def commit(self, event_ids) -> int:
        """Commit the given ids (ids not pending in this shard are ignored).
        Returns the number of events actually committed here."""
        ids = event_ids if isinstance(event_ids, set) else set(event_ids)
        k = len(ids)
        head = self.head
        log = self._log
        # Bulk fast path: the batch is exactly the next k pending events (in
        # any order).  One slice + two C-level set ops + list extend: no
        # per-event interpreter work at all.
        if k and not self._has_dups and head + k <= len(log):
            batch = log[head:head + k]
            if {e.id for e in batch} == ids:
                self.committed_ids.update(ids)
                self._committed_log.extend(batch)
                self.pending_ids.difference_update(ids)
                self.head = head + k
                self._compact()
                return k
        n = self.commit_prefix(ids)
        if n < k:
            n += self.commit_scan(ids)
        if self._has_dups:
            # Purge surviving copies of committed ids so UNCOMMITTED_ONLY
            # consumers are never handed a committed event again.
            committed = self.committed_ids
            tail = [e for e in self._log[self.head:] if e.id not in committed]
            self._log = tail
            self.head = 0
            self.pending_ids = {e.id for e in tail}
            self._has_dups = len(self.pending_ids) != len(tail)
        return n

    def is_committed(self, event_id: str) -> bool:
        return event_id in self.committed_ids

    def lag(self) -> int:
        return len(self._log) - self.head

    def commit_offset(self) -> int:
        """Monotone per-shard commit offset (Kafka-consumer-group analogue)."""
        return len(self._committed_log)

    def to_dlq(self, event: CloudEvent) -> None:
        # Idempotent by id: a batch holding two copies of one poison event
        # quarantines it once (same dedup discipline commit applies).
        if not any(e.id == event.id for e in self.dlq):
            self.dlq.append(event)
        if event.id in self.pending_ids:
            self.pending_ids.discard(event.id)
            self._log = [e for e in self._log[self.head:] if e.id != event.id]
            self.head = 0

    def redrive(self, reasons=None) -> int:
        """Move DLQ events back into the stream; ``reasons`` (iterable of DLQ
        reason strings) restricts the move — poison quarantines stay put when
        the caller redrives only ``disabled`` entries.  Returns moved count."""
        if not self.dlq:
            return 0
        if reasons is None:
            moved_all = list(self.dlq)
            self.dlq.clear()  # before publish: quarantined ids are filtered
            self.publish(moved_all)
            return len(moved_all)
        from .policy import reason_matches
        moved = [e for e in self.dlq if reason_matches(e, reasons)]
        if moved:
            kept = [e for e in self.dlq if not reason_matches(e, reasons)]
            self.dlq.clear()
            self.dlq.extend(kept)
            self.publish(moved)
        return len(moved)

    def dlq_size(self) -> int:
        return len(self.dlq)

    def dlq_by_reason(self) -> Dict[str, int]:
        from .policy import dlq_reason
        out: Dict[str, int] = {}
        for e in self.dlq:
            r = dlq_reason(e)
            out[r] = out.get(r, 0) + 1
        return out

    def committed_events(self) -> List[CloudEvent]:
        return list(self._committed_log)


def fsync_dir(path: str) -> None:
    """fsync a directory so a freshly-created (or renamed-in) entry survives
    a crash: on journaling filesystems the file's *data* fsync does not imply
    the directory entry reached disk."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - non-POSIX / transient
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class SegmentLog:
    """Append-only record segment: the durable log primitive.

    Two on-disk formats, decided *per file* (never mixed within one):

    * ``v1`` — one text record per line (the original JSONL format).
    * ``tfb1`` — binary: the file starts with ``codec.MAGIC``
      (``TFB1\\x00``) and each record is length-prefixed + crc32-framed
      (``repro.core.codec``).  Records may be arbitrary bytes — the
      event stores put whole columnar batch frames in them.

    ``binary=True`` sets the *preferred* format: it applies only when this
    instance appends to an empty (or brand-new) file.  A non-empty file's
    format is sniffed from its first bytes and always wins, so existing v1
    segments keep replaying — and keep receiving v1 appends — unchanged.

    This is the shared building block of ``FileEventStore``, the
    partitioned file bus (``repro.bus.FilePartitionedEventStore``:
    per-partition event/committed/DLQ segments) and the state store's
    checkpoint delta logs.

    Torn-tail contract (crash mid-append, §3.4): a write that never completed
    was never acknowledged, so readers must not see it.  ``scan`` consumes
    only *whole* records whose ``parse`` succeeds and stops (without
    advancing) at the first torn or unparseable record — for ``tfb1`` that
    means a truncation at *any* byte offset (mid-varint, mid-crc,
    mid-payload) recovers exactly the prefix of whole crc-valid records.
    ``repair`` truncates such a tail so later appends cannot land beyond it
    and masquerade as part of a valid record.  Writers must ``repair``
    before their first append to a segment they did not create (the owning
    store does this once per open).

    Offsets are byte offsets in both formats (``scan`` works on raw bytes;
    v1 lines decode per record), so callers can persist them format-blind.

    File handles persist across calls (``open`` costs ~ms under syscall
    sandboxes): one lazily-opened append handle, one read handle.  They stay
    valid across truncation and cross-process appends (same inode); a caller
    that *removes* the file must go through ``remove`` so both are dropped.
    """

    __slots__ = ("path", "fsync", "binary", "_format", "_rf", "_af",
                 "append_count", "append_seconds", "replicator", "_dir_dirty")

    def __init__(self, path: str, fsync: bool = True,
                 binary: bool = False) -> None:
        self.path = path
        self.fsync = fsync
        self.binary = binary
        self._format: Optional[str] = None  # sniffed lazily; None = unknown
        self._rf = None
        self._af = None
        # Append accounting for the metrics plane (appends are the store's
        # fsync boundary — tf_log_appends_total / tf_log_append_seconds_total
        # in the shard scrape).  Two perf_counter reads per append, which is
        # already a flush(+fsync) syscall — noise-level overhead.
        self.append_count = 0
        self.append_seconds = 0.0
        # Optional replication sink (repro.bus.replicate): called after each
        # durable local mutation with the byte range / new size, so a replica
        # root can mirror the segment.  Local durability always comes first —
        # the ship happens after flush+fsync.
        self.replicator = None
        self._dir_dirty = False

    def size(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def active_format(self) -> str:
        """The file's format (``"v1"`` | ``"tfb1"``).  Sniffed from the
        first bytes and cached; an empty (or absent) file answers with this
        instance's *preferred* format without caching — the file only
        commits to a format once bytes land in it.  A 1–4 byte file (e.g. a
        magic header torn by a crash) counts as v1: the text scan finds no
        whole line, so ``repair`` truncates it to empty and the preference
        re-applies."""
        fmt = self._format
        if fmt is None:
            try:
                with open(self.path, "rb") as f:
                    head = f.read(len(codec.MAGIC))
            except OSError:
                head = b""
            if not head:
                return "tfb1" if self.binary else "v1"
            fmt = self._format = "tfb1" if head == codec.MAGIC else "v1"
        return fmt

    def _close(self) -> None:
        for f in (self._rf, self._af):
            if f is not None:
                try:
                    f.close()
                except OSError:  # pragma: no cover
                    pass
        self._rf = self._af = None

    def reset(self) -> None:
        """Drop the cached handles.  Writers sharing a path across processes
        call this when they detect the file was removed/recreated under them
        (e.g. a concurrent delta-log compaction) — the next append/scan
        reopens the *current* inode instead of feeding the unlinked one."""
        self._close()
        self._format = None  # the recreated file may use the other format

    def remove(self) -> None:
        """Delete the file (and drop the cached handles, so a later append
        recreates it instead of writing to the unlinked inode)."""
        self._close()
        self._format = None
        if os.path.exists(self.path):
            os.remove(self.path)
            if self.replicator is not None:
                self.replicator.ship_remove(self.path)

    def append(self, lines: Iterable) -> int:
        """Append records in the file's active format (flush + optional
        fsync): one line per record on v1 (``str`` records only), one
        length+crc frame per record on tfb1 (``str`` records are framed as
        their utf-8 bytes; ``bytes`` pass through).  A tfb1 append to an
        empty file writes the magic header first.  Returns the number of
        bytes written."""
        t0 = time.perf_counter()
        # binary handle + one explicit encode: the text layer would encode
        # too, and a replicated log would then pay a SECOND full encode in
        # ship_append — this way writer and replicator share the same bytes
        fmt = self.active_format()
        if fmt == "tfb1":
            data = b"".join(
                codec.encode_record(
                    r.encode("utf-8") if isinstance(r, str) else r)
                for r in lines)
            if self.size() == 0:
                data = codec.MAGIC + data
                self._format = "tfb1"
        else:
            data = ("\n".join(lines) + "\n").encode("utf-8")
            if self._format is None:
                self._format = "v1"
        f = self._af
        if f is None:
            if not os.path.exists(self.path):
                # first append creates the file: the directory entry needs
                # its own fsync or a crash right after can lose the file
                # despite the data fsync below (satellite of §3.4 durability)
                self._dir_dirty = True
            f = self._af = open(self.path, "ab")
        f.write(data)
        f.flush()
        if self.fsync:
            os.fsync(f.fileno())
            if self._dir_dirty:
                fsync_dir(os.path.dirname(self.path) or ".")
                self._dir_dirty = False
        self.append_count += 1
        self.append_seconds += time.perf_counter() - t0
        if self.replicator is not None:
            end = f.tell()  # exact even with interleaved O_APPEND writers
            self.replicator.ship_append(self.path, end - len(data), data)
        return len(data)

    def scan(self, parse, offset: int = 0):
        """Parse whole records from ``offset``.  Returns
        ``(records, next_offset)`` where ``next_offset`` is the end of the
        parseable prefix — a torn final record (the append never completed)
        or an unparseable one (a tail that was never repaired) stops the
        scan without advancing past it.

        ``parse`` receives ``str`` lines on a v1 segment (unchanged
        contract) and raw ``bytes`` payloads on a tfb1 segment."""
        size = self.size()
        if size <= offset:
            return [], offset
        fmt = self.active_format()
        f = self._rf
        if f is None:
            try:
                f = self._rf = open(self.path, "rb")
            except OSError:
                return [], offset
        if fmt == "tfb1" and offset < len(codec.MAGIC):
            offset = len(codec.MAGIC)  # skip the sniffed header
            if size <= offset:
                return [], offset
        f.seek(offset)
        chunk = f.read()
        records = []
        valid = offset
        if fmt == "tfb1":
            for payload, end in codec.iter_records(chunk):
                try:
                    records.append(parse(payload))
                except Exception:  # noqa: BLE001 - stop before the frankenrecord
                    # tfcheck: allow[seam-safety] an unparseable payload IS the torn tail: stopping the scan here is the contract, not a swallow
                    break
                valid = offset + end
            return records, valid
        pos = 0
        while True:
            nl = chunk.find(b"\n", pos)
            if nl < 0:
                break
            line = chunk[pos:nl].strip()
            if line:
                try:
                    records.append(parse(line.decode("utf-8")))
                except Exception:  # noqa: BLE001 - frankenline: stop before it
                    # tfcheck: allow[seam-safety] an unparseable line IS the torn tail: stopping the scan here is the contract, not a swallow
                    break
            valid = offset + nl + 1
            pos = nl + 1
        return records, valid

    def truncate(self, size: int) -> None:
        """Drop everything past ``size`` (a known record boundary, e.g. the
        ``next_offset`` of a full ``scan``) so new appends land clean.
        The persistent handles survive: the append handle is in append mode
        (kernel-positioned at EOF per write) and the read handle seeks
        absolutely."""
        if size < self.size():
            with open(self.path, "rb+") as f:
                f.truncate(size)
                f.flush()
                os.fsync(f.fileno())
            if size < len(codec.MAGIC):
                # the (possibly binary) header is gone: the file is free to
                # re-commit to either format on its next append
                self._format = None
            if self.replicator is not None:
                self.replicator.ship_truncate(self.path, size)


    def repair(self, parse):
        """Truncate a torn/unparseable tail (fsynced) so new appends land on
        a clean record boundary.  Returns ``(records, valid_size)``."""
        records, valid = self.scan(parse, 0)
        self.truncate(valid)
        return records, valid


def parse_event_record(rec) -> List[CloudEvent]:
    """Segment-format-blind event-record parse for ``SegmentLog.scan``:
    a v1 line (str) holds one JSON event dict *or* a JSON array of them,
    a tfb1 payload (bytes) holds a columnar batch frame.  Always returns
    a list of events."""
    return codec.events_of(codec.decode_payload(rec))


def append_events(seg: SegmentLog, events) -> int:
    """Append one event batch in ``seg``'s active format: a single
    columnar frame record on tfb1 (one encode for the whole batch — the
    2x-cheaper wire format), one JSON line per event on v1 (the legacy
    layout existing segments keep)."""
    if seg.active_format() == "tfb1":
        return seg.append([codec.encode_frame_payload(events)])
    return seg.append([e.to_json() for e in events])


class EventStore:
    """Interface."""

    def create_stream(self, workflow: str) -> None:
        raise NotImplementedError

    def publish(self, workflow: str, event: CloudEvent) -> None:
        raise NotImplementedError

    def publish_batch(self, workflow: str, events: Iterable[CloudEvent]) -> None:
        for e in events:
            self.publish(workflow, e)

    def consume(self, workflow: str, max_events: int = 512) -> List[CloudEvent]:
        """Return up to ``max_events`` uncommitted events (without removing them)."""
        raise NotImplementedError

    def commit(self, workflow: str, event_ids: Iterable[str]) -> None:
        raise NotImplementedError

    def is_committed(self, workflow: str, event_id: str) -> bool:
        raise NotImplementedError

    def lag(self, workflow: str) -> int:
        """Number of uncommitted events (the KEDA scaling metric)."""
        raise NotImplementedError

    def to_dlq(self, workflow: str, event: CloudEvent) -> None:
        raise NotImplementedError

    def redrive(self, workflow: str, reasons: Optional[Iterable[str]] = None) -> int:
        """Move DLQ events back into the stream.  ``reasons`` restricts the
        move to entries whose quarantine reason matches (legacy entries
        without metadata count as ``disabled``); None moves all.  Returns the
        number moved."""
        raise NotImplementedError

    def dlq_size(self, workflow: str) -> int:
        raise NotImplementedError

    def dlq_by_reason(self, workflow: str) -> Dict[str, int]:
        """DLQ depth broken down by structured quarantine reason."""
        raise NotImplementedError

    def workflows(self) -> List[str]:
        raise NotImplementedError

    def committed_events(self, workflow: str) -> List[CloudEvent]:
        """All committed events in commit order (event-sourcing replay, §5.3)."""
        raise NotImplementedError


class MemoryEventStore(EventStore):
    """One ``StreamShard`` per workflow (the unpartitioned fast path)."""

    #: ``consume`` only returns pending (uncommitted) events — commit removes
    #: them from the stream — so consumers may skip per-event is_committed
    #: round-trips and dedup only against their in-flight set.
    UNCOMMITTED_ONLY = True

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._shards: Dict[str, StreamShard] = {}

    def _shard(self, workflow: str) -> StreamShard:
        s = self._shards.get(workflow)
        if s is None:
            s = self._shards.setdefault(workflow, StreamShard())
        return s

    def create_stream(self, workflow: str) -> None:
        with self._lock:
            self._shard(workflow)

    def publish(self, workflow: str, event: CloudEvent) -> None:
        stamp_publish_time((event,))
        with self._lock:
            self._shard(workflow).publish((event,))

    def publish_batch(self, workflow: str, events: Iterable[CloudEvent]) -> None:
        events = list(events)
        stamp_publish_time(events)
        with self._lock:
            self._shard(workflow).publish(events)

    def consume(self, workflow: str, max_events: int = 512) -> List[CloudEvent]:
        with self._lock:
            s = self._shards.get(workflow)
            return s.consume(max_events) if s is not None else []

    def commit(self, workflow: str, event_ids: Iterable[str]) -> None:
        ids = set(event_ids)
        if not ids:
            return
        with self._lock:
            self._shard(workflow).commit(ids)

    def is_committed(self, workflow: str, event_id: str) -> bool:
        with self._lock:
            s = self._shards.get(workflow)
            return s.is_committed(event_id) if s is not None else False

    def lag(self, workflow: str) -> int:
        with self._lock:
            s = self._shards.get(workflow)
            return s.lag() if s is not None else 0

    def to_dlq(self, workflow: str, event: CloudEvent) -> None:
        with self._lock:
            self._shard(workflow).to_dlq(event)

    def redrive(self, workflow: str, reasons: Optional[Iterable[str]] = None) -> int:
        with self._lock:
            s = self._shards.get(workflow)
            return s.redrive(reasons) if s is not None else 0

    def dlq_size(self, workflow: str) -> int:
        with self._lock:
            s = self._shards.get(workflow)
            return s.dlq_size() if s is not None else 0

    def dlq_by_reason(self, workflow: str) -> Dict[str, int]:
        with self._lock:
            s = self._shards.get(workflow)
            return s.dlq_by_reason() if s is not None else {}

    def workflows(self) -> List[str]:
        with self._lock:
            return list(self._shards.keys())

    def committed_events(self, workflow: str) -> List[CloudEvent]:
        with self._lock:
            s = self._shards.get(workflow)
            return s.committed_events() if s is not None else []


class FileEventStore(EventStore):
    """Durable append-only event log per workflow + committed-id set.

    Layout: ``<root>/<workflow>.log`` (event segment, append-only),
    ``<root>/<workflow>.committed`` (one event id per line, append-only),
    ``<root>/<workflow>.dlq`` (quarantine segment).  A restarted process
    reconstructs the uncommitted set = log - committed, which is exactly the
    paper's "the event broker will send again uncommitted events" recovery
    semantics.

    ``codec`` picks the wire format for *new* event/DLQ segments:
    ``"binary"`` (default) writes TFB1 columnar batch frames, ``"json"``
    the legacy one-JSON-event-per-line layout.  The format of an existing
    segment is sniffed per file and always wins (``SegmentLog``), so a v1
    root replays — and keeps appending — unchanged under either setting.
    The committed log stays line-oriented text in both modes (ids are the
    audit surface).
    """

    #: Like ``MemoryEventStore``: the pending mirror excludes committed ids
    #: (at load, on refresh, and on commit), so consume never re-delivers a
    #: committed event.
    UNCOMMITTED_ONLY = True

    def __init__(self, root: str, codec: str = "binary") -> None:
        self.root = root
        self.codec = codec
        os.makedirs(root, exist_ok=True)
        self._lock = threading.RLock()
        # In-memory mirrors for speed; the segment logs are the source of truth.
        self._pending: Dict[str, deque] = {}
        self._committed_ids: Dict[str, set] = {}
        self._committed_order: Dict[str, List[CloudEvent]] = {}
        self._dlq: Dict[str, deque] = {}
        self._offsets: Dict[str, int] = {}  # log bytes already mirrored
        self._segs: Dict[str, tuple] = {}   # wf -> (log, committed, dlq)
        self._flocks: Dict[str, object] = {}
        for fn in os.listdir(root):
            if fn.endswith(".log"):
                self._load(fn[: -len(".log")])

    @contextmanager
    def _wf_flock(self, workflow: str):
        """Cross-process writer lock per workflow (``<wf>.lock``): appends
        and the torn-tail repair in ``publish_batch`` hold it, so any bytes
        past the parseable prefix under the lock belong to a *dead* writer
        (a live one would be holding the lock) and are safe to truncate."""
        if fcntl is None:  # pragma: no cover - non-POSIX
            yield
            return
        f = self._flocks.get(workflow)
        if f is None:
            safe = workflow.replace("/", "_")
            f = open(os.path.join(self.root, safe + ".lock"), "a")
            self._flocks[workflow] = f
        fcntl.flock(f.fileno(), fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f.fileno(), fcntl.LOCK_UN)

    def refresh(self, workflow: str) -> int:
        """Pick up events appended by *other* store instances sharing the log
        (e.g. a crashed worker's still-running tasks publishing terminations).
        Returns the number of new events mirrored."""
        with self._lock:
            log, _, _ = self._seglogs(workflow)
            batches, off = log.scan(parse_event_record,
                                    self._offsets.get(workflow, 0))
            self._offsets[workflow] = off
            new = [e for b in batches for e in b]
            if not new:
                return 0
            committed = self._committed_ids.get(workflow, set())
            known = {e.id for e in self._pending.get(workflow, ())}
            known |= {e.id for e in self._dlq.get(workflow, ())}
            n = 0
            for ev in new:
                if ev.id in committed or ev.id in known:
                    continue
                self._pending.setdefault(workflow, deque()).append(ev)
                n += 1
            return n

    # -- persistence helpers -------------------------------------------------
    def _paths(self, wf: str):
        safe = wf.replace("/", "_")
        return (
            os.path.join(self.root, f"{safe}.log"),
            os.path.join(self.root, f"{safe}.committed"),
            os.path.join(self.root, f"{safe}.dlq"),
        )

    def _seglogs(self, wf: str):
        segs = self._segs.get(wf)
        if segs is None:
            log_p, com_p, dlq_p = self._paths(wf)
            binary = self.codec == "binary"
            segs = (SegmentLog(log_p, binary=binary), SegmentLog(com_p),
                    SegmentLog(dlq_p, binary=binary))
            self._segs[wf] = segs
        return segs

    def _load(self, wf: str) -> None:
        log, com, dlq_seg = self._seglogs(wf)
        # A torn tail (crash mid-append) was never acknowledged: repair drops
        # it so this instance's appends land on a clean record boundary.
        # Under the writer flock — a tail that merely *looks* torn could be
        # a live writer's in-flight append, and truncating that would
        # destroy an fsync-acknowledged publish.
        with self._wf_flock(wf):
            batches, log_size = log.repair(parse_event_record)
            events = [e for b in batches for e in b]
            committed = set(com.repair(str)[0])
            dlq: deque = deque(
                e for b in dlq_seg.repair(parse_event_record)[0] for e in b)
        by_id = {e.id: e for e in events}
        self._committed_ids[wf] = committed
        self._committed_order[wf] = [by_id[i] for i in committed if i in by_id]
        self._dlq[wf] = dlq
        dlq_ids = {e.id for e in dlq}
        self._pending[wf] = deque(
            e for e in events if e.id not in committed and e.id not in dlq_ids
        )
        self._offsets[wf] = log_size

    # -- EventStore ----------------------------------------------------------
    def create_stream(self, workflow: str) -> None:
        with self._lock:
            if workflow not in self._pending:
                self._pending[workflow] = deque()
                self._committed_ids[workflow] = set()
                self._committed_order[workflow] = []
                self._dlq[workflow] = deque()
                log_p, _, _ = self._paths(workflow)
                existed = os.path.exists(log_p)
                open(log_p, "a").close()
                if not existed:
                    fsync_dir(os.path.dirname(log_p) or ".")

    def publish(self, workflow: str, event: CloudEvent) -> None:
        self.publish_batch(workflow, [event])

    def publish_batch(self, workflow: str, events: Iterable[CloudEvent]) -> None:
        events = list(events)
        if not events:
            return
        stamp_publish_time(events)
        with self._lock:
            self.create_stream(workflow)
            log, _, _ = self._seglogs(workflow)
            with self._wf_flock(workflow):
                self.refresh(workflow)  # mirror foreign appends before ours
                off = self._offsets.get(workflow, 0)
                # Under the writer flock the parseable prefix is exact: any
                # tail past it is a dead writer's torn fragment (never
                # acknowledged — fsync cannot have returned) and must go, or
                # our append would fuse with it into an unparseable line.
                log.truncate(off)
                self._offsets[workflow] = off + append_events(log, events)
            # A re-published copy of a committed id must not re-enter the
            # pending mirror (UNCOMMITTED_ONLY contract); the log append above
            # is harmless — _load filters committed ids on recovery.
            committed = self._committed_ids.get(workflow)
            if committed:
                events = [e for e in events if e.id not in committed]
            self._pending[workflow].extend(events)

    def consume(self, workflow: str, max_events: int = 512) -> List[CloudEvent]:
        with self._lock:
            self.refresh(workflow)
            q = self._pending.get(workflow)
            if not q:
                return []
            n = min(len(q), max_events)
            return [q[i] for i in range(n)]

    def commit(self, workflow: str, event_ids: Iterable[str]) -> None:
        ids = set(event_ids)
        if not ids:
            return
        with self._lock:
            _, com, _ = self._seglogs(workflow)
            with self._wf_flock(workflow):
                com.append(sorted(ids))
            self._committed_ids.setdefault(workflow, set()).update(ids)
            keep = deque()
            for e in self._pending.get(workflow, deque()):
                if e.id in ids:
                    self._committed_order.setdefault(workflow, []).append(e)
                else:
                    keep.append(e)
            self._pending[workflow] = keep

    def is_committed(self, workflow: str, event_id: str) -> bool:
        with self._lock:
            return event_id in self._committed_ids.get(workflow, set())

    def lag(self, workflow: str) -> int:
        with self._lock:
            self.refresh(workflow)
            q = self._pending.get(workflow)
            return len(q) if q else 0

    def to_dlq(self, workflow: str, event: CloudEvent) -> None:
        with self._lock:
            _, _, dlq_seg = self._seglogs(workflow)
            with self._wf_flock(workflow):
                # the batch encoder even for a single event: quarantine and
                # publish share one append shape per format
                append_events(dlq_seg, [event])
            self._dlq.setdefault(workflow, deque()).append(event)
            q = self._pending.get(workflow)
            if q:
                self._pending[workflow] = deque(e for e in q if e.id != event.id)

    def redrive(self, workflow: str, reasons: Optional[Iterable[str]] = None) -> int:
        from .policy import reason_matches

        with self._lock:
            dlq = self._dlq.get(workflow)
            if not dlq:
                return 0
            moved = [e for e in dlq if reason_matches(e, reasons)]
            if not moved:
                return 0
            kept = [e for e in dlq if not reason_matches(e, reasons)]
            self._pending.setdefault(workflow, deque()).extend(moved)
            dlq.clear()
            dlq.extend(kept)
            _, _, dlq_seg = self._seglogs(workflow)
            # The .dlq segment is append-only; a (possibly partial) redrive
            # rewrites it to the survivors so a restart reconstructs the
            # same quarantine set.
            with self._wf_flock(workflow):
                dlq_seg.remove()
                if kept:
                    append_events(dlq_seg, kept)
            return len(moved)

    def dlq_size(self, workflow: str) -> int:
        with self._lock:
            return len(self._dlq.get(workflow, ()))

    def dlq_by_reason(self, workflow: str) -> Dict[str, int]:
        from .policy import dlq_reason

        with self._lock:
            out: Dict[str, int] = {}
            for e in self._dlq.get(workflow, ()):
                r = dlq_reason(e)
                out[r] = out.get(r, 0) + 1
            return out

    def workflows(self) -> List[str]:
        with self._lock:
            return list(self._pending.keys())

    def committed_events(self, workflow: str) -> List[CloudEvent]:
        with self._lock:
            return list(self._committed_order.get(workflow, []))
