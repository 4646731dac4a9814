"""Workflow/trigger/context database (paper §4: "A Database, responsible for
storing workflow information, such as triggers, context, etc.").

Checkpointing contract (§3.4): each time a trigger fires, the contexts of all
activated triggers are persisted *before* the consumed events are committed to
the event store.  A restarted worker therefore reloads trigger definitions and
the last checkpointed contexts, and replays uncommitted events on top.

Incremental checkpoints: the worker emits per-trigger *deltas*
(``TriggerContext.take_delta``) via ``put_contexts_delta``.  The durable
store appends them to a per-workflow JSONL context log — one small
append+fsync per checkpoint instead of rewriting every context — and
periodically compacts the log back into the base ``contexts.json``.
``get_contexts`` replays base + log, so crash recovery sees exactly the
state of the last acknowledged checkpoint.
"""
from __future__ import annotations

import json
import os
import threading
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

try:
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX: single-process only
    fcntl = None  # type: ignore[assignment]

from .context import apply_context_delta
from .eventstore import SegmentLog


class StateStore:
    def put_workflow(self, workflow: str, meta: Dict[str, Any]) -> None:
        raise NotImplementedError

    def get_workflow(self, workflow: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def delete_workflow(self, workflow: str) -> None:
        raise NotImplementedError

    def workflows(self) -> List[str]:
        raise NotImplementedError

    def put_trigger(self, workflow: str, trigger_id: str, spec: Dict[str, Any]) -> None:
        raise NotImplementedError

    def put_triggers(self, workflow: str, specs: Dict[str, Dict[str, Any]]) -> None:
        """Persist a batch of trigger specs.  Stores should override this with
        a single atomic write; the default degrades to per-trigger puts."""
        for tid, spec in specs.items():
            self.put_trigger(workflow, tid, spec)

    def get_triggers(self, workflow: str) -> Dict[str, Dict[str, Any]]:
        raise NotImplementedError

    def put_contexts(self, workflow: str, contexts: Dict[str, Dict[str, Any]]) -> None:
        """Atomically persist a batch of trigger contexts (the checkpoint)."""
        raise NotImplementedError

    def put_contexts_delta(self, workflow: str, deltas: Dict[str, Dict[str, Any]]) -> None:
        """Persist a batch of context *deltas* (``TriggerContext.take_delta``
        records).  Default: read-modify-write through ``put_contexts`` so any
        third-party store keeps working; the built-in stores override with
        O(delta) fast paths."""
        stored = self.get_contexts(workflow)
        merged = {
            tid: apply_context_delta(stored.get(tid, {}), delta)
            for tid, delta in deltas.items()
        }
        self.put_contexts(workflow, merged)

    def get_contexts(self, workflow: str) -> Dict[str, Dict[str, Any]]:
        raise NotImplementedError


class MemoryStateStore(StateStore):
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._wf: Dict[str, Dict[str, Any]] = {}
        self._triggers: Dict[str, Dict[str, Dict[str, Any]]] = {}
        self._contexts: Dict[str, Dict[str, Dict[str, Any]]] = {}

    def put_workflow(self, workflow: str, meta: Dict[str, Any]) -> None:
        with self._lock:
            self._wf[workflow] = dict(meta)
            self._triggers.setdefault(workflow, {})
            self._contexts.setdefault(workflow, {})

    def get_workflow(self, workflow: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._wf.get(workflow)

    def delete_workflow(self, workflow: str) -> None:
        with self._lock:
            self._wf.pop(workflow, None)
            self._triggers.pop(workflow, None)
            self._contexts.pop(workflow, None)

    def workflows(self) -> List[str]:
        with self._lock:
            return list(self._wf.keys())

    def put_trigger(self, workflow: str, trigger_id: str, spec: Dict[str, Any]) -> None:
        with self._lock:
            self._triggers.setdefault(workflow, {})[trigger_id] = spec

    def put_triggers(self, workflow: str, specs: Dict[str, Dict[str, Any]]) -> None:
        with self._lock:
            self._triggers.setdefault(workflow, {}).update(specs)

    def get_triggers(self, workflow: str) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {k: dict(v) for k, v in self._triggers.get(workflow, {}).items()}

    def put_contexts(self, workflow: str, contexts: Dict[str, Dict[str, Any]]) -> None:
        with self._lock:
            store = self._contexts.setdefault(workflow, {})
            for tid, ctx in contexts.items():
                store[tid] = json.loads(json.dumps(ctx))  # deep copy, JSON-safe

    def put_contexts_delta(self, workflow: str, deltas: Dict[str, Dict[str, Any]]) -> None:
        with self._lock:
            store = self._contexts.setdefault(workflow, {})
            # deep-copy the *delta* (isolating the worker's live objects),
            # not the merged state — keeps the checkpoint O(delta).
            safe = json.loads(json.dumps(deltas))
            for tid, delta in safe.items():
                store[tid] = apply_context_delta(store.get(tid, {}), delta)

    def get_contexts(self, workflow: str) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {k: dict(v) for k, v in self._contexts.get(workflow, {}).items()}


class FileStateStore(StateStore):
    """Durable JSON-file state store.

    Layout per workflow directory:

    * ``meta.json`` / ``triggers.json`` — atomic full-file writes.
    * ``contexts.json`` — the compacted context base map.
    * ``contexts.delta[.<scope>].jsonl`` — append-only checkpoint log(s);
      each line is one ``put_contexts_delta`` batch (``{tid: delta, ...}``).
      Readers replay base + every log; a writer's own log is folded back into
      ``contexts.json`` every ``compact_every`` checkpoints, or as soon as it
      exceeds ``compact_bytes`` bytes (whichever hits first; a full
      ``put_contexts`` also compacts).  The byte trigger bounds
      recovery-replay time for long-lived workflows with *large*
      per-checkpoint deltas — a fixed line count alone lets the log grow with
      delta size.  A torn final line from a mid-append crash is ignored on
      replay — its checkpoint was never acknowledged, so the §3.4 contract
      holds and the broker redelivers the corresponding events.

    Multi-process checkpointing (the process shard runtime): each writer
    process constructs its store with a distinct ``scope`` and appends to its
    *own* delta log, so concurrent shard checkpoints never contend on one
    JSONL file (and never interleave mid-line).  Correctness relies on the
    runtime's ownership discipline: between two ``compact()`` points, a given
    trigger id is checkpointed by at most one scope (trigger contexts live
    with their subject-partition owner), so the replay order *across* scope
    logs is immaterial.  The pool folds all logs into the base
    (``compact()``) at every ownership change — rebalance, crash, restart —
    before new owners write.  Cross-process safety uses a per-workflow file
    lock (``state.lock``): appends and reads take it shared, compaction and
    trigger/meta read-modify-writes take it exclusive.
    """

    def __init__(self, root: str, compact_every: int = 256,
                 compact_bytes: Optional[int] = None,
                 scope: Optional[str] = None,
                 replicator=None) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.RLock()
        self.compact_every = compact_every
        self.compact_bytes = compact_bytes
        self.scope = scope
        # host-loss fault domain: a ``repro.bus.replicate.ReplicationClient``
        # rooted at this store's ``root`` — checkpoint delta appends ship as
        # segment frames, atomic JSON writes ship as whole-file puts, so a
        # replica root holds the same recoverable state this disk does
        self.replicator = replicator
        self._delta_lines: Dict[str, int] = {}
        self._delta_bytes: Dict[str, int] = {}
        self._flocks: Dict[str, Any] = {}
        self._own_logs: Dict[str, SegmentLog] = {}

    def _dir(self, wf: str) -> str:
        d = os.path.join(self.root, wf.replace("/", "_"))
        os.makedirs(d, exist_ok=True)
        return d

    @contextmanager
    def _flock(self, workflow: str, exclusive: bool):
        """Cross-process lock on the workflow's state directory.  Shared for
        delta appends / merged reads (they touch disjoint files or read
        atomically-replaced ones), exclusive for compaction and
        read-modify-write of the shared JSON files."""
        if fcntl is None:  # non-POSIX: in-process RLock is all we have
            yield
            return
        f = self._flocks.get(workflow)
        if f is None:
            f = open(os.path.join(self._dir(workflow), "state.lock"), "a")
            self._flocks[workflow] = f
        fcntl.flock(f.fileno(),
                    fcntl.LOCK_EX if exclusive else fcntl.LOCK_SH)
        try:
            yield
        finally:
            fcntl.flock(f.fileno(), fcntl.LOCK_UN)

    def _write(self, path: str, obj: Any) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic
        if self.replicator is not None:
            self.replicator.ship_put(path, json.dumps(obj))

    def _read(self, path: str, default: Any) -> Any:
        if not os.path.exists(path):
            return default
        with open(path) as f:
            return json.load(f)

    def put_workflow(self, workflow: str, meta: Dict[str, Any]) -> None:
        with self._lock:
            self._write(os.path.join(self._dir(workflow), "meta.json"), meta)

    def get_workflow(self, workflow: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            p = os.path.join(self.root, workflow.replace("/", "_"), "meta.json")
            return self._read(p, None)

    def delete_workflow(self, workflow: str) -> None:
        with self._lock:
            f = self._flocks.pop(workflow, None)
            if f is not None:
                f.close()
            own = self._own_logs.pop(workflow, None)
            if own is not None:
                own.reset()
            d = os.path.join(self.root, workflow.replace("/", "_"))
            if os.path.isdir(d):
                for fn in os.listdir(d):
                    os.remove(os.path.join(d, fn))
                os.rmdir(d)
            self._delta_lines.pop(workflow, None)
            self._delta_bytes.pop(workflow, None)

    def workflows(self) -> List[str]:
        with self._lock:
            return [d for d in os.listdir(self.root) if os.path.isdir(os.path.join(self.root, d))]

    def put_trigger(self, workflow: str, trigger_id: str, spec: Dict[str, Any]) -> None:
        self.put_triggers(workflow, {trigger_id: spec})

    def put_triggers(self, workflow: str, specs: Dict[str, Dict[str, Any]]) -> None:
        """One read + one atomic write for the whole batch (the worker's
        dirty-trigger checkpoint), instead of a rewrite+fsync per trigger.
        Exclusive-locked: concurrent shard processes each persisting their
        dirty triggers must not lose each other's read-modify-write."""
        with self._lock, self._flock(workflow, exclusive=True):
            p = os.path.join(self._dir(workflow), "triggers.json")
            triggers = self._read(p, {})
            triggers.update(specs)
            self._write(p, triggers)

    def get_triggers(self, workflow: str) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            p = os.path.join(self.root, workflow.replace("/", "_"), "triggers.json")
            return self._read(p, {})

    # -- contexts: compacted base + append-only delta log(s) -------------------
    def _base_path(self, wf_dir: str) -> str:
        return os.path.join(wf_dir, "contexts.json")

    def _own_log_name(self) -> str:
        return ("contexts.delta.%s.jsonl" % self.scope.replace("/", "_")
                if self.scope else "contexts.delta.jsonl")

    def _own_log(self, workflow: str, wf_dir: str) -> SegmentLog:
        log = self._own_logs.get(workflow)
        if log is None:
            log = SegmentLog(os.path.join(wf_dir, self._own_log_name()))
            log.replicator = self.replicator
            self._own_logs[workflow] = log
        return log

    def _all_logs(self, wf_dir: str) -> List[SegmentLog]:
        if not os.path.isdir(wf_dir):
            return []
        names = sorted(
            fn for fn in os.listdir(wf_dir)
            if fn.startswith("contexts.delta") and fn.endswith(".jsonl"))
        logs = [SegmentLog(os.path.join(wf_dir, fn)) for fn in names]
        for log in logs:
            # compaction removals mirror too — other scopes' logs are
            # dropped on the replica when the compactor drops them locally
            log.replicator = self.replicator
        return logs

    def _merged_contexts(self, wf_dir: str) -> Dict[str, Dict[str, Any]]:
        """Base + every delta log.  Between compaction points a trigger id is
        written by at most one scope (the runtime's ownership discipline), so
        cross-log replay order is immaterial; within a log, append order is
        preserved.  Torn tails (unacknowledged checkpoints) are skipped."""
        contexts = self._read(self._base_path(wf_dir), {})
        for log in self._all_logs(wf_dir):
            for batch in log.scan(json.loads)[0]:
                for tid, delta in batch.items():
                    contexts[tid] = apply_context_delta(
                        contexts.get(tid, {}), delta)
        return contexts

    def _compact_locked(self, workflow: str, wf_dir: str,
                        extra: Optional[Dict[str, Dict[str, Any]]] = None) -> None:
        """Fold base + all delta logs (+ ``extra``) into the base and drop the
        logs.  Caller holds the exclusive flock.  Idempotent on crash between
        the base write and a log removal: deltas are full-value records, so
        replaying an already-folded log is harmless."""
        contexts = self._merged_contexts(wf_dir)
        if extra:
            contexts.update(extra)
        self._write(self._base_path(wf_dir), contexts)
        own = self._own_logs.get(workflow)
        for log in self._all_logs(wf_dir):
            if own is not None and log.path == own.path:
                own.remove()  # drop cached handles with the inode
            else:
                log.remove()
        self._delta_lines[workflow] = 0
        self._delta_bytes[workflow] = 0

    def compact(self, workflow: str) -> None:
        """Fold every scope's delta log into the compacted base.  The process
        shard runtime calls this at each ownership boundary (rebalance, crash
        recovery, restart) so that afterwards any scope may checkpoint any
        trigger without cross-log ordering ambiguity."""
        with self._lock, self._flock(workflow, exclusive=True):
            self._compact_locked(workflow, self._dir(workflow))

    def put_contexts(self, workflow: str, contexts: Dict[str, Dict[str, Any]]) -> None:
        with self._lock, self._flock(workflow, exclusive=True):
            self._compact_locked(workflow, self._dir(workflow), extra=contexts)
        if self.replicator is not None and hasattr(self.replicator, "flush"):
            self.replicator.flush()

    def put_contexts_delta(self, workflow: str, deltas: Dict[str, Dict[str, Any]]) -> None:
        with self._lock:
            wf_dir = self._dir(workflow)
            log = self._own_log(workflow, wf_dir)
            record = json.dumps(deltas, separators=(",", ":"))
            with self._flock(workflow, exclusive=False):
                n = self._delta_lines.get(workflow)
                if n is None or log.size() != self._delta_bytes.get(workflow):
                    # First touch after a restart, a failed append, OR a
                    # concurrent compaction (another process folded + removed
                    # our log — detected by the size mismatch, and impossible
                    # to race: their EX flock excludes our SH).  Reopen the
                    # current inode and truncate any torn tail of OUR log
                    # before appending, or later checkpoints would land
                    # beyond it and be silently skipped by every replay.
                    log.reset()
                    n = len(log.repair(json.loads)[0])
                    self._delta_bytes[workflow] = log.size()
                try:
                    written = log.append([record])
                except Exception:
                    # the append may have landed partially: force a repair
                    # pass before the next append truncates the torn fragment
                    self._delta_lines.pop(workflow, None)
                    raise
                self._delta_lines[workflow] = n + 1
                nbytes = self._delta_bytes.get(workflow, 0) + written
                self._delta_bytes[workflow] = nbytes
            if self._delta_lines[workflow] >= self.compact_every or (
                    self.compact_bytes is not None
                    and nbytes >= self.compact_bytes):
                # lock upgrade is release-then-acquire; _compact_locked
                # re-reads everything under the exclusive lock, so a
                # concurrent compaction in the gap is benign.
                with self._flock(workflow, exclusive=True):
                    self._compact_locked(workflow, wf_dir)
            if self.replicator is not None and \
                    hasattr(self.replicator, "flush"):
                # checkpoint-before-commit extends to the replica: the
                # delta must be *sent* before the caller commits the events
                # it covers through the (separate) bus client, or a host
                # loss strands a committed event with no checkpointed result
                self.replicator.flush()

    def get_contexts(self, workflow: str) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            wf_dir = os.path.join(self.root, workflow.replace("/", "_"))
            if not os.path.isdir(wf_dir):
                return {}
            with self._flock(workflow, exclusive=False):
                return self._merged_contexts(wf_dir)
