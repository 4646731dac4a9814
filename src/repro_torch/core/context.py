"""Per-trigger fault-tolerant Context with computational reflection (§3.2).

The Context is a key-value structure holding trigger state (join counters,
aggregated results, ...).  It also exposes the *introspection/interception*
surface the paper describes:

* read/modify the context of *other* triggers (e.g. a Map action sets the
  expected join count on the downstream aggregation trigger, §5.1/§5.2),
* dynamically add/enable/disable triggers (§5.3 dynamic triggers),
* produce events into the worker's internal event sink so that condition/
  action code can fire downstream triggers (§5.2 sub-state-machine
  termination events),
* access the committed event log for event-sourcing replay (§5.3).

Checkpoint cost is proportional to *change*, not state: mutations are
tracked per key, and ``take_delta`` emits either a full ``replace`` snapshot
(first checkpoint of this context object, or after a bulk mutation) or an
incremental ``{"set": ..., "del": ...}`` record the state store applies as a
log entry (see ``StateStore.put_contexts_delta``).

Persistence contract for condition/action authors: mutate context state via
key **assignment** (``ctx[k] = v`` — the built-in aggregators reassign even
when the object is unchanged, e.g. ``ctx["results"] = results``).  In-place
mutation of a nested value without reassigning its key is invisible to the
dirty tracking and will not be checkpointed (it never reliably was: the old
full-snapshot path only captured such changes as a side effect of *another*
key being dirty).  ``ctx.dirty = True`` forces a full ``replace`` snapshot
at the next checkpoint as an explicit escape hatch.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, List

from .events import CloudEvent

if TYPE_CHECKING:  # pragma: no cover
    from .worker import TFWorker

_MISSING = object()


def jsonable(value: Any) -> Any:
    """JSON-safe view of a context value.  In-memory contexts may hold sets
    (the ``exactly_once`` dedup index); checkpoints serialize them as sorted
    lists so the JSON stores and crash-recovery replay stay deterministic."""
    if isinstance(value, (set, frozenset)):
        return sorted(value)
    return value


class TriggerContext(dict):
    """dict subclass: the JSON-serializable payload *is* the dict content."""

    def __init__(self, data: Dict[str, Any], worker: "TFWorker", trigger_id: str):
        super().__init__(data)
        self._worker = worker
        self.trigger_id = trigger_id
        self.workflow = worker.workflow
        # Delta tracking: which keys changed since the last checkpoint.  The
        # first checkpoint of a fresh context object always emits a full
        # ``replace`` so the store's view never depends on pre-crash deltas.
        self._dirty_keys: set = set()
        self._deleted_keys: set = set()
        self._full_dirty = False
        self._replace_next = True

    # -- mutation tracking (what the checkpoint persists) ---------------------
    @property
    def dirty(self) -> bool:
        return self._full_dirty or bool(self._dirty_keys) or bool(self._deleted_keys)

    @dirty.setter
    def dirty(self, value: bool) -> None:
        if value:
            self._full_dirty = True
        else:
            self._full_dirty = False
            self._dirty_keys.clear()
            self._deleted_keys.clear()

    def __setitem__(self, k, v) -> None:
        self._dirty_keys.add(k)
        self._deleted_keys.discard(k)
        super().__setitem__(k, v)

    def __delitem__(self, k) -> None:
        super().__delitem__(k)
        self._dirty_keys.discard(k)
        self._deleted_keys.add(k)

    def update(self, *a, **kw) -> None:  # type: ignore[override]
        super().update(*a, **kw)
        if a and not isinstance(a[0], dict):
            self._full_dirty = True  # iterable-of-pairs: don't re-walk it
        else:
            keys = set(a[0]) if a else set()
            keys.update(kw)
            self._dirty_keys.update(keys)
            self._deleted_keys.difference_update(keys)

    def setdefault(self, k, default=None):  # type: ignore[override]
        if k not in self:
            self._dirty_keys.add(k)
            self._deleted_keys.discard(k)
        return super().setdefault(k, default)

    def pop(self, k, *a):  # type: ignore[override]
        if k in self:
            self._dirty_keys.discard(k)
            self._deleted_keys.add(k)
        return super().pop(k, *a)

    def clear(self) -> None:  # type: ignore[override]
        self._full_dirty = True
        super().clear()

    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe copy of the full context (full-rewrite checkpoints)."""
        return {k: jsonable(v) for k, v in self.items()}

    def build_delta(self) -> Dict[str, Any]:
        """The pending mutations as a checkpoint delta record (pure read).

        Returns ``{"replace": {...}}`` (authoritative full snapshot) or
        ``{"set": {...}, "del": [...]}``.  Call ``mark_checkpointed`` only
        after the store acknowledged the write — a failed write must leave
        the dirty tracking intact so the delta is re-emitted."""
        if self._replace_next or self._full_dirty:
            return {"replace": self.snapshot()}
        delta: Dict[str, Any] = {}
        changed = {k: jsonable(self[k]) for k in self._dirty_keys if k in self}
        deleted = sorted(k for k in self._deleted_keys if k not in self)
        if changed:
            delta["set"] = changed
        if deleted:
            delta["del"] = deleted
        return delta

    def mark_checkpointed(self) -> None:
        """Reset dirty tracking after the delta was durably persisted."""
        self._replace_next = False
        self._full_dirty = False
        self._dirty_keys.clear()
        self._deleted_keys.clear()

    def take_delta(self) -> Dict[str, Any]:
        """``build_delta`` + ``mark_checkpointed`` in one step (callers that
        persist synchronously and cannot fail in between)."""
        delta = self.build_delta()
        self.mark_checkpointed()
        return delta

    # -- introspection / reflection (paper Def. 5) ----------------------------
    def get_trigger_context(self, trigger_id: str) -> "TriggerContext":
        return self._worker.context_of(trigger_id)

    def add_trigger(self, trigger) -> str:
        """Dynamically register a trigger from inside condition/action code."""
        return self._worker.add_dynamic_trigger(trigger)

    def enable_trigger(self, trigger_id: str) -> None:
        self._worker.set_trigger_enabled(trigger_id, True)

    def disable_trigger(self, trigger_id: str) -> None:
        self._worker.set_trigger_enabled(trigger_id, False)

    def intercept_trigger(self, trigger_id: str, action_spec: Dict[str, Any]) -> None:
        self._worker.intercept(trigger_id, action_spec)

    # -- event production ------------------------------------------------------
    def produce(self, event: CloudEvent) -> None:
        """Emit into the worker's internal sink (processed later this batch)."""
        self._worker.sink(event)

    def produce_batch(self, events: List[CloudEvent]) -> None:
        """Bulk ``produce``: one store append per partition and one commit-log
        write for the whole run (the batched-action fan-out path)."""
        self._worker.sink_batch(list(events))

    def invoke(self, fn_name: str, args: Any, subject: str, **kw) -> None:
        """Asynchronously invoke a registered 'serverless function' (§3.2 Action)."""
        self._worker.backend.invoke(self.workflow, fn_name, args, subject, **kw)

    def timeout(self, subject: str, delay: float, data: Any = None) -> None:
        """Schedule a timeout event via the timer event source (§5.4)."""
        from .events import TYPE_TIMEOUT

        self._worker.timers.after(
            self.workflow, delay, CloudEvent(subject=subject, type=TYPE_TIMEOUT, data=data))

    # -- event sourcing --------------------------------------------------------
    def committed_events(self) -> List[CloudEvent]:
        return self._worker.event_store.committed_events(self.workflow)

    def local_events(self) -> List[CloudEvent]:
        """Events retained in worker memory (native-scheduler fast replay, §6.3.2)."""
        return self._worker.event_log

    def workflow_result(self, value: Any) -> None:
        self._worker.set_result(value)


def apply_context_delta(current: Dict[str, Any], delta: Dict[str, Any]) -> Dict[str, Any]:
    """Apply one ``take_delta`` record to a stored context dict."""
    if "replace" in delta:
        return dict(delta["replace"])
    out = dict(current)
    out.update(delta.get("set", {}))
    for k in delta.get("del", ()):
        out.pop(k, None)
    return out
