"""CloudEvents 1.0 subset used by Triggerflow.

The paper (§3.2) matches events to triggers via the ``subject`` field and
describes the event kind via ``type``.  Termination/failure events use
``type`` to notify success (+result) or failure (+error info).  Every event
carries a unique ``id`` used for at-least-once dedup (§3.4).
"""
from __future__ import annotations

import itertools
import os
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from repro_torch.core import codec as _codec

SPECVERSION = "1.0"

# Well-known event types (paper §3.2 / §5).
TYPE_INIT = "event.triggerflow.init"
TYPE_TERMINATION = "event.triggerflow.termination.success"
TYPE_FAILURE = "event.triggerflow.termination.failure"
TYPE_TIMEOUT = "event.triggerflow.timeout"
TYPE_WORKFLOW_END = "event.triggerflow.workflow.end"

_counter = itertools.count()
# Uniqueness must hold across *processes* now that the shard runtime forks
# workers (repro.bus.proc): a forked child inherits the parent's counter
# position, so the prefix carries the pid (plus a random salt against pid
# reuse across restarts) and is re-derived in fork children.
_prefix = f"{os.getpid():x}.{uuid.uuid4().hex[:8]}"


def _reseed_id_prefix() -> None:
    global _prefix
    _prefix = f"{os.getpid():x}.{uuid.uuid4().hex[:8]}"


if hasattr(os, "register_at_fork"):  # not on Windows
    os.register_at_fork(after_in_child=_reseed_id_prefix)


def _new_id() -> str:
    # uuid4-per-event is comparatively expensive; the paper only requires
    # uniqueness, so ids are a per-process prefix + a counter.
    return f"{_prefix}-{next(_counter):x}"


@dataclass(frozen=True)
class CloudEvent:
    """Immutable CloudEvent.  ``subject`` routes to triggers, ``type`` filters."""

    subject: str
    type: str = TYPE_TERMINATION
    data: Any = None
    source: str = "triggerflow"
    id: str = field(default_factory=_new_id)
    time: Optional[float] = None
    specversion: str = SPECVERSION
    # CloudEvents extension attributes (the trace plane's ``tftrace``
    # context lives here — repro.obs.trace).  None for the common untraced
    # event: ``to_dict`` then emits nothing, keeping the bus codec's line
    # format (and its cost) unchanged.
    ext: Optional[Dict[str, Any]] = None

    # The (de)serialization implementations live in repro.core.codec —
    # the single encode and single decode shared by every surface
    # (per-event JSON, batch lines, columnar frames).  Bound below after
    # _codec._install so the hot paths pay no extra call indirection.


# codec needs the class (and its field defaults) to materialize events;
# binding the methods here keeps exactly one implementation of each.
_codec._install(CloudEvent)
CloudEvent.to_dict = _codec.event_to_dict
CloudEvent.to_json = _codec.event_to_json
CloudEvent.from_dict = staticmethod(_codec.event_from_dict)
CloudEvent.from_json = staticmethod(_codec.event_from_json)


def stamp_publish_time(events, now: Optional[float] = None) -> None:
    """Set ``time`` (publish wall clock) on events that lack one — the
    metrics plane's publish→consume lag reads it on the consumer side.
    One ``time()`` call per batch; writes go through ``__dict__`` (frozen
    dataclass, same trick as ``from_dict``)."""
    import time as _time

    t = now if now is not None else _time.time()
    for e in events:
        if e.time is None:
            e.__dict__["time"] = t


def termination_event(subject: str, result: Any = None, **extra: Any) -> CloudEvent:
    data = {"result": result}
    data.update(extra)
    return CloudEvent(subject=subject, type=TYPE_TERMINATION, data=data)


def failure_event(subject: str, error: str, **extra: Any) -> CloudEvent:
    data = {"error": error}
    data.update(extra)
    return CloudEvent(subject=subject, type=TYPE_FAILURE, data=data)
