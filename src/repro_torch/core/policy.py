"""Failure-policy plane: retry policies, poison quarantine, circuit breakers.

The paper claims Triggerflow "transparently guarantees fault tolerance" for
long-running workflows; PRs 1-6 built the crash/replay half of that claim
(SIGKILL recovery, torn-tail repair, exactly-once commits).  This module is
the *policy* half — what to do when the failure is not the process but the
work itself:

* ``RetryPolicy`` — a per-trigger budget for failed condition/action runs:
  max attempts, exponential backoff with deterministic jitter, and an
  optional per-attempt wall-clock timeout enforced by a watchdog thread.
  Attempt counts live in the trigger's durable context (they ride the
  checkpoint-before-commit path, so they survive SIGKILL and never reset on
  replay).  After budget exhaustion the event is quarantined to the DLQ with
  a structured reason instead of hot-looping the shard.

* DLQ reason taxonomy — quarantined events carry ``ext["tfdlq"]`` metadata
  (reason, attempts, first/last failure timestamps).  ``redrive(reasons=…)``
  filters on it so re-enabling a trigger redrives only ``disabled``
  quarantines and never re-injects poison.

* ``CircuitBreaker`` — per-workflow consecutive-crash-streak tracking for
  the pool runtimes and the autoscaler: restarts back off exponentially
  (first crash restarts free so deliberate ``crash_shard`` recovery stays
  immediate), past a threshold the workflow is circuit-broken (no restarts)
  until a cooldown elapses, then a single half-open probe shard decides
  whether to close the circuit or re-open it.

Everything here is deterministic: backoff jitter is keyed off
``crc32(event_id:attempt)`` — two replays of the same failed event compute
the same schedule, which is what makes the chaos soak replayable.
"""
from __future__ import annotations

import threading
import time
import zlib
from typing import Any, Dict, Iterable, Optional

from .events import CloudEvent

# Reserved context key holding {event_id: [attempts, first_ts, last_ts]} for
# in-flight retries.  It rides put_contexts_delta like any user key, so the
# counter is durable (exactly-once retries across SIGKILL).
RETRY_STATE_KEY = "__attempts__"

# DLQ reason taxonomy.  ``disabled`` is the pre-existing quarantine class
# (event arrived while every matching trigger was disabled) and the default
# for legacy entries without metadata; the ``poison:*`` classes are terminal
# retry-budget exhaustions and are never auto-redriven.
DLQ_META_KEY = "tfdlq"
REASON_DISABLED = "disabled"
REASON_ACTION_ERROR = "poison:action-error"
REASON_TIMEOUT = "poison:timeout"
REASON_CONDITION_ERROR = "poison:condition-error"

# What the worker/pools redrive automatically (on fire progress or trigger
# re-enable).  Poison stays put until an operator redrives explicitly.
AUTO_REDRIVE_REASONS = (REASON_DISABLED,)


class ActionTimeout(Exception):
    """An action exceeded its RetryPolicy.action_timeout budget."""


class RetryPolicy:
    """Per-trigger retry budget with deterministic exponential backoff.

    ``max_attempts`` counts total runs (1 = no retry, fail straight to the
    DLQ).  Backoff for attempt *n* (1-based) is
    ``min(backoff_max, backoff_base * backoff_factor**(n-1))`` stretched by
    up to ``jitter`` fraction, keyed off ``crc32(event_id:n)`` so the same
    failed event always computes the same schedule (replayable chaos runs).
    ``action_timeout`` (seconds), when set, runs each action attempt under a
    watchdog thread; overruns count as failures of class ``timeout``.
    """

    __slots__ = ("max_attempts", "backoff_base", "backoff_factor",
                 "backoff_max", "jitter", "action_timeout")

    def __init__(self, max_attempts: int = 3, backoff_base: float = 0.05,
                 backoff_factor: float = 2.0, backoff_max: float = 5.0,
                 jitter: float = 0.1,
                 action_timeout: Optional[float] = None):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.backoff_base = float(backoff_base)
        self.backoff_factor = float(backoff_factor)
        self.backoff_max = float(backoff_max)
        self.jitter = float(jitter)
        self.action_timeout = action_timeout

    def backoff(self, attempt: int, event_id: str) -> float:
        """Delay before retrying after failed attempt ``attempt`` (1-based)."""
        base = min(self.backoff_max,
                   self.backoff_base * self.backoff_factor ** max(0, attempt - 1))
        if self.jitter <= 0.0:
            return base
        u = zlib.crc32(f"{event_id}:{attempt}".encode()) / 2 ** 32
        return base * (1.0 + self.jitter * u)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "max_attempts": self.max_attempts,
            "backoff_base": self.backoff_base,
            "backoff_factor": self.backoff_factor,
            "backoff_max": self.backoff_max,
            "jitter": self.jitter,
        }
        if self.action_timeout is not None:
            d["action_timeout"] = self.action_timeout
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RetryPolicy":
        return cls(max_attempts=d.get("max_attempts", 3),
                   backoff_base=d.get("backoff_base", 0.05),
                   backoff_factor=d.get("backoff_factor", 2.0),
                   backoff_max=d.get("backoff_max", 5.0),
                   jitter=d.get("jitter", 0.1),
                   action_timeout=d.get("action_timeout"))

    def __repr__(self) -> str:  # debugging / TimeoutError diagnostics
        return (f"RetryPolicy(max_attempts={self.max_attempts}, "
                f"backoff_base={self.backoff_base}, "
                f"action_timeout={self.action_timeout})")


def coerce_retry_policy(retry: Any) -> Optional[Dict[str, Any]]:
    """Normalise a user-supplied retry spec to its dict form (or None)."""
    if retry is None:
        return None
    if isinstance(retry, RetryPolicy):
        return retry.to_dict()
    if isinstance(retry, dict):
        return RetryPolicy.from_dict(retry).to_dict()  # validate
    raise TypeError(f"retry must be RetryPolicy or dict, got {type(retry)!r}")


# -- DLQ metadata ----------------------------------------------------------------

def quarantined(event: CloudEvent, reason: str, attempts: int = 0,
                first_failure: Optional[float] = None,
                last_failure: Optional[float] = None) -> CloudEvent:
    """A copy of ``event`` tagged with structured DLQ metadata in ``ext``.

    The copy (same id) replaces the live event in the DLQ; the metadata rides
    the event's JSON form through every store family (memory deques, .dlq
    segments, partitioned ledgers) and through redrive back into the stream.
    """
    meta: Dict[str, Any] = {"reason": reason}
    if attempts:
        meta["attempts"] = attempts
    if first_failure is not None:
        meta["first_failure"] = first_failure
    if last_failure is not None:
        meta["last_failure"] = last_failure
    tagged = CloudEvent.__new__(CloudEvent)
    d = dict(event.__dict__)
    d["ext"] = dict(event.ext or {})
    d["ext"][DLQ_META_KEY] = meta
    tagged.__dict__.update(d)  # frozen dataclass: bypass __init__, same as from_dict
    return tagged


def dlq_meta(event: CloudEvent) -> Dict[str, Any]:
    ext = getattr(event, "ext", None)
    if ext:
        meta = ext.get(DLQ_META_KEY)
        if isinstance(meta, dict):
            return meta
    return {}


def dlq_reason(event: CloudEvent) -> str:
    """Quarantine reason; legacy entries without metadata are ``disabled``."""
    return dlq_meta(event).get("reason", REASON_DISABLED)


def reason_matches(event: CloudEvent, reasons: Optional[Iterable[str]]) -> bool:
    return reasons is None or dlq_reason(event) in reasons


def reason_counter_name(reason: str) -> str:
    """Sanitised per-reason Prometheus counter name.

    The renderer emits plain ``name value`` lines (no label support), so the
    reason is folded into the metric name: ``poison:action-error`` →
    ``tf_poison_action_error_total``; ``disabled`` →
    ``tf_quarantined_disabled_total``.
    """
    slug = reason.replace("poison:", "poison_").replace("-", "_").replace(":", "_")
    if not slug.startswith("poison_"):
        return f"tf_quarantined_{slug}_total"
    return f"tf_{slug}_total"


# -- action watchdog -------------------------------------------------------------

def call_with_timeout(timeout: Optional[float], fn, *args):
    """Run ``fn(*args)`` with a wall-clock budget.

    Without a timeout this is a direct call (zero overhead for policies that
    only set a retry budget).  With one, the call runs on a daemon watchdog
    thread and an overrun raises ActionTimeout in the caller.  The overrun
    thread itself cannot be killed (CPython) — it is abandoned; actions run
    under a timeout should therefore be side-effect-idempotent, the same
    contract redelivery already imposes.
    """
    if timeout is None:
        return fn(*args)
    box: list = []
    done = threading.Event()

    def _run() -> None:
        try:
            box.append((True, fn(*args)))
        except BaseException as exc:  # noqa: BLE001 - re-raised in caller
            box.append((False, exc))
        finally:
            done.set()

    t = threading.Thread(target=_run, daemon=True, name="tf-watchdog")
    t.start()
    if not done.wait(timeout):
        raise ActionTimeout(f"action exceeded {timeout}s budget")
    ok, val = box[0]
    if ok:
        return val
    raise val


# -- crash-loop breaker ----------------------------------------------------------

class CircuitBreaker:
    """Consecutive-crash-streak breaker for one workflow's shard fleet.

    States:

    * ``closed`` — restarts allowed; from the *second* consecutive crash on,
      each restart waits out an exponential backoff (the first crash restarts
      free so deliberate ``crash_shard`` recovery is immediate).
    * ``open`` — streak reached ``threshold``: no restarts until ``cooldown``
      elapses, then the breaker goes half-open.
    * ``half_open`` — exactly one probe shard is allowed; a clean exit closes
      the circuit, another crash re-opens it (cooldown restarts).

    Thread-safe; pools call it under their own locks anyway but the
    autoscaler thread reads snapshots concurrently.
    """

    __slots__ = ("threshold", "backoff_base", "backoff_factor", "backoff_max",
                 "cooldown", "clock", "state", "streak", "opened_total",
                 "_last_crash", "_opened_at", "_lock")

    def __init__(self, threshold: int = 5, backoff_base: float = 0.2,
                 backoff_factor: float = 2.0, backoff_max: float = 5.0,
                 cooldown: float = 1.0, clock=time.monotonic):
        self.threshold = int(threshold)
        self.backoff_base = float(backoff_base)
        self.backoff_factor = float(backoff_factor)
        self.backoff_max = float(backoff_max)
        self.cooldown = float(cooldown)
        self.clock = clock
        self.state = "closed"
        self.streak = 0
        self.opened_total = 0  # transitions into "open" (tf_circuit_open_total)
        self._last_crash = 0.0
        self._opened_at = 0.0
        self._lock = threading.Lock()

    # -- event feed (pools call these from reap/exit paths) ----------------------
    def record_crash(self, n: int = 1) -> None:
        with self._lock:
            self.streak += n
            self._last_crash = self.clock()
            if self.state == "half_open" or (
                    self.state == "closed" and self.streak >= self.threshold):
                self.state = "open"
                self._opened_at = self.clock()
                self.opened_total += 1

    def record_clean(self) -> None:
        """A shard retired cleanly (idle/finished/stopped): reset the streak."""
        with self._lock:
            self.streak = 0
            if self.state != "closed":
                self.state = "closed"

    # -- gate --------------------------------------------------------------------
    def restart_backoff(self) -> float:
        """Current restart delay (seconds); 0 while the streak is free."""
        if self.streak < 2:
            return 0.0
        return min(self.backoff_max,
                   self.backoff_base * self.backoff_factor ** (self.streak - 2))

    def allow_start(self, want: int) -> int:
        """How many NEW shard starts are permitted right now (0..want)."""
        if want <= 0:
            return 0
        with self._lock:
            now = self.clock()
            if self.state == "open":
                if now - self._opened_at < self.cooldown:
                    return 0
                self.state = "half_open"
                return 1
            if self.state == "half_open":
                return 1
            delay = self.restart_backoff()
            if delay > 0.0 and now - self._last_crash < delay:
                return 0
            return want

    # -- introspection -----------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        return {"state": self.state, "streak": self.streak,
                "opened_total": self.opened_total,
                "restart_backoff_seconds": self.restart_backoff()}

    def __repr__(self) -> str:
        return (f"CircuitBreaker(state={self.state!r}, streak={self.streak}, "
                f"opened={self.opened_total})")
