"""Runtime lock-order recorder (the dynamic half of ``tfcheck``).

When ``TFCHECK_TRACE_LOCKS`` is set, ``install()`` replaces
``threading.Lock``/``threading.RLock`` with tracing wrappers, ``fcntl.flock``
with a recording shim, and ``time.sleep`` with a held-lock auditor.  While
the tier-1 suite runs, every thread keeps a stack of currently-held locks
(identified by their *allocation site* — ``pool.py:214`` is one lock class,
however many instances exist), and each acquisition records edges
``held → acquired`` into a global graph.

After the run, ``check()`` asserts:

* the runtime acquisition-order graph is **acyclic** — the dynamic twin of
  the static ``lock-order`` rule, catching orders the AST can't see
  (callbacks, store objects threaded through the pools), and
* ``time.sleep`` was never called while a bus-infrastructure lock was held
  (worker locks are exempt: actions legitimately run — and may sleep —
  under the shard worker's batch lock).

Zero-cost when off: nothing is imported into the hot path and nothing is
patched unless ``install()`` runs; ``scripts/perf_gate.py`` holds the
flag-unset overhead to within 2%.

The wrappers forward ``_is_owned``/``_release_save``/``_acquire_restore``
via ``__getattr__``, so ``threading.Condition`` built on a traced lock
works; a ``Condition.wait`` window shows the lock as held while the thread
is blocked in the wait, which cannot add false edges (that thread acquires
nothing until ``wait`` returns with the lock re-held).
"""
from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

try:
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX
    fcntl = None  # type: ignore[assignment]

_real_Lock = threading.Lock
_real_RLock = threading.RLock
_real_flock = fcntl.flock if fcntl is not None else None
_real_sleep = time.sleep

#: Lock sites whose holders may sleep: the shard worker's batch lock is
#: held across user condition/action code by design (the action *is* the
#: work), and the simulated function backend sleeps to model duration.
#: The autoscaler's tick lock serializes the control loop across slow pool
#: calls (start_shards forks processes; stop() drains through the lock) —
#: blocking under it is its documented contract, not a hot-path hazard.
SLEEP_EXEMPT_SITES = ("worker.py:", "autoscaler.py:")

_installed = False
_state: Optional["_TraceState"] = None


class _TraceState:
    def __init__(self) -> None:
        self.guard = _real_Lock()
        self.edges: Dict[Tuple[str, str], Tuple[int, str]] = {}
        self.nodes: Set[str] = set()
        self.acquisitions = 0
        self.sleep_violations: List[Tuple[str, Tuple[str, ...]]] = []
        self.local = threading.local()

    def held(self) -> List[str]:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def on_acquire(self, site: str) -> None:
        stack = self.held()
        if stack:
            caller = _caller_site()
            with self.guard:
                self.nodes.add(site)
                for h in stack:
                    if h != site:
                        n, first = self.edges.get((h, site), (0, caller))
                        self.edges[(h, site)] = (n + 1, first)
        else:
            with self.guard:
                self.nodes.add(site)
        with self.guard:
            self.acquisitions += 1
        stack.append(site)

    def on_release(self, site: str) -> None:
        stack = self.held()
        # release order can differ from acquire order (overlapping scopes):
        # drop the most recent matching entry
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == site:
                del stack[i]
                return


def _caller_site(skip: int = 2) -> str:
    f = sys._getframe(skip)
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.endswith("locktrace.py") and "threading" not in fn:
            return "%s:%d" % (os.path.basename(fn), f.f_lineno)
        f = f.f_back
    return "?:0"


class _TracedLock:
    """Wrapper over a real lock; records acquisition order by site."""

    __slots__ = ("_lk", "_site", "_depth")

    def __init__(self, lk, site: str) -> None:
        self._lk = lk
        self._site = site
        self._depth = 0  # RLock re-entrancy: record the 0→1 edge only

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._lk.acquire(blocking, timeout)
        if ok:
            self._depth += 1
            if self._depth == 1 and _state is not None:
                _state.on_acquire(self._site)
        return ok

    def release(self) -> None:
        if self._depth > 0:
            self._depth -= 1
            if self._depth == 0 and _state is not None:
                _state.on_release(self._site)
        self._lk.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lk.locked()

    def __getattr__(self, name):
        # Condition support: _is_owned / _acquire_restore / _release_save
        # go straight to the real lock.  During a cv.wait the stack keeps
        # showing this lock held, which is sound (see module docstring).
        return getattr(self._lk, name)


def _traced_lock_factory():
    return _TracedLock(_real_Lock(), _caller_site())


def _traced_rlock_factory():
    return _TracedLock(_real_RLock(), _caller_site())


_FLOCK_FD_SITES: Dict[int, str] = {}


def _flock_site(fd) -> str:
    fileno = fd if isinstance(fd, int) else fd.fileno()
    site = _FLOCK_FD_SITES.get(fileno)
    if site is None:
        try:
            path = os.readlink("/proc/self/fd/%d" % fileno)
            base = os.path.basename(path)
            # fold instance numbering: p0007.lock -> pN.lock
            base = "".join("N" if c.isdigit() else c for c in base)
            while "NN" in base:
                base = base.replace("NN", "N")
            site = "flock:%s" % base
        except OSError:  # pragma: no cover
            site = "flock:fd"
        _FLOCK_FD_SITES[fileno] = site
    return site


def _traced_flock(fd, op) -> None:
    _real_flock(fd, op)  # type: ignore[misc]
    if _state is None or fcntl is None:
        return
    site = _flock_site(fd)
    if op & fcntl.LOCK_UN:
        _FLOCK_FD_SITES.pop(fd if isinstance(fd, int) else fd.fileno(), None)
        _state.on_release(site)
    elif op & (fcntl.LOCK_EX | fcntl.LOCK_SH):
        _state.on_acquire(site)


def _traced_sleep(secs: float) -> None:
    if _state is not None:
        held = [h for h in _state.held()
                if not any(h.startswith(x) for x in SLEEP_EXEMPT_SITES)]
        if held:
            caller = _caller_site()
            with _state.guard:
                _state.sleep_violations.append((caller, tuple(held)))
    _real_sleep(secs)


def enabled_by_env() -> bool:
    return bool(os.environ.get("TFCHECK_TRACE_LOCKS"))


def install() -> None:
    """Patch lock construction, flock, and sleep.  Idempotent."""
    global _installed, _state
    if _installed:
        return
    _state = _TraceState()
    threading.Lock = _traced_lock_factory  # type: ignore[assignment]
    threading.RLock = _traced_rlock_factory  # type: ignore[assignment]
    if fcntl is not None:
        fcntl.flock = _traced_flock  # type: ignore[assignment]
    time.sleep = _traced_sleep  # type: ignore[assignment]
    _installed = True


def maybe_install() -> bool:
    """Install only when TFCHECK_TRACE_LOCKS is set; returns whether on."""
    if enabled_by_env():
        install()
    return _installed


def uninstall() -> None:
    """Restore the real primitives (already-created traced locks keep
    working — they wrap real locks — but stop recording)."""
    global _installed, _state
    threading.Lock = _real_Lock  # type: ignore[assignment]
    threading.RLock = _real_RLock  # type: ignore[assignment]
    if fcntl is not None and _real_flock is not None:
        fcntl.flock = _real_flock  # type: ignore[assignment]
    time.sleep = _real_sleep  # type: ignore[assignment]
    _installed = False
    _state = None


def is_installed() -> bool:
    return _installed


def report() -> Dict[str, object]:
    """The recorded graph: nodes, edges (with counts + first caller),
    acquisition total, and sleep-under-lock violations."""
    if _state is None:
        return {"enabled": False, "nodes": [], "edges": {},
                "acquisitions": 0, "sleep_violations": []}
    with _state.guard:
        return {
            "enabled": True,
            "nodes": sorted(_state.nodes),
            "edges": {"%s -> %s" % k: {"count": v[0], "first_caller": v[1]}
                      for k, v in sorted(_state.edges.items())},
            "acquisitions": _state.acquisitions,
            "sleep_violations": list(_state.sleep_violations),
        }


def find_cycle() -> Optional[List[str]]:
    """A cycle in the runtime acquisition graph, or None."""
    if _state is None:
        return None
    with _state.guard:
        adj: Dict[str, Set[str]] = {}
        for (a, b) in _state.edges:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set())
    from .lockrules import find_cycle as _static_find
    return _static_find(adj)


def check() -> Dict[str, object]:
    """Assert the recorded order is safe; raises AssertionError otherwise.
    Returns the report for display either way."""
    rep = report()
    cycle = find_cycle()
    if cycle is not None:
        raise AssertionError(
            "tfcheck lock trace: runtime lock-order cycle %s (edges: %s)"
            % (" -> ".join(cycle), rep["edges"]))
    if _state is not None and _state.sleep_violations:
        with _state.guard:
            v = _state.sleep_violations[:10]
        raise AssertionError(
            "tfcheck lock trace: time.sleep while holding bus locks: %s" % v)
    return rep
