"""Lock rules: blocking work under thread locks + static lock-order cycles.

``lock-discipline`` — nothing slow or blocking may run while a
``threading.Lock``/``RLock`` is *textually* held: no ``time.sleep``, no
``os.fsync``, no ``subprocess`` calls, no socket sends, and no command-pipe
waits (``conn.poll``/``conn.recv``).  Pipe waits and sleeps additionally
propagate one file deep through ``self._helper()`` calls (fixpoint within
the class), because the process-pool control plane hides its waits behind
``_request``/``_await`` helpers.  ``os.fsync`` is checked lexically only:
the durable stores *require* fsync under their cross-process flock, and
chasing it interprocedurally would set this rule at war with the
durability-ordering rule.  Striped-lock design note: ``SegmentLog`` owns
every durable write, so a shard mirror that fsyncs *directly* under its
lock is always a bug.

``lock-order`` — build the static lock-acquisition graph (lexically nested
``with`` blocks plus one level of cross-file method resolution) and fail on
any cycle.  Node identity folds ``self.<attr>`` through the class's base
chain (``ShardWorker.lock`` is ``TFWorker.lock``) and maps the repo's
conventional receiver names (``worker``, ``shard``, ``fp.shard``) to their
classes, so the same lock seen from two sides is one node.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import (Finding, Rule, SourceFile, call_name, dotted_name,
                   walk_no_nested_functions, with_flock_items,
                   with_lock_items)

#: Receiver-name conventions → class owning the attribute.  Small and
#: explicit on purpose: a wrong guess here would merge two different locks
#: into one node and fabricate cycles.
RECEIVER_CLASSES = {
    "worker": "TFWorker",
    "w": "TFWorker",
    "shard": "StreamShard",
    "fp.shard": "StreamShard",
}

_PIPE_WAIT_ATTRS = ("poll", "recv")
_SOCKET_SEND_ATTRS = ("sendall", "sendto")


def _is_pipe_wait(call: ast.Call) -> bool:
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in _PIPE_WAIT_ATTRS:
        recv = dotted_name(f.value) or ""
        return "conn" in recv.rsplit(".", 1)[-1]
    return False


def _direct_violation(call: ast.Call) -> Optional[str]:
    """A call that must never run under a thread lock, or None."""
    name = call_name(call) or ""
    if name == "time.sleep":
        return "time.sleep"
    if name == "os.fsync":
        return "os.fsync (durable writes belong to SegmentLog, under the flock)"
    if name.startswith("subprocess."):
        return name
    f = call.func
    if isinstance(f, ast.Attribute):
        if f.attr in _SOCKET_SEND_ATTRS:
            return "socket %s" % f.attr
        if f.attr == "send":
            recv = dotted_name(f.value) or ""
            if "sock" in recv.rsplit(".", 1)[-1]:
                return "socket send"
    if _is_pipe_wait(call):
        return "command-pipe %s" % call.func.attr  # type: ignore[union-attr]
    return None


def _blocking_methods(sf: SourceFile) -> Dict[Optional[str], Set[str]]:
    """Per class: methods that (transitively, in-file) wait on a command
    pipe or sleep.  fsync/subprocess/socket do NOT propagate — see module
    docstring."""
    per_class: Dict[Optional[str], Dict[str, Set[str]]] = {}
    for qual, cls, fn in sf.functions():
        calls: Set[str] = set()
        direct = False
        for n in walk_no_nested_functions(fn):
            if isinstance(n, ast.Call):
                if _is_pipe_wait(n) or (call_name(n) == "time.sleep"):
                    direct = True
                cn = call_name(n)
                if cn is not None and cn.startswith("self."):
                    calls.add(cn.split(".", 1)[1].split(".")[0])
        per_class.setdefault(cls, {})[fn.name] = calls if not direct else \
            calls | {"__direct__"}
    out: Dict[Optional[str], Set[str]] = {}
    for cls, methods in per_class.items():
        blocking = {m for m, c in methods.items() if "__direct__" in c}
        changed = True
        while changed:
            changed = False
            for m, c in methods.items():
                if m not in blocking and c & blocking:
                    blocking.add(m)
                    changed = True
        out[cls] = blocking
    return out


class LockDiscipline(Rule):
    id = "lock-discipline"
    invariant = ("No blocking work (sleep, fsync, subprocess, socket send, "
                 "command-pipe wait) while a threading lock is held; pipe "
                 "waits/sleeps are traced one call deep through self-helpers.")
    motivation = ("PR 4/5: the striped shard locks are the publish/consume "
                  "hot path — one fsync or pipe wait under them serializes "
                  "every sibling shard (the notify-bump stall class of bug).")

    def check(self, files: Sequence[SourceFile]) -> List[Finding]:
        out: List[Finding] = []
        for sf in files:
            blocking = _blocking_methods(sf)
            for qual, cls, fn in sf.functions():
                cls_blocking = blocking.get(cls, set())
                for node in walk_no_nested_functions(fn):
                    if not isinstance(node, ast.With):
                        continue
                    locks = with_lock_items(node)
                    if not locks:
                        continue
                    held = " + ".join(locks)
                    for n in walk_no_nested_functions(node):
                        if not isinstance(n, ast.Call):
                            continue
                        why = _direct_violation(n)
                        if why is not None:
                            self._finding(
                                sf, n, "%s under %s" % (why, held), out)
                            continue
                        cn = call_name(n)
                        if cn is not None and cn.startswith("self."):
                            meth = cn.split(".", 1)[1].split(".")[0]
                            if meth != fn.name and meth in cls_blocking:
                                self._finding(
                                    sf, n,
                                    "command-pipe wait/sleep under %s via "
                                    "self.%s()" % (held, meth), out)
        return out


# -- static lock-order graph ---------------------------------------------------

def _root_class(sf_by_class: Dict[str, SourceFile], cls: str) -> str:
    """Fold a class through its (in-corpus, single-inheritance) base chain."""
    seen = set()
    while cls in sf_by_class and cls not in seen:
        seen.add(cls)
        bases = sf_by_class[cls].class_bases.get(cls, [])
        nxt = next((b for b in bases if b in sf_by_class), None)
        if nxt is None:
            return cls
        cls = nxt
    return cls


def _node_name(expr_name: str, cls: Optional[str],
               sf_by_class: Dict[str, SourceFile]) -> str:
    """Canonical graph node for an acquired lock name."""
    recv, _, attr = expr_name.rpartition(".")
    if recv == "self" and cls is not None:
        return "%s.%s" % (_root_class(sf_by_class, cls), attr)
    mapped = RECEIVER_CLASSES.get(recv)
    if mapped is not None:
        return "%s.%s" % (_root_class(sf_by_class, mapped), attr)
    return expr_name  # unknown receiver: keep it distinct, never merge


def build_lock_graph(files: Sequence[SourceFile]
                     ) -> Tuple[Dict[str, Set[str]],
                                Dict[Tuple[str, str], Tuple[str, int]]]:
    """The static acquisition graph: edge A→B when B is acquired (lexically,
    or via one resolved method call) while A is held.  Returns (adjacency,
    edge → (file, line) provenance)."""
    sf_by_class: Dict[str, SourceFile] = {}
    for sf in files:
        for cls in sf.class_bases:
            sf_by_class.setdefault(cls, sf)

    # method name -> list of (class, canonical lock nodes acquired directly)
    method_locks: Dict[str, List[Tuple[Optional[str], Set[str]]]] = {}
    for sf in files:
        for qual, cls, fn in sf.functions():
            acquired: Set[str] = set()
            for n in walk_no_nested_functions(fn):
                if isinstance(n, ast.With):
                    for name in with_lock_items(n):
                        acquired.add(_node_name(name, cls, sf_by_class))
                    for name in with_flock_items(n):
                        recv, _, attr = name.rpartition(".")
                        owner = _root_class(sf_by_class, cls) \
                            if recv == "self" and cls else recv
                        acquired.add("%s.%s" % (owner, attr))
            method_locks.setdefault(fn.name, []).append((cls, acquired))

    adj: Dict[str, Set[str]] = {}
    prov: Dict[Tuple[str, str], Tuple[str, int]] = {}

    def add_edge(a: str, b: str, sf: SourceFile, line: int) -> None:
        if a == b:
            return
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set())
        prov.setdefault((a, b), (sf.rel, line))

    def callee_locks(call: ast.Call) -> Set[str]:
        """Locks a resolved callee acquires directly; {} when ambiguous."""
        f = call.func
        if not isinstance(f, ast.Attribute):
            return set()
        cands = method_locks.get(f.attr, [])
        cands = [(c, locks) for c, locks in cands if locks]
        if not cands:
            return set()
        recv = dotted_name(f.value) or ""
        mapped = RECEIVER_CLASSES.get(recv)
        if mapped is not None:
            root = _root_class(sf_by_class, mapped)
            cands = [(c, locks) for c, locks in cands
                     if c and _root_class(sf_by_class, c) == root]
        union = set().union(*(locks for _, locks in cands)) if cands else set()
        first = cands[0][1] if cands else set()
        # several classes define the method: only use the result when they
        # all acquire the same nodes — a wrong merge fabricates cycles
        if all(locks == first for _, locks in cands):
            return first
        return union if len(cands) == 1 else set()

    for sf in files:
        for qual, cls, fn in sf.functions():
            def visit(node: ast.AST, held: List[str]) -> None:
                for child in ast.iter_child_nodes(node):
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef, ast.Lambda)):
                        continue
                    if isinstance(child, ast.With):
                        here = [
                            _node_name(nm, cls, sf_by_class)
                            for nm in with_lock_items(child)]
                        for nm in with_flock_items(child):
                            recv, _, attr = nm.rpartition(".")
                            owner = _root_class(sf_by_class, cls) \
                                if recv == "self" and cls else recv
                            here.append("%s.%s" % (owner, attr))
                        # re-acquiring an already-held node is the RLock
                        # idiom, not an ordering edge
                        here = [b for b in here if b not in held]
                        for h in held:
                            for b in here:
                                add_edge(h, b, sf, child.lineno)
                        for i, a in enumerate(here):
                            for b in here[i + 1:]:
                                add_edge(a, b, sf, child.lineno)
                        visit(child, held + here)
                        continue
                    if isinstance(child, ast.Call) and held:
                        for b in callee_locks(child):
                            if b in held:
                                continue  # re-entrant RLock, not an edge
                            for h in held:
                                add_edge(h, b, sf, child.lineno)
                    visit(child, held)
            visit(fn, [])
    return adj, prov


def find_cycle(adj: Dict[str, Set[str]]) -> Optional[List[str]]:
    """One cycle as [a, b, ..., a], or None if the graph is a DAG."""
    WHITE, GREY, BLACK = 0, 1, 2
    color = {n: WHITE for n in adj}
    stack: List[str] = []

    def dfs(n: str) -> Optional[List[str]]:
        color[n] = GREY
        stack.append(n)
        for m in sorted(adj.get(n, ())):
            if color.get(m, WHITE) == GREY:
                i = stack.index(m)
                return stack[i:] + [m]
            if color.get(m, WHITE) == WHITE:
                got = dfs(m)
                if got is not None:
                    return got
        stack.pop()
        color[n] = BLACK
        return None

    for n in sorted(adj):
        if color[n] == WHITE:
            got = dfs(n)
            if got is not None:
                return got
    return None


class LockOrder(Rule):
    id = "lock-order"
    invariant = ("The static lock-acquisition graph (nested with-blocks + "
                 "one level of method resolution) must be acyclic.")
    motivation = ("The pool→worker→store→flock nesting is the system's "
                  "global lock order; any new path acquiring it backwards "
                  "is a latent deadlock the tests may never schedule.")

    def check(self, files: Sequence[SourceFile]) -> List[Finding]:
        adj, prov = build_lock_graph(files)
        cycle = find_cycle(adj)
        if cycle is None:
            return []
        edges = list(zip(cycle, cycle[1:]))
        where = prov.get(edges[0], ("?", 0))
        detail = "; ".join(
            "%s->%s (%s:%d)" % (a, b, *prov.get((a, b), ("?", 0)))
            for a, b in edges)
        return [Finding(self.id, where[0], where[1], "",
                        "lock-order cycle: %s" % detail)]
