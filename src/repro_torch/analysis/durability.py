"""``durability-ordering``: the write-path orderings crashes actually test.

Three checks, one rule id:

* **checkpoint-before-commit** — a worker-side commit call
  (``self._commit(...)`` / ``self.event_store.commit*(...)``) must be
  dominated by a state-store checkpoint (``put_contexts_delta`` /
  ``put_contexts``), either earlier in the same function or in every
  in-file caller.  This is ARCHITECTURE.md §5's ordering: commit marks an
  event *done*, so its effects must be durable first, or a crash strands a
  committed event with no checkpointed result.

* **fsync-before-rename** — ``os.rename``/``os.replace`` publishes a file
  atomically, but only the *name* is atomic: without an ``os.fsync`` of the
  source earlier in the function, a power cut can publish an empty or torn
  file under the final name.

* **flock-before-truncate** — ``SegmentLog`` ``truncate``/``repair`` chops
  a torn tail, which is only correct when no live writer can be mid-append:
  the call must sit inside the owning flock context (``_plock`` /
  ``_wf_flock`` / ``_flock``), directly or via a helper whose in-file
  callers all hold it.  (PR 4's live-writer chop was exactly this bug.)
  ``remove`` is fenced the same way since the TFB1 framing landed: a
  recreated segment re-applies the writer's *preferred* format, so an
  unfenced remove racing a live appender can flip a file's wire format
  mid-stream (v1 lines fused after a TFB1 magic header, or vice versa).
"""
from __future__ import annotations

import ast
from typing import List, Optional, Sequence

from .core import (Finding, Rule, SourceFile, call_name, callers_of,
                   walk_no_nested_functions, with_flock_items)

_CHECKPOINT_CALLS = ("put_contexts_delta", "put_contexts", "save_contexts")
_WORKER_COMMITS = ("self._commit", "self.event_store.commit",
                   "self.event_store.commit_partitions")
_SEG_MUTATIONS = ("truncate", "repair", "remove")
#: Receivers whose .truncate() is not a SegmentLog chop (os.truncate on the
#: notify counter, file objects in SegmentLog's own implementation).
_TRUNCATE_EXEMPT_RECEIVERS = ("os", "f", "fd", "fh")
#: Classes that own the segment bytes and repair/truncate as part of their
#: contract (SegmentLog internals); their methods are the primitive, not a
#: call site.
_OWNER_CLASSES = ("SegmentLog",)


def _calls_in_order(fn: ast.AST) -> List[ast.Call]:
    calls = [n for n in walk_no_nested_functions(fn)
             if isinstance(n, ast.Call)]
    calls.sort(key=lambda n: (n.lineno, n.col_offset))
    return calls


def _has_checkpoint_before(fn: ast.AST, line: int) -> bool:
    for n in _calls_in_order(fn):
        if n.lineno >= line:
            break
        name = call_name(n) or ""
        if name.rsplit(".", 1)[-1] in _CHECKPOINT_CALLS:
            return True
    return False


def _has_fsync_before(fn: ast.AST, line: int) -> bool:
    for n in _calls_in_order(fn):
        if n.lineno >= line:
            break
        name = call_name(n) or ""
        if name == "os.fsync" or name.rsplit(".", 1)[-1] == "fsync":
            return True
    return False


def _inside_flock(sf: SourceFile, fn: ast.AST, target: ast.AST) -> bool:
    """Is ``target`` lexically within a flock ``with`` in ``fn``?"""
    found = [False]

    def visit(node: ast.AST, covered: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            now = covered
            if isinstance(child, ast.With) and with_flock_items(child):
                now = True
            if child is target and now:
                found[0] = True
            visit(child, now)

    visit(fn, False)
    return found[0]


class DurabilityOrdering(Rule):
    id = "durability-ordering"
    invariant = ("Checkpoint dominates commit; os.rename/os.replace is "
                 "preceded by an fsync of the source; SegmentLog "
                 "truncate/repair/remove (framing-mutating calls) happens "
                 "under the owning flock.")
    motivation = ("PR 4's torn-tail live-writer chop and §5's "
                  "checkpoint-before-commit ordering: every crash test in "
                  "the suite assumes these hold on every path.")

    def check(self, files: Sequence[SourceFile]) -> List[Finding]:
        out: List[Finding] = []
        for sf in files:
            for qual, cls, fn in sf.functions():
                for n in walk_no_nested_functions(fn):
                    if not isinstance(n, ast.Call):
                        continue
                    name = call_name(n) or ""
                    self._check_commit(sf, fn, n, name, out)
                    self._check_rename(sf, fn, n, name, out)
                    self._check_truncate(sf, cls, fn, n, name, out)
        return out

    # -- checkpoint-before-commit ------------------------------------------------
    def _check_commit(self, sf: SourceFile, fn: ast.AST, n: ast.Call,
                      name: str, out: List[Finding]) -> None:
        if name not in _WORKER_COMMITS:
            return
        if _has_checkpoint_before(fn, n.lineno):
            return
        # helper pattern (_commit): every in-file caller must checkpoint
        # before calling it
        fname = getattr(fn, "name", "")
        callers = callers_of(sf, fname) if fname else []
        callers = [(cfn, c) for cfn, c in callers if cfn is not fn]
        if callers and all(_has_checkpoint_before(cfn, c.lineno)
                           for cfn, c in callers):
            return
        self._finding(
            sf, n, "%s() is not dominated by a state-store checkpoint "
            "(put_contexts_delta before commit — §5 ordering)" % name, out)

    # -- fsync-before-rename -----------------------------------------------------
    def _check_rename(self, sf: SourceFile, fn: ast.AST, n: ast.Call,
                      name: str, out: List[Finding]) -> None:
        if name not in ("os.rename", "os.replace"):
            return
        if _has_fsync_before(fn, n.lineno):
            return
        self._finding(
            sf, n, "%s() without an fsync of the source earlier in the "
            "function — the rename is atomic, the contents are not" % name,
            out)

    # -- flock-before-truncate ---------------------------------------------------
    def _check_truncate(self, sf: SourceFile, cls: Optional[str],
                        fn: ast.AST, n: ast.Call, name: str,
                        out: List[Finding]) -> None:
        f = n.func
        if not isinstance(f, ast.Attribute) or f.attr not in _SEG_MUTATIONS:
            return
        if f.attr == "remove" and (n.args or n.keywords):
            return  # list.remove(x) / set.remove(x) — SegmentLog.remove()
            # takes no arguments
        recv = (name.rpartition(".")[0] or "").rsplit(".", 1)[-1]
        if recv in _TRUNCATE_EXEMPT_RECEIVERS:
            return
        if cls in _OWNER_CLASSES:
            return
        if _inside_flock(sf, fn, n):
            return
        # helper pattern (_append_clean): bless it when every in-file
        # caller sits inside the flock
        fname = getattr(fn, "name", "")
        callers = callers_of(sf, fname) if fname else []
        callers = [(cfn, c) for cfn, c in callers if cfn is not fn]
        if callers and all(_inside_flock(sf, cfn, c) for cfn, c in callers):
            return
        self._finding(
            sf, n, "SegmentLog %s() outside the owning flock — a live "
            "writer's tail could be chopped, or the recreated segment's "
            "wire format flipped under it (PR 4 bug class)" % f.attr, out)
