"""``fencing``: owner-side segment mutations must validate the lease epoch.

In any class that defines ``_check_lease`` (the lease-fenced durable store),
a method that appends to an *owner-side* segment — the committed ledger
(``.com``) or the quarantine ledger (``.dlq``), via ``_append_clean`` or a
direct ``.append()`` — must call ``self._check_lease(...)`` earlier in the
same method.  The event log (``.log``) is exempt: any process may publish;
only consume/commit/quarantine/redrive belong to the lease holder.

This is PR 8's zombie-writer defense: a SIGKILLed-but-not-dead owner whose
lease was superseded must get ``FencedWrite``, never an interleaved append.
A new owner-side write path that skips the check silently reintroduces the
zombie window — exactly the kind of path a reviewer misses and this rule
cannot.
"""
from __future__ import annotations

import ast
from typing import List, Sequence

from .core import (Finding, Rule, SourceFile, call_name, dotted_name,
                   walk_no_nested_functions)

_OWNER_SEGMENTS = ("com", "dlq")


def _owner_segment_of(call: ast.Call) -> str:
    """'com'/'dlq' when the call appends to an owner-side segment, else ''."""
    f = call.func
    name = call_name(call) or ""
    # self._append_clean(fp.com, ...) / self._append_clean(self.dlq, ...)
    if name.rsplit(".", 1)[-1] == "_append_clean" and call.args:
        seg = dotted_name(call.args[0]) or ""
        attr = seg.rsplit(".", 1)[-1]
        if attr in _OWNER_SEGMENTS:
            return attr
    # fp.com.append(...) / self.dlq.append(...)
    if isinstance(f, ast.Attribute) and f.attr == "append":
        recv = dotted_name(f.value) or ""
        attr = recv.rsplit(".", 1)[-1]
        if attr in _OWNER_SEGMENTS:
            return attr
    return ""


class Fencing(Rule):
    id = "fencing"
    invariant = ("In a class defining _check_lease, any append to a .com or "
                 ".dlq segment is preceded by self._check_lease() in the "
                 "same method.")
    motivation = ("PR 8's lease fencing: a stale owner must raise "
                  "FencedWrite, never interleave; an unfenced owner-side "
                  "write path reopens the zombie-writer window.")

    def check(self, files: Sequence[SourceFile]) -> List[Finding]:
        out: List[Finding] = []
        for sf in files:
            fenced_classes = {
                cls for _, cls, fn in sf.functions()
                if cls is not None and fn.name == "_check_lease"}
            if not fenced_classes:
                continue
            for qual, cls, fn in sf.functions():
                if cls not in fenced_classes or fn.name == "_check_lease":
                    continue
                calls = [n for n in walk_no_nested_functions(fn)
                         if isinstance(n, ast.Call)]
                calls.sort(key=lambda n: (n.lineno, n.col_offset))
                checked_line = None
                for n in calls:
                    name = call_name(n) or ""
                    if name.rsplit(".", 1)[-1] == "_check_lease":
                        checked_line = n.lineno
                        continue
                    seg = _owner_segment_of(n)
                    if not seg:
                        continue
                    if checked_line is None or checked_line > n.lineno:
                        self._finding(
                            sf, n, "append to owner-side .%s segment without "
                            "a preceding self._check_lease() — unfenced "
                            "write path (PR 8 invariant)" % seg, out)
        return out
