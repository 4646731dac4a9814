"""Shared analysis core for ``tfcheck`` (see ``scripts/tfcheck.py``).

The rules in this package encode the codebase's concurrency/durability
invariants (ARCHITECTURE.md §10) as small AST visitors.  This module owns
everything the rules share:

* ``SourceFile`` — one parsed file: AST, source lines, per-line pragma map,
  and a node→qualified-name index so findings name the function they hit.
* ``Finding`` — one rule violation, keyed for the baseline ratchet.
* pragma parsing — ``# tfcheck: allow[rule] reason`` on the offending line
  (or the line directly above it) suppresses that rule there.  The reason
  string is mandatory by convention: a pragma is a *documented* exception.
* baseline/ratchet — a committed JSON baseline maps finding keys to counts;
  a run fails only on findings *above* its baseline count (new code can't
  add violations; burned-down ones can't come back because
  ``--write-baseline`` shrinks the file).

Rules are deliberately lexical-first: they look at what a function does
while it *textually* holds a lock / before it *textually* renames a file,
with at most one level of in-file call resolution (``callers_of``).  That
keeps every rule small, predictable, and explainable in one error line —
the property that makes a lint gate survivable in CI.
"""
from __future__ import annotations

import ast
import json
import os
import re
from collections import Counter
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PRAGMA_RE = re.compile(r"#\s*tfcheck:\s*allow\[([A-Za-z0-9_,\- ]+)\]\s*(.*)")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location.

    ``key`` intentionally excludes the line number: the ratchet compares
    per-(rule, file, function) *counts*, so unrelated edits that shift
    lines don't churn the baseline.
    """

    rule: str
    path: str       # repo-relative path
    line: int
    context: str    # qualified function/class ("" for module level)
    message: str

    @property
    def key(self) -> str:
        return "%s:%s:%s" % (self.rule, self.path, self.context or "<module>")

    def render(self) -> str:
        where = " (in %s)" % self.context if self.context else ""
        return "%s:%d: [%s] %s%s" % (self.path, self.line, self.rule,
                                     self.message, where)


class SourceFile:
    """A parsed source file plus the per-line pragma map."""

    def __init__(self, path: str, rel: str, text: str) -> None:
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        # line -> set of allowed rule ids.  A pragma covers its own line and
        # the next one, so it works both trailing and standalone-above.
        self.allow: Dict[int, set] = {}
        for i, ln in enumerate(self.lines, 1):
            m = PRAGMA_RE.search(ln)
            if m:
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                self.allow.setdefault(i, set()).update(rules)
                self.allow.setdefault(i + 1, set()).update(rules)
        # node -> enclosing qualified name ("Class.method")
        self._qual: Dict[ast.AST, str] = {}
        self._index_quals(self.tree, ())
        # class name -> list of base-class names (in-file resolution only)
        self.class_bases: Dict[str, List[str]] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ClassDef):
                self.class_bases[node.name] = [
                    b.id for b in node.bases if isinstance(b, ast.Name)]

    def _index_quals(self, node: ast.AST, stack: Tuple[str, ...]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                child_stack = stack + (child.name,)
                self._qual[child] = ".".join(child_stack)
                self._index_quals(child, child_stack)
            else:
                self._qual[child] = ".".join(stack)
                self._index_quals(child, stack)

    def qualname(self, node: ast.AST) -> str:
        return self._qual.get(node, "")

    def allowed(self, line: int, rule: str) -> bool:
        return rule in self.allow.get(line, ())

    def functions(self) -> List[Tuple[str, Optional[str], ast.AST]]:
        """Every function in the file as (qualname, class name or None, node)."""
        out = []
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = self._qual.get(node, node.name)
                parts = qual.split(".")
                cls = parts[-2] if len(parts) >= 2 else None
                # a nested function's "class" slot may actually be a function;
                # resolve against known classes
                if cls is not None and cls not in self.class_bases:
                    cls = None
                out.append((qual, cls, node))
        return out


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> Optional[str]:
    return dotted_name(node.func)


def walk_no_nested_functions(node: ast.AST) -> Iterable[ast.AST]:
    """Walk a function body without descending into nested function
    definitions or lambdas (their bodies run at *call* time, not while the
    enclosing lock/region is held)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


#: with-item context-manager call names that take the cross-process flock.
FLOCK_CTX_NAMES = ("_plock", "_flock", "_wf_flock")


def with_lock_items(node: ast.With) -> List[str]:
    """Thread-lock names acquired by a ``with`` statement.

    Matches bare attribute chains whose final attribute ends in ``lock``
    (``self._lock``, ``shard.lock``, ``worker.lock``) — NOT context-manager
    *calls* like ``self._plock(fp)``, which are flocks (see
    ``with_flock_items``).  fsync-under-flock is required by the durability
    invariant, so the two kinds must never be conflated.
    """
    out = []
    for item in node.items:
        expr = item.context_expr
        name = dotted_name(expr)
        if name is not None and name.rsplit(".", 1)[-1].endswith("lock"):
            out.append(name)
    return out


def with_flock_items(node: ast.With) -> List[str]:
    """Flock context-manager names entered by a ``with`` statement."""
    out = []
    for item in node.items:
        expr = item.context_expr
        if isinstance(expr, ast.Call):
            name = call_name(expr)
            if name is not None and \
                    name.rsplit(".", 1)[-1] in FLOCK_CTX_NAMES:
                out.append(name)
    return out


def callers_of(sf: SourceFile, func_name: str) -> List[Tuple[ast.AST, ast.Call]]:
    """In-file call sites of ``func_name`` as (enclosing function, call).

    One level only, by name — enough to bless small helpers (``_append_clean``)
    whose callers all hold the required context, without growing a real
    interprocedural engine.
    """
    out = []
    for _, _, fn in sf.functions():
        for n in walk_no_nested_functions(fn):
            if isinstance(n, ast.Call):
                cn = call_name(n)
                if cn is not None and cn.rsplit(".", 1)[-1] == func_name:
                    out.append((fn, n))
    return out


class Rule:
    """Base class: one invariant, one ``check`` over the parsed files."""

    id: str = ""
    invariant: str = ""
    motivation: str = ""

    def check(self, files: Sequence[SourceFile]) -> List[Finding]:
        raise NotImplementedError

    def _finding(self, sf: SourceFile, node: ast.AST, message: str,
                 out: List[Finding]) -> None:
        line = getattr(node, "lineno", 1)
        if sf.allowed(line, self.id):
            return
        out.append(Finding(self.id, sf.rel, line, sf.qualname(node), message))


# -- file loading ---------------------------------------------------------------

def load_paths(paths: Iterable[str], root: Optional[str] = None
               ) -> List[SourceFile]:
    """Parse every ``.py`` under the given files/directories."""
    root = os.path.abspath(root or os.getcwd())
    files: List[SourceFile] = []
    seen = set()
    for p in paths:
        p = os.path.abspath(p)
        cands: List[str] = []
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                cands.extend(os.path.join(dirpath, f)
                             for f in sorted(filenames) if f.endswith(".py"))
        elif p.endswith(".py"):
            cands.append(p)
        for c in cands:
            if c in seen:
                continue
            seen.add(c)
            rel = os.path.relpath(c, root)
            with open(c, encoding="utf-8") as f:
                files.append(SourceFile(c, rel, f.read()))
    return files


# -- baseline / ratchet ---------------------------------------------------------

def load_baseline(path: str) -> Dict[str, int]:
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except OSError:
        return {}
    findings = data.get("findings", {})
    return {str(k): int(v) for k, v in findings.items()}


def write_baseline(findings: Sequence[Finding], path: str) -> None:
    counts = Counter(f.key for f in findings)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1, "findings": dict(sorted(counts.items()))},
                  f, indent=2, sort_keys=True)
        f.write("\n")


def ratchet(findings: Sequence[Finding], baseline: Dict[str, int]
            ) -> List[Finding]:
    """Findings above their baselined count — the ones that fail the gate.

    For a key baselined at N, the first N findings are forgiven and any
    beyond N are returned (new code added a violation).  Keys absent from
    the baseline get everything returned.
    """
    used: Counter = Counter()
    out = []
    for f in findings:
        used[f.key] += 1
        if used[f.key] > baseline.get(f.key, 0):
            out.append(f)
    return out
