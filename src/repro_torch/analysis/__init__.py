"""``repro.analysis`` — the tfcheck invariant-checking plane.

Static AST rules over ``repro.core``/``repro.bus`` (run via
``scripts/tfcheck.py``, gated in CI with a baseline ratchet) plus a runtime
lock-order recorder (``locktrace``) that runs under the tier-1 suite when
``TFCHECK_TRACE_LOCKS`` is set.  The rule catalogue lives here so the CLI's
``--list-rules`` and ARCHITECTURE.md §10 stay one source of truth.
"""
from __future__ import annotations

from typing import List, Sequence

from .core import (Finding, Rule, SourceFile, load_baseline, load_paths,
                   ratchet, write_baseline)
from .durability import DurabilityOrdering
from .fencing import Fencing
from .lockrules import LockDiscipline, LockOrder
from .obsrules import ObsDiscipline
from .seams import SeamSafety

#: Every static rule, in reporting order.
ALL_RULES = (
    LockDiscipline(),
    LockOrder(),
    DurabilityOrdering(),
    Fencing(),
    ObsDiscipline(),
    SeamSafety(),
)


def rules_by_id():
    return {r.id: r for r in ALL_RULES}


def run_rules(files: Sequence[SourceFile],
              rules: Sequence[Rule] = ALL_RULES) -> List[Finding]:
    findings: List[Finding] = []
    for rule in rules:
        findings.extend(rule.check(files))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


__all__ = [
    "ALL_RULES", "Finding", "Rule", "SourceFile", "load_baseline",
    "load_paths", "ratchet", "rules_by_id", "run_rules", "write_baseline",
]
