"""``seam-safety``: no handler may swallow an exception without a trace.

A bare ``except:`` or blanket ``except Exception:`` whose body neither
re-raises, nor calls anything (logging, ``traceback.print_exc``, a metrics
bump), nor records state (an assignment a caller can observe) is a silent
swallow — the failure class where a shard "hangs" with no evidence because
its real error evaporated in a handler.

The codebase's sanctioned blanket-except idiom always does one of:

* re-raise after cleanup (``except Exception: ...; raise``),
* ``traceback.print_exc()`` + drop the shard through an accounted path,
* degrade a diagnostic to a placeholder (``lag = "?"``) — an assignment.

All of those pass.  Only the truly silent body (``pass`` / ``continue`` /
bare ``return``/constant) is flagged; a deliberate best-effort swallow gets
a pragma with its reason.
"""
from __future__ import annotations

import ast
from typing import List, Sequence

from .core import Finding, Rule, SourceFile

_BLANKET = ("Exception", "BaseException")


def _is_blanket(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    if isinstance(t, ast.Name) and t.id in _BLANKET:
        return True
    if isinstance(t, ast.Tuple):
        return any(isinstance(e, ast.Name) and e.id in _BLANKET
                   for e in t.elts)
    return False


def _is_silent(handler: ast.ExceptHandler) -> bool:
    """True when the body can neither surface nor record the exception."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return False
        if isinstance(node, ast.Call):
            return False
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            return False
        if isinstance(node, ast.Return) and node.value is not None \
                and not isinstance(node.value, ast.Constant):
            return False
    return True


class SeamSafety(Rule):
    id = "seam-safety"
    invariant = ("No bare/blanket except swallows an exception silently: "
                 "the handler re-raises, calls something (trace/log/metric) "
                 "or records state.")
    motivation = ("Worker/pool hot-path failures must leave evidence; a "
                  "silent swallow turns a crashed shard into an "
                  "undebuggable hang.")

    def check(self, files: Sequence[SourceFile]) -> List[Finding]:
        out: List[Finding] = []
        for sf in files:
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.ExceptHandler) and \
                        _is_blanket(node) and _is_silent(node):
                    # a pragma anywhere inside the handler blesses it (the
                    # natural place to document a deliberate swallow is the
                    # swallowing body itself)
                    end = getattr(node, "end_lineno", node.lineno) or \
                        node.lineno
                    if any(sf.allowed(ln, self.id)
                           for ln in range(node.lineno, end + 1)):
                        continue
                    what = "bare except" if node.type is None else \
                        "blanket except Exception"
                    self._finding(
                        sf, node, "%s swallows the exception silently "
                        "(no raise, no call, no recorded state)" % what, out)
        return out
