"""tfcheck over the port — the invariant linter's static half.

Runs the ``repro_torch.analysis`` AST rules over the port's runtime,
``src/repro_torch/core``, ``src/repro_torch/bus`` and
``src/repro_torch/chaos`` (override with positional paths), and fails on
any finding not covered by the repo's committed baseline
(``tfcheck-baseline.json``, which this entry point only reads) or an inline
``# tfcheck: allow[rule] reason`` pragma.  The flags and exit codes are
``scripts/tfcheck.py``'s:

    python -m repro_torch.analysis.cli                   # gate
    python -m repro_torch.analysis.cli --list-rules      # the catalogue
    python -m repro_torch.analysis.cli --write-baseline --baseline PATH
    python -m repro_torch.analysis.cli src/repro_torch extra_dir/

Exit codes: 0 clean (or fully baselined), 1 new findings, 2 usage/IO error
(a missing path, a file that does not parse, or ``--write-baseline`` aimed
at the committed baseline).

The dynamic half is ``repro_torch.analysis.locktrace``: ``install()``
before the runtime creates its locks, ``check()`` after it ran.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

from . import (ALL_RULES, load_baseline, load_paths, ratchet, run_rules,
               write_baseline)

REPO = str(Path(__file__).resolve().parents[3])
DEFAULT_PATHS = ("src/repro_torch/core", "src/repro_torch/bus", "src/repro_torch/chaos")
DEFAULT_BASELINE = os.path.join(REPO, "tfcheck-baseline.json")


def list_rules() -> None:
    print("tfcheck rules (static; see docs/ARCHITECTURE.md §10):\n")
    for r in ALL_RULES:
        print("  %-20s %s" % (r.id, r.invariant))
        print("  %-20s motivation: %s\n" % ("", r.motivation))
    print("  %-20s %s" % (
        "lock-trace (dynamic)",
        "repro_torch.analysis.locktrace records the runtime lock "
        "acquisition graph"))
    print("  %-20s %s" % (
        "", "and asserts it is acyclic with no sleep under bus locks."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.cli",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to check (default: %s)" % " ".join(DEFAULT_PATHS))
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    ap.add_argument("--write-baseline", action="store_true",
                    help="write the current findings to --baseline (not the "
                         "committed one)")
    ap.add_argument("--no-ratchet", action="store_true",
                    help="ignore the baseline; report everything")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        list_rules()
        return 0
    if args.write_baseline and os.path.abspath(args.baseline) == DEFAULT_BASELINE:
        print("tfcheck: the committed baseline is read-only here; pass "
              "--baseline PATH", file=sys.stderr)
        return 2

    paths = args.paths or [os.path.join(REPO, p) for p in DEFAULT_PATHS]
    for p in paths:
        if not os.path.exists(p):
            print("tfcheck: no such path: %s" % p, file=sys.stderr)
            return 2
    try:
        files = load_paths(paths, root=REPO)
    except SyntaxError as exc:
        print("tfcheck: cannot parse: %s" % exc, file=sys.stderr)
        return 2

    findings = run_rules(files)
    if args.write_baseline:
        write_baseline(findings, args.baseline)
        print("tfcheck: baseline written to %s (%d findings)"
              % (args.baseline, len(findings)))
        return 0

    baseline = {} if args.no_ratchet else load_baseline(args.baseline)
    new = ratchet(findings, baseline)
    if not args.quiet:
        for f in new:
            print(f.render())
    n_baselined = len(findings) - len(new)
    if new:
        print("tfcheck: %d finding(s) (%d more baselined) over %d files "
              "-> FAIL" % (len(new), n_baselined, len(files)))
        return 1
    if not args.quiet:
        print("tfcheck: clean (%d files, %d rules, %d baselined finding(s))"
              % (len(files), len(ALL_RULES), n_baselined))
    return 0


if __name__ == "__main__":
    sys.exit(main())
