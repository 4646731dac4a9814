import os
import sys

# allow `pytest tests/` without PYTHONPATH=src
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# tfcheck dynamic half: with TFCHECK_TRACE_LOCKS set, trace every
# threading.Lock/RLock/flock acquisition made by the suite and assert the
# runtime acquisition-order graph is acyclic (and sleep-free under bus
# locks) at session end.  Installed at conftest import time — before any
# test module imports repro — so every lock the runtimes create is traced.
# When the flag is unset nothing is imported or patched: zero overhead
# (gated in scripts/perf_gate.py).
if os.environ.get("TFCHECK_TRACE_LOCKS"):
    from repro.analysis import locktrace

    locktrace.install()

    def pytest_terminal_summary(terminalreporter, exitstatus, config):
        rep = locktrace.report()
        terminalreporter.write_sep(
            "-", "tfcheck lock trace: %d lock sites, %d ordered edges, "
            "%d acquisitions" % (len(rep["nodes"]), len(rep["edges"]),
                                 rep["acquisitions"]))

    import pytest

    @pytest.fixture(scope="session", autouse=True)
    def _tfcheck_lock_order():
        """Fail the run if the suite ever acquired locks in a cyclic order
        or slept while holding a bus lock."""
        yield
        locktrace.check()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the port's kernels have no CPU "
                   "mode); the test skips without one")
