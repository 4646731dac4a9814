"""Runtime (core/worker.py, core/triggers.py, core/autoscaler.py): the
median over the window's batches of the lag from the moment a batch could
fire (its last request published, the worker free) to the start of its
generate_batch.  Host clock, the benchmark's stamps."""
from benchlib.readers import fire_lag_ms


def read(run):
    return fire_lag_ms(run)
