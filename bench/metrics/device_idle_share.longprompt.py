"""Device: the share of the profiled slice of the window with no operation
running on the card (the union of the profiler's device intervals), in %."""
from benchlib.readers import idle_share


def read(run):
    return idle_share(run)
