"""Arithmetic that several per-layer metrics' readers share.  Each reader
(``bench/metrics/<name>.py``) stays a file of its own, found by its name."""
from __future__ import annotations

import statistics
from typing import Optional, Sequence

from . import counts as c


def fire_lag_ms(run) -> Optional[float]:
    """Median over the window's batches of the time from the moment a
    batch could fire (its last request published and the worker done with
    the batch before) to the start of its ``generate_batch``."""
    lags = []
    prev_end = None
    for b in run.batches:
        if run.t_open <= b.t0 < run.t_close and not b.profiled and b.t1:
            published = [run.requests[i].sent for i in b.ids if i in run.requests]
            if published:
                ready = max(published) if prev_end is None else max(max(published), prev_end)
                lags.append((b.t0 - ready) * 1e3)
        prev_end = b.t1
    return statistics.median(lags) if lags else None


def step_mfu(run, peak: float) -> Optional[float]:
    """Model FLOPs the window's prefill and decode calls needed, over their
    summed wall time times ``peak``, in %."""
    calls = run.window_prefills() + run.window_decodes()
    if not calls:
        return None
    flops = sum(c.prefill_flops(run.conf, p[2], p[3]) for p in run.window_prefills())
    flops += sum(c.decode_flops(run.conf, d[2], d[3]) for d in run.window_decodes())
    seconds = sum(t1 - t0 for t0, t1, *_ in calls)
    return 100.0 * flops / (seconds * peak)


def roofline(run, kernel: str, names: Sequence[str], dtype: str) -> Optional[float]:
    """The profiled slice's calls of ``kernel`` ("k2" or "k3"): the sum of
    their bounds over the summed device time of the kernels whose names
    contain one of ``names``, in %.  None where the slice has neither."""
    if run.trace is None:
        return None
    shapes = [s for p in run.profiled_prefills
              for s in c.kernel_calls(run.conf, p[2], p[3])[kernel]]
    call = c.k2_call if kernel == "k2" else c.k3_call
    bound = sum(c.bound_ms(call(*s)[1], call(*s)[0], dtype)[0] for s in shapes)
    device_us = sum(us for n, us in run.trace["by_name"].items()
                    if any(k in n for k in names))
    if not shapes or not device_us:
        return None
    return 100.0 * bound / (device_us / 1e3)


def idle_share(run) -> Optional[float]:
    """The share of the profiled slice with nothing running on the card, %."""
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_us"] / run.trace["window_us"])
