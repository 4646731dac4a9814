"""The reduction of a profiled slice of the window to what the metrics read.

The slice is a run of whole batches, each inside a ``bench.batch`` range
(``record_function``), with ``bench.prefill`` and ``bench.decode`` ranges
inside it.  From the profiler's events it keeps the slice's bounds, every
device activity (kernels, copies, fills; the ranges' own spans on the
device's timeline left out) clipped to the slice, the union of their
intervals (the device's busy time), their time by name, and the idle gaps
between them, each labelled by what the host was doing at its midpoint:
the innermost ``bench.*`` range and the outermost operator running then.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional

SPAN_PREFIX = "bench."


def reduce(events) -> Optional[dict]:
    """``prof.events()`` → {window_us, busy_us, by_name {name: us}, gaps
    {label: us}, intervals [(start, end, name)]}, or None where the slice
    saw no device activity."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    batches = sorted((e.time_range.start, e.time_range.end) for e in cpu
                     if e.name == SPAN_PREFIX + "batch")
    if not batches:
        return None
    w0, w1 = batches[0][0], batches[-1][1]
    dev = sorted((max(e.time_range.start, w0), min(e.time_range.end, w1), e.name)
                 for e in events if e.device_type == DeviceType.CUDA
                 and not e.name.startswith(SPAN_PREFIX)
                 and e.time_range.end > w0 and e.time_range.start < w1)
    if not dev:
        return None
    by_name: Dict[str, float] = {}
    for s, t, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (t - s)
    busy, gaps = 0.0, []
    cur_s, cur_t = dev[0][0], dev[0][1]
    if cur_s > w0:
        gaps.append((w0, cur_s))
    for s, t, _ in dev[1:]:
        if s > cur_t:
            busy += cur_t - cur_s
            gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    busy += cur_t - cur_s
    if cur_t < w1:
        gaps.append((cur_t, w1))
    return {"window_us": w1 - w0, "busy_us": busy, "by_name": by_name,
            "gaps": label_gaps(cpu, gaps), "intervals": dev}


def _covering(starts: List[float], spans: List[tuple], t: float):
    """The span of ``spans`` (sorted by start, not nested) covering t."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and spans[i][1] >= t:
        return spans[i]
    return None


def label_gaps(cpu, gaps) -> Dict[str, float]:
    ranges = {}
    for name in ("batch", "prefill", "decode"):
        spans = sorted((e.time_range.start, e.time_range.end, name) for e in cpu
                       if e.name == SPAN_PREFIX + name)
        ranges[name] = ([s[0] for s in spans], spans)
    tops = sorted((e.time_range.start, e.time_range.end, e.name) for e in cpu
                  if not e.name.startswith(SPAN_PREFIX)
                  and (e.cpu_parent is None or e.cpu_parent.name.startswith(SPAN_PREFIX)))
    # keep the outermost of overlapping operators
    outer: List[tuple] = []
    for s in tops:
        if outer and s[0] < outer[-1][1]:
            continue
        outer.append(s)
    outer_starts = [s[0] for s in outer]
    out: Dict[str, float] = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        where = "between batches"
        for name in ("decode", "prefill", "batch"):
            if _covering(*ranges[name], mid) is not None:
                where = name
                break
        op = _covering(outer_starts, outer, mid)
        label = f"{where}: {op[2] if op else 'python'}"
        out[label] = out.get(label, 0.0) + (g1 - g0)
    return out
