"""Roofline terms of one rank's traced program: the counterpart of the
reference's HLO analysis, which reads a traced torch graph, not HLO.

The dry-run traces each step with ``make_fx`` over DTensors under a fake
process group: the graph is the per-rank local program, its shapes are
local shapes and its communication is ``_c10d_functional`` collectives.
The graph is unrolled (no loop bodies), so no trip counts are needed.

- ``collective_bytes(gm)``: each collective's on-wire bytes, weighted as
  the reference weights them on a ring: all-reduce ≈ 2×size
  (reduce-scatter + all-gather phases), all-gather / reduce-scatter /
  all-to-all / permute ≈ 1×size.  The size is the collective's result, as
  the reference's parser reads the result shape of each HLO collective.
  Counted at the functional op, not the process group, since the fake and
  gloo groups emulate all-to-all by all-gather.
- ``cost_of(gm, fake_args)``: ``flops`` from ``FlopCounterMode`` over the
  graph's own interpretation on the fake inputs (local shapes: a
  ``FlopCounterMode`` around DTensor code would count global FLOPs), and
  ``bytes accessed``, the input and output bytes of every op that is not a
  view.  That is eager, unfused traffic, larger than XLA's fused count, and
  it is what the port really moves.
- ``memory_of(gm)``: arguments, outputs and the peak of live temporaries
  over the graph's order, the counterpart of ``memory_analysis()``.
- ``roofline_terms``: the three terms in seconds, from NVIDIA's H100 SXM5
  80GB datasheet figures (named below).  They are datasheet figures, not
  measurements.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.fx

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}
# _c10d_functional op → the reference's collective kind
_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "permute_tensor": "collective-permute", "send": "collective-permute",
    "recv": "collective-permute", "isend": "collective-permute",
    "irecv": "collective-permute",
}

# H100 SXM5 80GB, NVIDIA datasheet (per GPU)
PEAK_FLOPS = 989e12        # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12           # HBM3 bytes/s
# the link t_collective reads: one 400 Gb/s NDR InfiniBand port a GPU
# (50e9 B/s), since a 16-wide mesh axis spans two 8-GPU NVLink nodes
NET_BW = 50e9
NVLINK_BW = 450e9          # NVLink 4, bytes/s each direction (inside a node)


def _bytes(val) -> int:
    if isinstance(val, torch.Tensor):
        return val.numel() * val.element_size()
    if isinstance(val, (list, tuple)):
        return sum(_bytes(v) for v in val)
    return 0


def _kind(node: torch.fx.Node):
    if node.op != "call_function" or not isinstance(node.target, torch._ops.OpOverload):
        return None
    if node.target.namespace not in ("_c10d_functional", "c10d_functional", "c10d"):
        return None
    return _KINDS.get(node.target._opname)


def collective_bytes(gm: torch.fx.GraphModule) -> Dict[str, float]:
    """Per-collective-kind on-wire bytes (per rank) and counts, plus the
    total, under the reference's keys."""
    totals = {k: 0.0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for node in gm.graph.nodes:
        kind = _kind(node)
        if kind is None:
            continue
        totals[kind] += _WIRE_FACTOR[kind] * _bytes(node.meta.get("val"))
        counts[kind] += 1
    out = {f"bytes_{k}": v for k, v in totals.items()}
    out.update({f"count_{k}": counts[k] for k in _COLLECTIVES})
    out["bytes_total"] = sum(totals.values())
    return out


def _is_view(node: torch.fx.Node) -> bool:
    target = node.target
    if isinstance(target, torch._ops.OpOverload):
        return bool(target.is_view)
    return node.op == "call_function" and getattr(target, "__name__", "") == "getitem"


def cost_of(gm: torch.fx.GraphModule, fake_args: Sequence) -> Dict[str, float]:
    """{"flops", "bytes accessed"} of one rank's program; ``fake_args`` are
    the graph's inputs, fake tensors under the mode that traced it."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        torch.fx.Interpreter(gm).run(*fake_args)
    moved = 0
    for node in gm.graph.nodes:
        if node.op != "call_function" or _is_view(node):
            continue
        moved += _bytes(node.meta.get("val"))
        moved += sum(_bytes(a.meta.get("val")) for a in node.all_input_nodes)
    return {"flops": float(counter.get_total_flops()), "bytes accessed": float(moved)}


def memory_of(gm: torch.fx.GraphModule) -> Dict[str, int]:
    """Argument, output and peak temporary bytes of one rank's program: a
    liveness pass in the graph's order, a temporary alive from the node
    that makes it to its last reader; a view is its base's storage."""
    nodes = list(gm.graph.nodes)
    base = {}
    for node in nodes:
        src = node.all_input_nodes[0] if _is_view(node) and node.all_input_nodes else None
        base[node] = base.get(src, src) if src is not None else node
    last = {}
    for i, node in enumerate(nodes):
        for arg in node.all_input_nodes:
            last[base[arg]] = i
    args = {n for n in nodes if n.op in ("placeholder", "get_attr")}
    output = nodes[-1]
    outs = {base[a] for a in output.all_input_nodes}
    arg_bytes = sum(_bytes(n.meta.get("val")) for n in args)
    out_bytes = sum(_bytes(n.meta.get("val")) for n in outs)
    live = peak = 0
    ending: Dict[int, int] = {}
    for i, node in enumerate(nodes):
        if node.op == "call_function" and base[node] is node and node not in outs:
            size = _bytes(node.meta.get("val"))
            live += size
            end = last.get(node, i)
            ending[end] = ending.get(end, 0) + size
        peak = max(peak, live)
        live -= ending.pop(i, 0)
    return {"argument_bytes": arg_bytes, "output_bytes": out_bytes, "temp_bytes": peak,
            "alias_bytes": 0, "peak_est_bytes": arg_bytes + out_bytes + peak}


def roofline_terms(cost: dict, coll: dict, n_devices: int) -> Dict[str, float]:
    """cost = ``cost_of`` (per rank); coll = ``collective_bytes``.  The three
    roofline terms in seconds (per rank), from the datasheet figures above."""
    flops = float(cost.get("flops", 0.0))
    bytes_accessed = float(cost.get("bytes accessed", 0.0))
    cbytes = float(coll.get("bytes_total", 0.0))
    return {
        "t_compute": flops / PEAK_FLOPS,
        "t_memory": bytes_accessed / HBM_BW,
        "t_collective": cbytes / NET_BW,
        "flops_per_device": flops,
        "bytes_per_device": bytes_accessed,
        "collective_bytes_per_device": cbytes,
    }
