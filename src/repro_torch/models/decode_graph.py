"""One decode step held as a CUDA graph and replayed.

Op by op, a decode step of zamba2 launches over 1,500 small kernels one at
a time from Python, and the card waits between them; DeepSeek-V2's, with
its MoE routing, likewise.  Here ``Model.decode_in_place``, the model's
one step, is captured with ``pos`` a 0-d device tensor, once per
(B, max_len), into a ``torch.cuda.CUDAGraph`` and replayed at every later
step: the card runs the whole step back to back, and the host makes one
graph launch a step, after copying in the tokens and filling ``pos``.
``Model.decode`` checks ``pos`` against the cache before it comes here.

A ``DecodeGraph`` holds static buffers: the tokens [B,1], ``pos`` (0-d
int64), a cache of the model's layout and the logits [B,V] its capture
made.  A step from a cache whose tensors are not the graph's own (a
prefill's) copies that cache in first, once a batch, and leaves it as it
was; the dict a step returns holds the graph's tensors, so the next step
from it copies nothing.  ``pos`` stays a Python int in the dicts, and the
logits come back as a fresh tensor, since the next replay overwrites the
graph's own.

Where it engages (``replays``), from what the model can observe and with
no switch: parameters on a CUDA device and not DTensors (the mesh runs the
step op by op), and a family in ``GRAPH_FAMILIES``.  Every family's step
makes no shape from the data and reads nothing on the host at a tensor
``pos``; the list holds those a benchmark cell serves: ``dense`` and
``hybrid``, whose attention is the dense family's ``gqa_decode``, and
``mla_moe``, whose attention is the absorbed ``mla_decode``.  A decode
step's MoE routes its T = B tokens into slots on the device: the capacity
comes from T alone (C = T where dropless; the ragged path, which reads the
experts' counts on the host, is the prefill's), so the step's shapes are
fixed by (B, max_len).  The MoE's running sums (``Model.moe_counts``)
count on in the replayed step; the warm-up steps before a capture serve no
one, so the sums are put back as they were after them.  The others
(``moe``, ``vlm``, ``audio``, which the engine refuses, and ``xlstm``) run
the step op by op, since no benchmark cell serves them and a graph of
theirs would show no gain where it is measured.

A graph reads the parameters at the addresses they had when it was
captured; ``Model`` drops its graphs when its parameters are moved, cast
or loaded.  It keeps at most ``MAX_GRAPHS``, the oldest dropped first:
each holds a whole cache of its (B, max_len).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .layers import _is_dtensor

GRAPH_FAMILIES = ("dense", "hybrid", "mla_moe")
MAX_GRAPHS = 4
# steps on a side stream before the capture: what initialises itself
# lazily (cuBLAS's handles and workspaces, kernels' modules) cannot be captured
WARM_UP_STEPS = 1


def replays(model) -> bool:
    """Whether ``model.decode`` replays a graph (see the module's doc)."""
    embed = model.embed
    return model.cfg.family in GRAPH_FAMILIES and not _is_dtensor(embed) and embed.is_cuda


class DecodeGraph:
    """``model.decode_in_place`` captured for a cache shaped like ``cache``
    and tokens shaped like ``tokens``."""

    def __init__(self, model, cache: Dict[str, Any], tokens: torch.Tensor):
        device = tokens.device
        self.cache = {k: torch.zeros_like(v) for k, v in cache.items() if k != "pos"}
        self.tokens = torch.zeros_like(tokens)
        self.pos = torch.zeros((), dtype=torch.int64, device=device)
        batch = {"tokens": self.tokens}
        counts = None if model.moe_counts is None else model.moe_counts.clone()
        with torch.cuda.device(device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(WARM_UP_STEPS):
                    model.decode_in_place(self.cache, batch, self.pos)
            torch.cuda.current_stream().wait_stream(side)
            # the warm-up's MoE slots were served to no one; the sums keep
            # their tensor, whose address the graph will hold
            if counts is not None:
                model.moe_counts.copy_(counts)
            elif model.moe_counts is not None:
                model.moe_counts.zero_()
            self.graph = torch.cuda.CUDAGraph()
            # the engine decodes on its worker's thread: other threads may
            # use the card meanwhile
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                self.logits = model.decode_in_place(self.cache, batch, self.pos)

    def step(self, cache: Dict[str, Any], tokens: torch.Tensor, pos: int):
        """Replay at ``pos`` → (logits, the graph's cache at ``pos + 1``)."""
        if any(cache[k] is not v for k, v in self.cache.items()):
            for k, v in self.cache.items():
                v.copy_(cache[k])
        self.tokens.copy_(tokens)
        self.pos.fill_(pos)
        self.graph.replay()
        return self.logits.clone(), {**self.cache, "pos": pos + 1}


def decode(model, cache: Dict[str, Any], batch: Dict[str, torch.Tensor]):
    """``model.decode`` by its graph for the cache's shapes, (B, max_len),
    captured at the key's first step; counts captures and replays on the
    model.  ``model.decode`` has checked ``pos`` against the cache."""
    tokens, pos = batch["tokens"], cache["pos"]
    key = tuple(tuple(v.shape) for k, v in cache.items() if k != "pos")
    graph = model._decode_graphs.get(key)
    if graph is None:
        if len(model._decode_graphs) >= MAX_GRAPHS:
            del model._decode_graphs[next(iter(model._decode_graphs))]
        graph = model._decode_graphs[key] = DecodeGraph(model, cache, tokens)
        model.decode_graph_captures += 1
    model.decode_graph_replays += 1
    return graph.step(cache, tokens, pos)
