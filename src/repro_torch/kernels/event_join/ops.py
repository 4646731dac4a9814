"""Wrappers of the event-join kernel (``csrc/event_join.cu``).

``event_join`` runs the CUDA kernel on CUDA tensors, on the current stream,
and the plain torch version (``ref.join_counts_torch``) on CPU tensors.
``roundtrip`` is the join backend's host-to-host call (``dispatch.CudaJoin``):
one launch on pinned host buffers, which the kernel reads and writes
directly, and one synchronisation of the backend's own stream, in one C
call.  ``launches`` counts the kernel's launches from both, so a run can
show that its path went through it.

The worker reaches the card only through ``roundtrip``.  ``event_join``'s
card branch has no caller in the runtime: it is the kernel's wrapper on
device tensors, for the card tests and ``chip_smoke.py``'s phase k1.
"""
from __future__ import annotations

from typing import Dict

import torch

from .. import _cuda
from .ref import join_counts_torch

launches = 0
_max_blocks: Dict[int, int] = {}


def max_blocks(index: int) -> int:
    """The most blocks a launch takes on card ``index``: two a SM, looked
    up once per card."""
    blocks = _max_blocks.get(index)
    if blocks is None:
        blocks = _max_blocks[index] = \
            2 * torch.cuda.get_device_properties(index).multi_processor_count
    return blocks


def _check(events, counts, expected) -> None:
    for name, t in (("events", events), ("counts", counts), ("expected", expected)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"event_join: {name} must be a contiguous 1-D int32 "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
        if t.device != events.device:
            raise ValueError(f"event_join: {name} is on {t.device}, events on "
                             f"{events.device}")
    if counts.shape != expected.shape:
        raise ValueError(f"event_join: counts {tuple(counts.shape)} and expected "
                         f"{tuple(expected.shape)} differ")


def event_join(events: torch.Tensor, counts: torch.Tensor,
               expected: torch.Tensor):
    """events [N] int32 trigger row ids (−1 = padding; ids outside [0, T) are
    dropped), counts/expected [T] int32 → (new_counts, fired) [T] int32; on
    the card the two rows of one [2, T] tensor."""
    global launches
    _check(events, counts, expected)
    if events.device.type == "cpu":
        return join_counts_torch(events, counts, expected)
    if events.device.type != "cuda":
        raise ValueError(f"event_join: no kernel for device {events.device}")
    n, T = events.shape[0], counts.shape[0]
    out = torch.empty((2, T), dtype=torch.int32, device=events.device)
    if T == 0:
        return out[0], out[1]
    lib = _cuda.library("event_join")
    index = events.device.index
    blocks = max_blocks(index)
    # a fresh zeroed scratch for each call that needs one, so that two
    # streams never share it; the main path's shape needs none
    size = lib.event_join_scratch_ints(n, T, blocks)
    scratch = torch.zeros(size, dtype=torch.int32, device=events.device) if size else None
    err = lib.event_join_launch(
        events.data_ptr(), n, counts.data_ptr(), expected.data_ptr(), T, out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), blocks, index,
        torch.cuda.current_stream(events.device).cuda_stream)
    _cuda.check(err, lib, "event_join")
    launches += 1
    return out[0], out[1]


def roundtrip(host_in: torch.Tensor, n: int, T: int, host_out: torch.Tensor,
              scratch: torch.Tensor, blocks: int, stream: torch.cuda.Stream) -> None:
    """One host-to-host call of the kernel on ``stream``, then the stream
    synchronised: the kernel reads ``host_in[:n + 2T]`` (events, counts,
    expected) and writes its [2, T] into ``host_out`` itself, both pinned
    host memory, which the card addresses directly.  ``scratch`` holds 1 + T
    zeroed ints on the card, and holds them zeroed again after a call that
    returns; after one that raises it is the caller's to discard."""
    global launches
    for name, t in (("host_in", host_in), ("host_out", host_out)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_pinned():
            raise ValueError(f"event_join roundtrip: {name} must be pinned 1-D int32")
    if scratch.dtype != torch.int32 or scratch.device != stream.device:
        raise ValueError(f"event_join roundtrip: scratch must be int32 on {stream.device}")
    if host_in.numel() < n + 2 * T or host_out.numel() < 2 * T or scratch.numel() < 1 + T:
        raise ValueError(f"event_join roundtrip: buffers too small for n {n}, T {T}")
    lib = _cuda.library("event_join")
    err = lib.event_join_roundtrip(host_in.data_ptr(), n, T, host_out.data_ptr(),
                                   scratch.data_ptr(), blocks, stream.device.index,
                                   stream.cuda_stream)
    _cuda.check(err, lib, "event_join")
    launches += 1
