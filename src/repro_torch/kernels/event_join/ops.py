"""Wrapper of the event-join kernel (``csrc/event_join.cu``).

``event_join`` runs the CUDA kernel on CUDA tensors and the plain torch
version (``ref.join_counts_torch``) on CPU tensors.  ``launches`` counts the
kernel's launches, so a run can show that its path went through it.
"""
from __future__ import annotations

import torch

from .. import _cuda
from .ref import join_counts_torch

launches = 0


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
    dropped), counts/expected [T] int32 → (new_counts, fired) [T] int32."""
    global launches
    _check(events, counts, expected)
    if events.device.type == "cpu":
        return join_counts_torch(events, counts, expected)
    if events.device.type != "cuda":
        raise ValueError(f"event_join: no kernel for device {events.device}")
    T = counts.shape[0]
    new_counts = torch.empty_like(counts)
    fired = torch.empty_like(counts)
    if T == 0:
        return new_counts, fired
    acc = torch.empty_like(counts)  # scratch, zeroed by the launch
    lib = _cuda.library("event_join")
    with torch.cuda.device(events.device):
        max_blocks = 2 * torch.cuda.get_device_properties(events.device).multi_processor_count
        err = lib.event_join_launch(
            events.data_ptr(), events.shape[0], counts.data_ptr(),
            expected.data_ptr(), T, acc.data_ptr(), new_counts.data_ptr(),
            fired.data_ptr(), max_blocks, torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, lib, "event_join")
    launches += 1
    return new_counts, fired
