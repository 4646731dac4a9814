"""Backend dispatch for the event-join segmented sum.

The worker's batch plane reduces a routed event batch to per-trigger
activation counts (``new_counts``) and threshold-crossing flags (``fired``).
It calls a ``JoinFn``: int32 numpy arrays in (``events`` holds trigger row
ids, −1 = padding; ``counts`` and ``expected`` one entry per row), numpy
``(new_counts, fired)`` out — the reference's contract, so the copied
``core/batch.py`` stays as it is.  The backends:

* ``cuda:<index>`` — the CUDA kernel (``ops.event_join``) on that device,
  bound when the backend is built.  Raises where CUDA is absent;
* ``torch`` — the kernel's wrapper on CPU tensors, i.e. its plain torch
  version: a CPU worker runs the same wrapper (its input checks, dropped
  out-of-range ids, empty batch) that the card runs;
* ``off``   — no backend: the worker runs without its vector join plane.

``auto`` and bare ``cuda`` are not backends here: the worker resolves both
from its own device (``core/worker.py``).  ``jax``, ``pallas`` and ``numpy``
are the reference's backends and raise.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

JoinFn = Callable[[np.ndarray, np.ndarray, np.ndarray],
                  Tuple[np.ndarray, np.ndarray]]


def _torch_join(events: np.ndarray, counts: np.ndarray,
                expected: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    from .ops import event_join

    nc, fired = event_join(*(torch.from_numpy(np.ascontiguousarray(a, np.int32))
                             for a in (events, counts, expected)))
    return nc.numpy(), fired.numpy()


class CudaJoin:
    """The kernel on one card, fixed when the backend is built: every call
    copies its inputs to ``device`` and launches there."""

    def __init__(self, device: torch.device) -> None:
        if device.type != "cuda" or device.index is None:
            raise ValueError(f"a CUDA join backend needs a device index, got "
                             f"{str(device)!r} (name it 'cuda:<index>')")
        if not torch.cuda.is_available():
            raise RuntimeError(f"join backend {str(device)!r} needs a CUDA device, "
                               "and none is available (use 'torch' on the CPU)")
        self.device = device

    def __call__(self, events, counts, expected):
        from .ops import event_join

        n, T = events.shape[0], counts.shape[0]
        # one host-to-device copy for all three inputs
        host = np.concatenate([np.asarray(events, np.int32),
                               np.asarray(counts, np.int32),
                               np.asarray(expected, np.int32)])
        dev = torch.from_numpy(host).to(self.device)
        nc, fired = event_join(dev[:n], dev[n:n + T], dev[n + T:])
        return nc.cpu().numpy(), fired.cpu().numpy()


def resolve_join_backend(name: str) -> Tuple[str, Optional[JoinFn]]:
    """Resolve a backend name to ``(resolved_name, fn)``; ``fn`` is ``None``
    for ``off``.  A backend that cannot run raises; no name falls back to
    another, and nothing is cached, so each call builds its own backend."""
    name = (name or "auto").lower()
    if name in ("auto", "cuda"):
        raise ValueError(f"name a join backend: {name!r} is resolved by the worker "
                         "from its device")
    if name == "off":
        return "off", None
    if name == "torch":
        return "torch", _torch_join
    if name.startswith("cuda:"):
        join = CudaJoin(torch.device(name))
        return str(join.device), join
    if name in ("jax", "pallas", "numpy"):
        raise ValueError(f"join backend {name!r} belongs to the JAX package; "
                         "the port has 'cuda:<index>', 'torch' and 'off'")
    raise ValueError(f"unknown join backend {name!r}")


def join_counts_segments(lens, counts: np.ndarray, expected: np.ndarray,
                         fn: JoinFn) -> Tuple[np.ndarray, np.ndarray]:
    """Segmented-sum join over *contiguous runs*: ``lens[i]`` events belong
    to trigger row ``i``.  This is the shape the columnar ingest path
    produces, so the row-id expansion lives here next to the kernel instead
    of in every caller."""
    event_rows = np.repeat(np.arange(len(lens), dtype=np.int32), lens)
    return fn(event_rows, counts, expected)
