"""Backend dispatch for the event-join segmented sum.

The worker's batch plane reduces a routed event batch to per-trigger
activation counts (``new_counts``) and threshold-crossing flags (``fired``).
It calls a ``JoinFn``: int32 numpy arrays in (``events`` holds trigger row
ids, −1 = padding; ``counts`` and ``expected`` one entry per row), numpy
``(new_counts, fired)`` out — the reference's contract, so the copied
``core/batch.py`` stays as it is.  The backends:

* ``cuda:<index>`` — the CUDA kernel on that device (``CudaJoin``, one
  launch a call on pinned buffers), bound when the backend is built.  Raises
  where CUDA is absent;
* ``torch`` — the kernel's wrapper on CPU tensors, i.e. its plain torch
  version: a CPU worker runs the same wrapper (its input checks, dropped
  out-of-range ids, empty batch) that the card runs;
* ``off``   — no backend: the worker runs without its vector join plane.

``auto`` and bare ``cuda`` are not backends here: the worker resolves both
from its own device (``core/worker.py``).  ``jax``, ``pallas`` and ``numpy``
are the reference's backends and raise.

A join that fails, in any backend, raises ``JoinBackendError`` out of
``join_counts_segments``, and the worker lets it out of ``run_once``: the
batch fails, as any failed batch does (a shard process dies and the pool
records a crash); the Python path never takes it over.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional, Tuple

import numpy as np
import torch

JoinFn = Callable[[np.ndarray, np.ndarray, np.ndarray],
                  Tuple[np.ndarray, np.ndarray]]


class JoinBackendError(RuntimeError):
    """A join backend failed: its build, its launch, its synchronisation or
    its plain version.  The cause is chained (``__cause__``)."""


def _torch_join(events: np.ndarray, counts: np.ndarray,
                expected: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    from .ops import event_join

    nc, fired = event_join(*(torch.from_numpy(np.ascontiguousarray(a, np.int32))
                             for a in (events, counts, expected)))
    return nc.numpy(), fired.numpy()


def pack_inputs(buf: np.ndarray, events, counts, expected) -> Tuple[int, int]:
    """Write events, counts and expected one after the other into ``buf``
    (int32, at least n + 2T long), the layout the kernel reads; returns
    (n, T)."""
    n, T = len(events), len(counts)
    if len(expected) != T:
        raise ValueError(f"event_join: counts ({T}) and expected ({len(expected)}) differ")
    np.copyto(buf[:n], events)
    np.copyto(buf[n:n + T], counts)
    np.copyto(buf[n + T:n + 2 * T], expected)
    return n, T


def unpack_outputs(out: np.ndarray, T: int) -> Tuple[np.ndarray, np.ndarray]:
    """(new_counts, fired) from the kernel's [2, T] output, as two fresh
    arrays: the next call overwrites ``out``."""
    return out[:T].copy(), out[T:2 * T].copy()


def grown(capacity: int, need: int) -> int:
    """A buffer's capacity once it must hold ``need``: unchanged while it
    does, else at least doubled."""
    return capacity if need <= capacity else max(need, 2 * capacity)


class CudaJoin:
    """The kernel on one card, fixed when the backend is built.  Per call:
    the inputs packed into a pinned buffer, then one C call that launches
    the kernel on the backend's own stream, reading that buffer and writing
    a pinned [2, T] output across PCIe (no copy either way), and
    synchronises that stream, so a join never waits for model work queued on
    PyTorch's current stream.  The stream, the pinned buffers (grown by
    doubling) and the kernel's zeroed scratch are made at the first call
    that needs them, never in ``__init__``: a process may build the backend
    before it forks, and a CUDA context does not survive a fork.  A lock
    keeps two threads off the buffers.  A call that fails raises and drops
    them all, the scratch included; nothing falls back to the CPU."""

    def __init__(self, device: torch.device) -> None:
        if device.type != "cuda" or device.index is None:
            raise ValueError(f"a CUDA join backend needs a device index, got "
                             f"{str(device)!r} (name it 'cuda:<index>')")
        if not torch.cuda.is_available():
            raise RuntimeError(f"join backend {str(device)!r} needs a CUDA device, "
                               "and none is available (use 'torch' on the CPU)")
        self.device = device
        self._lock = threading.Lock()
        self._drop()

    def _drop(self) -> None:
        self._stream: Optional[torch.cuda.Stream] = None
        self._blocks = 0
        # capacities in ints: n + 2T for the inputs; T for the [2, T] outputs
        # and the scratch of 1 + T (the kernel's ticket, then its acc[T])
        self._cap_in = self._cap_t = 0
        self._host_in = self._host_out = self._scratch = None
        self._host_in_np = self._host_out_np = None

    def _reserve(self, n: int, T: int) -> None:
        cap_in, cap_t = grown(self._cap_in, n + 2 * T), grown(self._cap_t, T)
        if (cap_in, cap_t) == (self._cap_in, self._cap_t):
            return
        if self._stream is None:
            self._open()
        if cap_in != self._cap_in:
            self._host_in = self._pinned(cap_in)
            self._host_in_np = self._host_in.numpy()
            self._cap_in = cap_in
        if cap_t != self._cap_t:
            self._host_out = self._pinned(2 * cap_t)
            self._host_out_np = self._host_out.numpy()
            self._scratch = self._zeroed_scratch(1 + cap_t)
            self._cap_t = cap_t

    # the card's side of the backend: its stream, its buffers and its launch
    # (the CPU tests put host tensors and the plain version in their place)
    def _open(self) -> None:
        from .ops import max_blocks

        self._stream = torch.cuda.Stream(self.device)
        self._blocks = max_blocks(self.device.index)

    def _pinned(self, ints: int) -> torch.Tensor:
        with torch.cuda.device(self.device):
            return torch.empty(ints, dtype=torch.int32, pin_memory=True)

    def _zeroed_scratch(self, ints: int) -> torch.Tensor:
        # zeroed once, on the backend's stream, ahead of every launch that uses it
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            return torch.zeros(ints, dtype=torch.int32, device=self.device)

    def _launch(self, n: int, T: int) -> None:
        from .ops import roundtrip

        roundtrip(self._host_in, n, T, self._host_out, self._scratch, self._blocks,
                  self._stream)

    def __call__(self, events, counts, expected):
        T = len(counts)
        if T == 0 == len(expected):
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        with self._lock:
            try:
                self._reserve(len(events), T)
                n, T = pack_inputs(self._host_in_np, events, counts, expected)
                self._launch(n, T)
            except Exception:
                self._drop()
                raise
            return unpack_outputs(self._host_out_np, T)


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
    try:
        event_rows = np.repeat(np.arange(len(lens), dtype=np.int32), lens)
        return fn(event_rows, counts, expected)
    except Exception as exc:
        raise JoinBackendError(f"the event join failed in its backend: {exc!r}") from exc
