"""The device a Triggerflow runs on: the port's counterpart of JAX's implicit
placement.

``resolve_device`` fixes it once, as a ``torch.device`` with an index on
CUDA (bare ``"cuda"`` names the current card at that moment), so that the
worker's join kernel and the serving model land on the same card whatever
the current device is later.  A CUDA device without CUDA raises; nothing
falls back to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(device)!r} but CUDA is not available; "
                               "pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
