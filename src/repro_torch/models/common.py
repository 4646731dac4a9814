"""Parameter initialisers: seeded, on an explicit device, bf16 by default.

The counterpart of the JAX package's ``make_param``.  A ``torch.Generator``
takes the place of the PRNG key; it gives other numbers than ``jax.random``
for the same seed, so tests that compare the two packages load the
reference's weights through ``models.convert.params_from_jax``.  Logical
sharding axes are not carried yet (ROADMAP.md, open item 1, step 7).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn


def make_param(gen: torch.Generator, shape: Sequence[int],
               scale: Optional[float] = None, dtype: torch.dtype = torch.bfloat16,
               init: str = "normal", device=None) -> nn.Parameter:
    """A parameter of ``shape``: zeros, ones, or normal · ``scale`` drawn in
    fp32 from ``gen`` (which must live on ``device``), then cast to
    ``dtype``.  ``scale`` defaults to the fan-in on dim 0, ``shape[0]**-0.5``."""
    if init == "zeros":
        v = torch.zeros(shape, dtype=dtype, device=device)
    elif init == "ones":
        v = torch.ones(shape, dtype=dtype, device=device)
    else:
        if scale is None:
            scale = shape[0] ** -0.5
        v = (torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
             * scale).to(dtype)
    return nn.Parameter(v, requires_grad=False)
