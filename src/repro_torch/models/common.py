"""Parameter initialisers: seeded, on an explicit device, bf16 by default,
each parameter carrying its logical sharding axes.

The counterpart of the JAX package's ``make_param``.  A ``torch.Generator``
takes the place of the PRNG key; it gives other numbers than ``jax.random``
for the same seed, so tests that compare the two packages load the
reference's weights through ``models.convert.params_from_jax``.

``axes`` names one logical axis a dim (``None``: unsharded), as the
reference's ``Param.axes`` do; ``param_axes(model)`` reads them back and
``distributed.sharding`` resolves them to mesh placements.  The reference
stacks uniform layers on a leading ``"layers"`` axis; the port's layers are
a ``ModuleList``, so its leaves have no such axis.  On the ``meta`` device
a parameter is shape and dtype alone and draws nothing from a generator,
so a full-size model can be resolved without memory.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

Axes = Tuple[Optional[str], ...]


def make_param(gen: Optional[torch.Generator], shape: Sequence[int],
               axes: Sequence[Optional[str]], scale: Optional[float] = None,
               dtype: torch.dtype = torch.bfloat16, init: str = "normal",
               device=None) -> nn.Parameter:
    """A parameter of ``shape`` with logical ``axes`` (one a dim): zeros,
    ones, or normal · ``scale`` drawn in fp32 from ``gen`` (which must live
    on ``device``), then cast to ``dtype``.  ``scale`` defaults to the
    fan-in on dim 0, ``shape[0]**-0.5``.  On ``meta`` nothing is drawn."""
    if len(axes) != len(shape):
        raise ValueError(f"make_param: axes {tuple(axes)} do not name the {len(shape)} "
                         f"dims of {tuple(shape)}")
    if torch.device(device if device is not None else "cpu").type == "meta":
        v = torch.empty(shape, dtype=dtype, device="meta")
    elif init == "zeros":
        v = torch.zeros(shape, dtype=dtype, device=device)
    elif init == "ones":
        v = torch.ones(shape, dtype=dtype, device=device)
    else:
        if scale is None:
            scale = shape[0] ** -0.5
        v = (torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
             * scale).to(dtype)
    p = nn.Parameter(v, requires_grad=False)
    p.axes = tuple(axes)
    return p


def param_axes(model: nn.Module) -> Dict[str, Axes]:
    """Every parameter's logical axes, by its name in ``named_parameters``."""
    return {name: p.axes for name, p in model.named_parameters()}
