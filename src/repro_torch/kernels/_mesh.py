"""K2 and K3 on a mesh: the kernels read ``data_ptr()``, so a DTensor is
never handed to them.  ``flash_attention``, ``ssd`` and ``ssd_step`` given
DTensors run their own route (the kernel on the card, its plain version on
the CPU) on each rank's local shards through ``local_map``, the
counterpart of what GSPMD does around a Pallas call.

The layout comes from the installed activation resolver's placements for
("batch", "seq", "heads", None) (``models.layers.set_activation_resolver``;
without one, the first input's own placements), and every input is
redistributed to it before the call: a sequence split between blocks
(``act_seq``) is made whole there, as the reference's ``lsc(q, "batch",
"seq", "heads", None)`` does.  A kernel takes batch and heads split; any
other layout raises ``ValueError`` and is never gathered whole behind the
caller's back.  ``ssd_step`` runs at its state's own placements instead,
since it updates the state in place.
"""
from __future__ import annotations

import math


def is_dtensor(t) -> bool:
    return type(t).__name__ == "DTensor"


def base_placements(x, what: str) -> tuple:
    """The placements the kernel runs at for x [B,S,H,...]: Replicate,
    Shard(0) (batch) or Shard(2) (heads) on each mesh dim."""
    from ..models.layers import _ACT_RESOLVER

    resolver = _ACT_RESOLVER.get()
    placements = (tuple(resolver(("batch", "seq", "heads", None), x.shape))
                  if resolver is not None else tuple(x.placements))
    for p in placements:
        if not (p.is_replicate() or p.is_shard(0) or p.is_shard(2)):
            raise ValueError(f"{what} on a mesh: placements {placements} for "
                             f"{tuple(x.shape)}; the kernel takes batch (dim 0) and "
                             f"heads (dim 2) split, the rest whole")
    return placements


def heads_split(mesh, placements) -> int:
    """How many ranks split the heads (dim 2)."""
    return math.prod(mesh.size(i) for i, p in enumerate(placements) if p.is_shard(2))


def run(fn, args, in_placements, out_placements, mesh, grad_placements=None):
    """``fn`` on each rank's local shards: ``in_placements`` one per
    argument, ``out_placements`` a list for one output, a tuple of lists
    for several (``local_map``'s convention).  ``grad_placements`` (one
    per argument; the in-placements by default) are the placements of each
    argument's gradient: partial where the argument is whole on a mesh dim
    but meets only one shard of the others, as a weight shared by a split
    batch does."""
    from torch.distributed.tensor.experimental import local_map

    return local_map(fn, out_placements=out_placements, in_placements=in_placements,
                     in_grad_placements=grad_placements, redistribute_inputs=True,
                     device_mesh=mesh)(*args)
