"""Logical-axis sharding rules (MaxText-style), resolved per tensor onto a
``DeviceMesh`` as DTensor placements.

Mesh axes: ``("data", "model")`` single-pod, ``("pod", "data", "model")``
multi-pod.  "pod" + "data" carry data parallelism + FSDP; "model" carries
tensor/expert parallelism (heads, ffn, vocab, experts) and optional
activation sequence-sharding (sequence parallelism between blocks).

Resolution is *shape-aware*, as the reference's: a mesh axis is applied to
a dim only when the dim is divisible by the axis size (granite's single KV
head or llama3.2's 24 heads stay replicated on a 16-way model axis), and a
mesh axis is used by one dim at most.  ``Resolver.spec`` gives the
reference's PartitionSpec as a tuple (``("data", "model", None)``; a dim
over two axes is a tuple of them); ``Resolver.placements`` turns it into
one ``Shard(d)``/``Replicate()`` per mesh dim.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from ..models.common import param_axes
from ..models.layers import reset_activation_resolver, set_activation_resolver

Spec = Tuple[Any, ...]


# logical axis -> preferred mesh axes (in priority order per logical axis)
def default_rules(cfg, mesh) -> Dict[str, Tuple[str, ...]]:
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    return {
        # activations
        "batch": data_axes,
        "seq": (),
        "act_seq": ("model",) if cfg.seq_shard_activations else (),
        # params
        "embed": ("data",),        # FSDP dim
        "embed2": (),
        "heads": ("model",),
        "kv_heads": ("model",),
        "head": (),
        "ffn": ("model",),
        "vocab": ("model",),
        "experts": ("model",),
        "layers": (),
        # caches
        "seq_kv": (),
    }


class Resolver:
    """Callable: (logical axes, shape) → placements on ``mesh``.  ``mesh``
    is a ``DeviceMesh`` (or anything with its ``mesh_dim_names`` and
    ``shape``, to resolve specs for a mesh that is not built)."""

    def __init__(self, cfg, mesh, overrides: Optional[Dict[str, Tuple[str, ...]]] = None):
        self.mesh = mesh
        self.rules = default_rules(cfg, mesh)
        if overrides:
            self.rules.update(overrides)
        self.sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))

    def spec(self, axes: Sequence[Optional[str]], shape: Sequence[int]) -> Spec:
        out = []
        used = set()
        for name, dim in zip(axes, shape):
            mesh_axes = self.rules.get(name, ()) if name else ()
            applied = []
            size = 1
            for ma in mesh_axes:
                if ma in used or ma not in self.sizes:
                    continue
                s = self.sizes[ma]
                if dim % (size * s) == 0:
                    applied.append(ma)
                    size *= s
            used.update(applied)
            if not applied:
                out.append(None)
            elif len(applied) == 1:
                out.append(applied[0])
            else:
                out.append(tuple(applied))
        return tuple(out)

    def placements(self, spec: Spec) -> tuple:
        """One placement per mesh dim: ``Shard(d)`` where the spec puts that
        mesh axis on tensor dim d, else ``Replicate()``.  A dim over two
        mesh axes is sharded by both, major to minor in mesh order; an
        order against the mesh's raises ``ValueError``."""
        names = list(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for d, entry in enumerate(spec):
            group = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
            order = [names.index(a) for a in group]
            if order != sorted(order):
                raise ValueError(f"spec {spec}: dim {d} is split over {group}, against "
                                 f"the mesh's order {tuple(names)}")
            for i in order:
                out[i] = Shard(d)
        return tuple(out)

    # activation resolver protocol for layers.lsc
    def __call__(self, axes, shape) -> tuple:
        if len(axes) != len(shape):
            axes = tuple(axes) + (None,) * (len(shape) - len(axes))
        return self.placements(self.spec(axes, shape))


def spec_of(mesh, placements, ndim: int) -> Spec:
    """The spec that ``placements`` on ``mesh`` realise: the inverse of
    ``Resolver.placements``."""
    dims: Dict[int, list] = {}
    for name, p in zip(mesh.mesh_dim_names, placements):
        if isinstance(p, Shard):
            dims.setdefault(p.dim, []).append(name)
        elif not isinstance(p, Replicate):
            raise ValueError(f"spec_of: {p} is neither Shard nor Replicate")
    return tuple(None if d not in dims else dims[d][0] if len(dims[d]) == 1
                 else tuple(dims[d]) for d in range(ndim))


def shardings_for(model: nn.Module, resolver: Resolver) -> Dict[str, tuple]:
    """Every parameter's placements, by name."""
    shapes = {name: p.shape for name, p in model.named_parameters()}
    return {name: resolver(axes, shapes[name]) for name, axes in param_axes(model).items()}


def distribute_model(model: nn.Module, resolver: Resolver) -> nn.Module:
    """Turn ``model``'s parameters into DTensors on the resolver's mesh, in
    place, each at its placements; their logical axes and ``requires_grad``
    stay.  Every rank must hold the same full parameters (the same seed).
    A parameter on the ``meta`` device becomes an empty one on the mesh's
    device first: under a ``FakeTensorMode`` (the dry-run) it holds no
    memory."""
    placements = shardings_for(model, resolver)
    owners = {name: model.get_submodule(name.rpartition(".")[0])
              for name in placements}
    for name, p in list(model.named_parameters()):
        full = p.detach()
        if full.is_meta:
            full = torch.empty(full.shape, dtype=full.dtype, device=resolver.mesh.device_type)
        new = nn.Parameter(distribute_tensor(full, resolver.mesh, placements[name]),
                           requires_grad=p.requires_grad)
        new.axes = p.axes
        setattr(owners[name], name.rpartition(".")[2], new)
    return model


def replicated(mesh) -> tuple:
    return (Replicate(),) * len(mesh.mesh_dim_names)


@contextlib.contextmanager
def activate(resolver: Resolver):
    """Run model code on the resolver's mesh: ``lsc`` constrains to its
    placements, and a plain tensor that meets a DTensor (RoPE tables,
    masks) is taken as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    token = set_activation_resolver(resolver)
    try:
        with implicit_replication():
            yield resolver
    finally:
        reset_activation_resolver(token)
