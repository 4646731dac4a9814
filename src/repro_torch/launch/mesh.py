"""Mesh construction over torch's ``DeviceMesh``, with the reference's
shapes and axis names.

Kept as functions (never module-level constants), so importing this module
touches no process group: the dry-run must install its fake group before
any mesh is made, as the reference's ``XLA_FLAGS`` must precede JAX's
start.  A mesh spans the default process group, which the caller
initialises (``torch.distributed.init_process_group``) with a world size
equal to the mesh's size.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """16×16 = 256 ranks a pod, axes ("data", "model"); ``multi_pod`` adds a
    leading 2-pod axis, ("pod", "data", "model") over 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cuda") -> DeviceMesh:
    """Every rank of the default group on one ("data",) axis: on one card,
    the (1,) mesh of a one-rank group."""
    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=("data",))
