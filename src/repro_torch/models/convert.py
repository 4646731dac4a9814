"""Weights between the JAX package and the port.

``params_from_jax(tree)`` turns the reference's unboxed params — a nested
dict of numpy arrays, as ``jax.device_get(unbox(model.init(key)))`` gives
it — into the port's ``state_dict``.  The layouts are the same, so this is
a rename (path parts joined by ``.``) plus a split of the stacked layer
axis: ``layers/attn/wq[i]`` becomes ``layers.{i}.attn.wq``.  A model built
with ``scan_layers=False`` (zamba2) has its layers unstacked already, as
``layers/l{i}/…`` and ``shared_proj/s{i}``; they become ``layers.{i}.…``
and ``shared_proj.{i}``.  The other families need no rule of their own:
audio's ``embed`` [K,V,D] and ``heads`` [K,D,V] keep their names, the
MoE's stacked ``layers/moe/{router,wg,wu,wd}`` and ``layers/moe/shared/…``
split like any stacked leaf, and mla_moe's unstacked ``layer0/…`` keeps
its name beside its stack ``layers``, whose index i is the reference's
layer i + 1 in both packages.  xlstm's layers are unstacked as the
hybrid's: ``layers/l{i}/{norm,mlstm,slstm}/…``.  A bf16 leaf
arrives as an ``ml_dtypes.bfloat16`` array, which torch cannot read; it goes
through fp32, which holds every bf16 value exactly.

``params_to_jax(state, cfg)`` is the inverse: a ``state_dict`` (or any
mapping keyed by the port's parameter names, such as the optimizer's
moments) back to the reference's nested layout, the layer axis stacked
where the reference stacks it (``cfg.scan_layers``, outside the hybrid and
xlstm families), as torch tensors on their own device.
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Any, Dict, Mapping

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _flatten(tree, prefix: str, out: Dict[str, Any]) -> None:
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            _flatten(val, name + ".", out)
        else:
            out[name] = val


# an unstacked layer or site: ``layers.l3.…`` → ``layers.3.…``
_UNSTACKED = re.compile(r"^(layers|shared_proj)\.[ls](\d+)(\.|$)")


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    flat: Dict[str, Any] = {}
    _flatten(tree, "", flat)
    state: Dict[str, torch.Tensor] = {}
    for name, leaf in flat.items():
        head, _, rest = name.partition(".")
        if _UNSTACKED.match(name):
            state[_UNSTACKED.sub(r"\1.\2\3", name)] = _tensor(leaf)
        elif head == "layers":
            for i, layer in enumerate(np.asarray(leaf)):
                state[f"layers.{i}.{rest}"] = _tensor(layer)
        else:
            state[name] = _tensor(leaf)
    return state


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        *parents, last = path.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def params_to_jax(state: Mapping[str, torch.Tensor], cfg) -> Dict[str, Any]:
    stacked = cfg.scan_layers and cfg.family not in ("hybrid", "xlstm")
    flat: Dict[str, Any] = {}
    layers: Dict[str, Dict[int, torch.Tensor]] = defaultdict(dict)
    for name, t in state.items():
        head, _, rest = name.partition(".")
        if head in ("layers", "shared_proj"):
            i, _, rest = rest.partition(".")
            if head == "layers" and stacked:
                layers[rest][int(i)] = t
                continue
            name = f"{head}.{head[0]}{i}" + (f".{rest}" if rest else "")
        flat[name.replace(".", "/")] = t
    for rest, by_layer in layers.items():
        flat["layers/" + rest.replace(".", "/")] = torch.stack(
            [by_layer[i] for i in range(len(by_layer))])
    return _nest(flat)
