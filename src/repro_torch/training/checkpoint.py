"""Checkpoints on local disk, in the JAX package's layout, atomically.

A checkpoint is ``<path>/step_XXXXXXXX/`` holding ``params.npz``,
``opt_state.npz`` and ``meta.json``.  Each ``.npz`` holds a nested dict's
leaves keyed by their ``/``-joined path, bf16 stored as fp32 (its dtype
restored on load); ``save`` writes a temp dir and renames it, so a crash
mid-save never corrupts the latest checkpoint, and keeps the last ``keep``.
This is the reference's format: given the reference's tree (for a model,
``models.convert.params_to_jax``, which stacks the layer axis where the
reference does), the files are the reference's, so a checkpoint written by
either package restores in the other.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for key, leaf in tree.items():
        name = f"{prefix}{key}"
        if isinstance(leaf, dict):
            flat.update(_flatten(leaf, name + "/"))
        elif isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
            if leaf.dtype == torch.bfloat16:
                leaf = leaf.float()
            flat[name] = leaf.cpu().numpy()
        else:
            flat[name] = np.asarray(leaf)
    return flat


def save(path: str, step: int, params, opt_state=None, extra: Optional[dict] = None,
         keep: int = 3) -> str:
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f".tmp-{step}")
    final = os.path.join(path, f"step_{step:08d}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "params.npz"), **_flatten(params))
    if opt_state is not None:
        np.savez(os.path.join(tmp, "opt_state.npz"), **_flatten(opt_state))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, **(extra or {})}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish
    _gc(path, keep)
    return final


def _gc(path: str, keep: int) -> None:
    ckpts = sorted(d for d in os.listdir(path) if d.startswith("step_"))
    for d in ckpts[:-keep]:
        shutil.rmtree(os.path.join(path, d), ignore_errors=True)


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    ckpts = sorted(d for d in os.listdir(path) if d.startswith("step_"))
    return int(ckpts[-1].split("_")[1]) if ckpts else None


def _unflatten(flat, like, prefix: str = ""):
    """``like``'s structure with each leaf read from ``flat`` (an open
    ``.npz``) under its path, in the leaf's dtype and on its device (a leaf
    that is not a tensor comes back as an int or float of the stored
    value)."""
    out: Dict[str, Any] = {}
    for key, leaf in like.items():
        name = f"{prefix}{key}"
        if isinstance(leaf, dict):
            out[key] = _unflatten(flat, leaf, name + "/")
        elif isinstance(leaf, torch.Tensor):
            out[key] = torch.from_numpy(np.asarray(flat[name])).to(leaf.device, leaf.dtype)
        else:
            out[key] = type(leaf)(flat[name])
    return out


def restore(path: str, params_like, opt_like=None,
            step: Optional[int] = None) -> Tuple[int, Any, Any, dict]:
    step = latest_step(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with np.load(os.path.join(d, "params.npz")) as npz:
        params = _unflatten(npz, params_like)
    opt_state = None
    if opt_like is not None and os.path.exists(os.path.join(d, "opt_state.npz")):
        with np.load(os.path.join(d, "opt_state.npz")) as npz:
            opt_state = _unflatten(npz, opt_like)
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    return step, params, opt_state, meta
