"""FakeTensor input stand-ins for every (arch × shape) cell, with the
reference's shapes and dtypes: the dry-run traces against these; nothing
is ever allocated.  Each function makes its tensors under ``mode`` (a
``FakeTensorMode``; a new one where none is given), on ``cpu``."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import SHAPES
from repro_torch.models import Model, ModelConfig

I32 = torch.int32


def _fake(mode: FakeTensorMode, shape, dtype) -> torch.Tensor:
    with mode:
        return torch.empty(shape, dtype=dtype, device="cpu")


def batch_specs(cfg: ModelConfig, shape_name: str,
                mode: Optional[FakeTensorMode] = None) -> Dict[str, Any]:
    mode = mode or FakeTensorMode()
    s = SHAPES[shape_name]
    B, S = s["batch"], s["seq"]
    kind = s["kind"]
    if kind == "decode":
        if cfg.family == "audio":
            return {"tokens": _fake(mode, (B, cfg.codebooks, 1), I32)}
        return {"tokens": _fake(mode, (B, 1), I32)}
    if cfg.family == "audio":
        batch = {"tokens": _fake(mode, (B, cfg.codebooks, S), I32)}
        if kind == "train":
            batch["targets"] = _fake(mode, (B, cfg.codebooks, S), I32)
        return batch
    batch = {"tokens": _fake(mode, (B, S), I32)}
    if kind == "train":
        batch["targets"] = _fake(mode, (B, S), I32)
    if cfg.family == "vlm":
        batch["patch_embeds"] = _fake(mode, (B, cfg.n_patches, cfg.d_model), cfg.dtype)
        batch["patch_positions"] = _fake(mode, (B, cfg.n_patches), I32)
        batch["positions3"] = _fake(mode, (B, S, 3), I32)
    return batch


def cache_specs(cfg: ModelConfig, shape_name: str,
                mode: Optional[FakeTensorMode] = None) -> Dict[str, Any]:
    """The decode cache: each tensor of ``Model.cache_layout``, and ``pos``
    as the reference's int32 scalar (the port's decode takes it as an
    int)."""
    mode = mode or FakeTensorMode()
    s = SHAPES[shape_name]
    layout = Model(cfg, device="meta").cache_layout(s["batch"], s["seq"])
    out = {name: _fake(mode, shape, dtype) for name, (shape, dtype, _) in layout.items()}
    out["pos"] = _fake(mode, (), I32)
    return out


def input_specs(cfg: ModelConfig, shape_name: str,
                mode: Optional[FakeTensorMode] = None) -> Dict[str, Any]:
    """Everything the step function needs, as FakeTensors."""
    mode = mode or FakeTensorMode()
    s = SHAPES[shape_name]
    out = {"kind": s["kind"], "batch": batch_specs(cfg, shape_name, mode)}
    if s["kind"] == "decode":
        out["cache"] = cache_specs(cfg, shape_name, mode)
    return out
