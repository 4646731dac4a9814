"""Gradient/delta compression for cross-node exchange (large-scale posture:
FL clients and async-DP workers ship int8-quantized updates — 4× wire/store
reduction vs fp32).

Symmetric per-tensor int8 quantization with a stochastic-rounding option
(unbiased in expectation, the standard trick to keep SGD convergent under
aggressive quantization).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


def quantize_int8(x: np.ndarray, rng: Optional[np.random.Generator] = None
                  ) -> Dict[str, Any]:
    x = np.asarray(x, np.float32)
    scale = float(np.max(np.abs(x))) / 127.0 if x.size else 0.0
    if scale == 0.0:
        return {"q": np.zeros(x.shape, np.int8), "scale": 0.0,
                "shape": list(x.shape)}
    y = x / scale
    if rng is not None:  # stochastic rounding: unbiased
        low = np.floor(y)
        y = low + (rng.random(y.shape) < (y - low))
    else:
        y = np.rint(y)
    return {"q": np.clip(y, -127, 127).astype(np.int8), "scale": scale,
            "shape": list(x.shape)}


def dequantize_int8(packed: Dict[str, Any]) -> np.ndarray:
    return packed["q"].astype(np.float32) * packed["scale"]


def compressed_bytes(packed: Dict[str, Any]) -> int:
    return int(np.asarray(packed["q"]).nbytes) + 8  # payload + scale


def compress_delta(new: np.ndarray, base: np.ndarray,
                   rng: Optional[np.random.Generator] = None) -> Dict[str, Any]:
    """Quantize the *difference* from the base model (deltas are small and
    centred — much friendlier to int8 than raw weights)."""
    return quantize_int8(np.asarray(new, np.float32)
                         - np.asarray(base, np.float32), rng)


def apply_delta(base: np.ndarray, packed: Dict[str, Any]) -> np.ndarray:
    return np.asarray(base, np.float32) + dequantize_int8(packed)
