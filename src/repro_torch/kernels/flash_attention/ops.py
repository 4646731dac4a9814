"""Wrapper of the flash attention kernel (``csrc/flash_attention.cu``).

``flash_attention`` keeps the reference's [B,S,H,D] layout at its interface.
On CUDA tensors it launches the kernel, which reads q, k and v through their
strides (no transpose copies); on CPU tensors it runs the kernel's plain
version, ``ref.flash_attention_torch``.  ``launches`` counts the kernel's
launches.
"""
from __future__ import annotations

import math

import torch

from .. import _cuda
from .ref import flash_attention_torch

launches = 0

_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k and v must be [B,S,H,D]")
    B, S, Hq, D = q.shape
    if k.shape[:2] != (B, S) or v.shape[:3] != k.shape[:3] or k.shape[3] != D:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    if Hq % k.shape[2]:
        raise ValueError(f"flash_attention: {Hq} query heads are not a multiple "
                         f"of {k.shape[2]} kv heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; all must be one of {_DTYPES}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must be on one device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q [B,S,Hq,D], k [B,S,Hkv,D], v [B,S,Hkv,Dv] → [B,S,Hq,Dv] in q's
    dtype; query head h reads kv head h // (Hq // Hkv)."""
    global launches
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    B, S, Hq, D = q.shape
    Hkv, Dv = k.shape[2], v.shape[3]
    if D > MAX_HEAD_DIM or Dv > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dims {D}, {Dv} exceed {MAX_HEAD_DIM}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: the last dim of q, k and v must be "
                         "contiguous")
    out = torch.empty(B, S, Hq, Dv, dtype=q.dtype, device=q.device)
    lib = _cuda.library("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, Hq, Hkv, D, Dv,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(causal), 1.0 / math.sqrt(D), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, lib, "flash_attention")
    launches += 1
    return out
