"""Wrapper of the SSD scan kernel (``csrc/ssd_scan.cu``).

``ssd`` keeps the model's [B,S,H,P] layout at its interface, with B and C
shared across heads as [B,S,N].  On CUDA tensors it launches the kernel,
which reads x, dt, B and C through their strides (no transpose and no
per-head copies of B and C); on CPU tensors it runs the kernel's plain
version, ``ref.ssd_scan_torch``.  This is the one place the model's SSD
picks its device.  ``launches`` counts the kernel's launches.
"""
from __future__ import annotations

import torch

from .. import _cuda
from .ref import ssd_scan_torch

launches = 0

_DTYPES = (torch.float32, torch.bfloat16)
SMEM_LIMIT = 232_448    # bytes of shared memory a block may opt into on sm_90
MAX_CHUNK = 128         # the kernel's tiles hold at most 128 steps


def smem_bytes(Q: int, N: int, P: int) -> int:
    """Dynamic shared memory of one block, as ``ssd_scan.cu`` lays it out:
    the [N,P] state, the x tile, the B and C tiles (rows padded by one), the
    [Q,Q] mixing tile and four per-step vectors, all fp32."""
    return 4 * (N * P + Q * P + 2 * Q * (N + 1) + Q * Q + 4 * Q)


def _check(x, dt, Bm, Cm, a) -> None:
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() != 3 or Cm.dim() != 3 or a.dim() != 1:
        raise ValueError("ssd: x must be [B,S,H,P], dt [B,S,H], Bm and Cm [B,S,N], a [H]")
    B, S, H, P = x.shape
    if dt.shape != (B, S, H) or Bm.shape[:2] != (B, S) or Cm.shape != Bm.shape \
            or a.shape != (H,):
        raise ValueError(f"ssd: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, a {tuple(a.shape)} "
                         "do not agree")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"ssd: x, Bm and Cm must share one dtype of {_DTYPES}, got "
                         f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"ssd: dt and a must be float32, got {dt.dtype}, {a.dtype}")
    if any(t.device != x.device for t in (dt, Bm, Cm, a)):
        raise ValueError("ssd: all inputs must be on one device")


def ssd(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
        a: torch.Tensor, chunk: int = 128, decay_dtype: torch.dtype = torch.float32):
    """x [B,S,H,P], dt [B,S,H], Bm/Cm [B,S,N] (shared across heads), a [H]
    → (y [B,S,H,P] in x's dtype, state [B,H,N,P] fp32), in chunks of
    min(chunk, S) steps.  ``decay_dtype`` is the plain version's (see
    ``ssd_scan_torch``); the kernel computes its decay in fp32 only."""
    global launches
    _check(x, dt, Bm, Cm, a)
    if x.device.type == "cpu":
        return ssd_scan_torch(x, dt, Bm, Cm, a, chunk, decay_dtype=decay_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: no kernel for device {x.device}")
    if decay_dtype != torch.float32:
        raise NotImplementedError(
            f"ssd: decay_dtype {decay_dtype}: the SSD kernel computes its decay in "
            "float32 only (ROADMAP.md, §2, K3)")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if Q < 1 or Q > MAX_CHUNK:
        raise ValueError(f"ssd: chunk {Q} is outside the kernel's [1, {MAX_CHUNK}]")
    if smem_bytes(Q, N, P) > SMEM_LIMIT:
        raise ValueError(f"ssd: chunk {Q}, N {N}, P {P} need {smem_bytes(Q, N, P)} "
                         f"bytes of shared memory, over the {SMEM_LIMIT} a block has")
    if x.stride(3) != 1 or Bm.stride(2) != 1 or Cm.stride(2) != 1 or not a.is_contiguous():
        raise ValueError("ssd: the last dim of x, Bm and Cm, and a, must be contiguous")
    y = torch.empty(B, S, H, P, dtype=x.dtype, device=x.device)
    state = torch.empty(B, H, N, P, dtype=torch.float32, device=x.device)
    lib = _cuda.library("ssd_scan")
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), a.data_ptr(),
            y.data_ptr(), state.data_ptr(), B, S, H, P, N, Q,
            x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2),
            Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, lib, "ssd_scan")
    launches += 1
    return y, state
