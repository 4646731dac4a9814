"""Mamba2 (SSD, state space duality) block: the chunked scan for the full
sequence and the single-step recurrence for decode.

The counterpart of the JAX package's ``models/ssm.py``, with its parameter
names and layouts, so weights convert by a rename.  Both paths use the
discretization h_t = exp(a·dt_t)·h_{t-1} + dt_t·B_t⊗x_t, y_t = C_t·h_t;
the short causal conv applies to the x branch only and B and C form a
single group shared by the heads, as in the reference.  Every weight is
cast to the activation dtype where it is used.

The full-sequence scan goes through ``kernels.ssd.ops.ssd``, the decode
step's state update through ``kernels.ssd.ops.ssd_step``: each the
hand-written kernel on a CUDA tensor, its plain version on the CPU.
The plain version is the JAX package's chunked path with one difference:
the intra-chunk decay is masked before its exp, where the reference
overflows to NaN for long chunks (``kernels/ssd/ref.py`` says when).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.ssd.ops import ssd, ssd_step
from ..kernels.ssd.ref import ssd_scan_torch
from .common import make_param
from .layers import RMSNorm, lsc, rms_norm


class Mamba2(nn.Module):
    def __init__(self, gen, d_model: int, d_inner: int, n_state: int,
                 headdim: int = 64, conv_width: int = 4, device=None, eps: float = 1e-5):
        super().__init__()
        H = d_inner // headdim
        self.wz = make_param(gen, (d_model, d_inner), ("embed", "ffn"), d_model ** -0.5,
                             device=device)
        self.wx = make_param(gen, (d_model, d_inner), ("embed", "ffn"), d_model ** -0.5,
                             device=device)
        self.conv_w = make_param(gen, (conv_width, d_inner), (None, "ffn"), 0.5, device=device)
        self.conv_b = make_param(gen, (d_inner,), ("ffn",), init="zeros", device=device)
        self.wB = make_param(gen, (d_model, n_state), ("embed", None), d_model ** -0.5,
                             device=device)
        self.wC = make_param(gen, (d_model, n_state), ("embed", None), d_model ** -0.5,
                             device=device)
        self.wdt = make_param(gen, (d_model, H), ("embed", None), d_model ** -0.5, device=device)
        self.dt_bias = make_param(gen, (H,), (None,), init="zeros", device=device)
        self.a_log = make_param(gen, (H,), (None,), init="zeros", device=device)  # a = -exp(a_log)
        self.d_skip = make_param(gen, (H,), (None,), init="ones", device=device)
        self.out_norm = RMSNorm(d_inner, device, eps)
        self.wo = make_param(gen, (d_inner, d_model), ("ffn", "embed"), d_inner ** -0.5,
                             device=device)


def _causal_conv(x, w, b):
    """Depthwise causal conv: x [B,S,Di], w [W,Di]."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(W))
    return out + b


def _ssd_chunked(xh, B_, C_, dt, a, chunk: int, decay_dtype=torch.float32):
    """The plain chunked scan in the reference's argument order: xh
    [B,S,H,P], B_/C_ [B,S,N], dt [B,S,H] (>0), a [H] (<0) → y [B,S,H,P] and
    the final state [B,H,N,P].  ``decay_dtype`` sets the type of the
    intra-chunk decay tile (the reference's hill-climb lever)."""
    return ssd_scan_torch(xh, dt, B_, C_, a, chunk, decay_dtype=decay_dtype)


def _dt_and_a(p: Mamba2, x):
    dt = F.softplus((x @ p.wdt.to(x.dtype)).float() + p.dt_bias.float())
    return dt, -torch.exp(p.a_log.float())


def mamba2_forward(p: Mamba2, x, chunk: int = 128, return_state: bool = False,
                   decay_dtype=torch.float32):
    """x [B,S,D] → [B,S,D] (the full-sequence prefill path); with
    ``return_state`` also (state [B,H,N,P] fp32, conv cache [B,W-1,Di]: the
    last W-1 pre-conv x-branch inputs)."""
    dtype = x.dtype
    z = torch.einsum("bsd,df->bsf", x, p.wz.to(dtype))
    raw = torch.einsum("bsd,df->bsf", x, p.wx.to(dtype))
    xb = F.silu(_causal_conv(raw, p.conv_w.to(dtype), p.conv_b.to(dtype)))
    xb = lsc(xb, "batch", "seq", "ffn")
    B_ = x @ p.wB.to(dtype)
    C_ = x @ p.wC.to(dtype)
    dt, a = _dt_and_a(p, x)
    H = a.shape[0]
    xh = xb.reshape(*xb.shape[:2], H, -1)
    y, state = ssd(xh, dt, B_, C_, a, chunk, decay_dtype=decay_dtype)
    y = y + xh * p.d_skip.to(dtype)[None, None, :, None]
    y = y.reshape(xb.shape)
    y = rms_norm(y, p.out_norm.w, p.out_norm.eps) * F.silu(z)
    out = torch.einsum("bsf,fd->bsd", y, p.wo.to(dtype))
    if return_state:
        W = p.conv_w.shape[0]
        return out, (state, raw[:, -(W - 1):, :])
    return out


def mamba2_decode(p: Mamba2, x, state, conv_cache):
    """Single-step recurrence.  x [B,1,D]; state [B,H,N,P] fp32 (as
    ``Model.cache_layout`` holds it); conv_cache [B,W-1,Di] holds the
    previous pre-conv x-branch inputs.  Writes the new state into ``state``
    (``ssd_step``: on the card one kernel that reads and writes it once)
    and the new conv cache into ``conv_cache``, in place, and returns (out
    [B,1,D], state, conv_cache): no new state is made, so a captured decode
    step can hold it (``models.decode_graph``)."""
    dtype = x.dtype
    z = torch.einsum("bsd,df->bsf", x, p.wz.to(dtype))[:, 0]
    raw = torch.einsum("bsd,df->bsf", x, p.wx.to(dtype))[:, 0]         # [B,Di]
    window = torch.cat([conv_cache.to(dtype), raw[:, None, :]], dim=1)  # [B,W,Di]
    xb = F.silu(torch.einsum("bwf,wf->bf", window, p.conv_w.to(dtype))
                + p.conv_b.to(dtype))
    B_ = (x[:, 0] @ p.wB.to(dtype)).float()
    C_ = (x[:, 0] @ p.wC.to(dtype)).float()
    dt, a = _dt_and_a(p, x[:, 0])                                       # [B,H]
    H = a.shape[0]
    y = ssd_step(state, xb.reshape(xb.shape[0], H, -1), dt, a, B_, C_, p.d_skip)
    y = rms_norm(y.reshape(xb.shape), p.out_norm.w, p.out_norm.eps) * F.silu(z)
    out = torch.einsum("bf,fd->bd", y, p.wo.to(dtype))[:, None, :]
    return out, state, conv_cache.copy_(window[:, 1:, :])
