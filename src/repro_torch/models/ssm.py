"""Mamba2 (SSD, state space duality) block: the chunked scan for the full
sequence and the single-step recurrence for decode.

The counterpart of the JAX package's ``models/ssm.py``, with its parameter
names and layouts, so weights convert by a rename.  Both paths use the
discretization h_t = exp(a·dt_t)·h_{t-1} + dt_t·B_t⊗x_t, y_t = C_t·h_t;
the short causal conv applies to the x branch only and B and C form a
single group shared by the heads, as in the reference.  Every weight is
cast to the activation dtype where it is used.

Three options, each off by default (the reference's form), give the
published Mamba2 mixer as Nemotron-H runs it (``MambaRMSNormGated`` with
``norm_before_gate`` false):

- ``n_groups`` G: B and C are G groups of N, head h reading group
  h // (H/G) (``wB`` and ``wC`` [D, G·N]);
- ``conv_bc``: one causal depthwise conv with bias over [x, B, C] together,
  SiLU after it; the decode window holds the last W-1 pre-conv rows of all
  three, [B, W-1, Di + 2GN];
- ``gate_norm_groups``: the gate first, y·silu(z), then an RMSNorm over each
  group of Di/G channels (in fp32, as its statistics), times the weight.

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
                 headdim: int = 64, conv_width: int = 4, device=None, eps: float = 1e-5,
                 n_groups: int = 1, conv_bc: bool = False, gate_norm_groups: bool = False):
        super().__init__()
        H = d_inner // headdim
        if H % n_groups or d_inner % n_groups:
            raise ValueError(f"Mamba2: {H} heads of {headdim} in {n_groups} groups")
        self.n_groups, self.conv_bc, self.gate_norm_groups = n_groups, conv_bc, gate_norm_groups
        GN = n_groups * n_state
        conv_dim, conv_axes = (d_inner + 2 * GN, None) if conv_bc else (d_inner, "ffn")
        self.wz = make_param(gen, (d_model, d_inner), ("embed", "ffn"), d_model ** -0.5,
                             device=device)
        self.wx = make_param(gen, (d_model, d_inner), ("embed", "ffn"), d_model ** -0.5,
                             device=device)
        self.conv_w = make_param(gen, (conv_width, conv_dim), (None, conv_axes), 0.5,
                                 device=device)
        self.conv_b = make_param(gen, (conv_dim,), (conv_axes,), init="zeros", device=device)
        self.wB = make_param(gen, (d_model, GN), ("embed", None), d_model ** -0.5,
                             device=device)
        self.wC = make_param(gen, (d_model, GN), ("embed", None), d_model ** -0.5,
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


def _grouped(p: Mamba2, m):
    """B or C [..., G·N] as the scan takes it: [..., N] shared, else [..., G, N]."""
    return m if p.n_groups == 1 else m.reshape(*m.shape[:-1], p.n_groups, -1)


def _out(p: Mamba2, y, z):
    """The gated norm of y [..., Di] by z: rmsnorm(y)·silu(z) (the
    reference's), or with ``gate_norm_groups`` rmsnorm over each group of
    y·silu(z)."""
    if not p.gate_norm_groups:
        return rms_norm(y, p.out_norm.w, p.out_norm.eps) * F.silu(z)
    g = (y.float() * F.silu(z.float())).unflatten(-1, (p.n_groups, -1))
    g = g * torch.rsqrt((g * g).mean(-1, keepdim=True) + p.out_norm.eps)
    return (g.flatten(-2) * p.out_norm.w.float()).to(y.dtype)


def mamba2_forward(p: Mamba2, x, chunk: int = 128, return_state: bool = False,
                   decay_dtype=torch.float32):
    """x [B,S,D] → [B,S,D] (the full-sequence prefill path); with
    ``return_state`` also (state [B,H,N,P] fp32, conv cache [B,W-1,Di]: the
    last W-1 pre-conv x-branch inputs; with ``conv_bc`` [B,W-1,Di+2GN], the
    pre-conv [x, B, C])."""
    dtype = x.dtype
    z = torch.einsum("bsd,df->bsf", x, p.wz.to(dtype))
    raw = torch.einsum("bsd,df->bsf", x, p.wx.to(dtype))
    if p.conv_bc:
        Di = raw.shape[-1]
        raw = torch.cat([raw, x @ p.wB.to(dtype), x @ p.wC.to(dtype)], dim=-1)
        conv = F.silu(_causal_conv(raw, p.conv_w.to(dtype), p.conv_b.to(dtype)))
        xb, B_, C_ = conv.split([Di, (conv.shape[-1] - Di) // 2, (conv.shape[-1] - Di) // 2], -1)
    else:
        xb = F.silu(_causal_conv(raw, p.conv_w.to(dtype), p.conv_b.to(dtype)))
        B_ = x @ p.wB.to(dtype)
        C_ = x @ p.wC.to(dtype)
    xb = lsc(xb, "batch", "seq", "ffn")
    dt, a = _dt_and_a(p, x)
    H = a.shape[0]
    xh = xb.reshape(*xb.shape[:2], H, -1)
    y, state = ssd(xh, dt, _grouped(p, B_), _grouped(p, C_), a, chunk, decay_dtype=decay_dtype)
    y = y + xh * p.d_skip.to(dtype)[None, None, :, None]
    y = _out(p, y.reshape(xb.shape), z)
    out = torch.einsum("bsf,fd->bsd", y, p.wo.to(dtype))
    if return_state:
        W = p.conv_w.shape[0]
        return out, (state, raw[:, -(W - 1):, :])
    return out


def mamba2_decode(p: Mamba2, x, state, conv_cache):
    """Single-step recurrence.  x [B,1,D]; state [B,H,N,P] fp32 (as
    ``Model.cache_layout`` holds it); conv_cache [B,W-1,Di] holds the
    previous pre-conv x-branch inputs ([B,W-1,Di+2GN], x, B and C, with
    ``conv_bc``).  Writes the new state into ``state``
    (``ssd_step``: on the card one kernel that reads and writes it once)
    and the new conv cache into ``conv_cache``, in place, and returns (out
    [B,1,D], state, conv_cache): no new state is made, so a captured decode
    step can hold it (``models.decode_graph``)."""
    dtype = x.dtype
    z = torch.einsum("bsd,df->bsf", x, p.wz.to(dtype))[:, 0]
    raw = torch.einsum("bsd,df->bsf", x, p.wx.to(dtype))[:, 0]         # [B,Di]
    Di = raw.shape[-1]
    if p.conv_bc:
        raw = torch.cat([raw, x[:, 0] @ p.wB.to(dtype), x[:, 0] @ p.wC.to(dtype)], dim=-1)
    window = torch.cat([conv_cache.to(dtype), raw[:, None, :]], dim=1)  # [B,W,·]
    conv = F.silu(torch.einsum("bwf,wf->bf", window, p.conv_w.to(dtype))
                  + p.conv_b.to(dtype))
    if p.conv_bc:
        GN = (conv.shape[-1] - Di) // 2
        xb, B_, C_ = conv[:, :Di], conv[:, Di:Di + GN].float(), conv[:, Di + GN:].float()
    else:
        xb = conv
        B_ = (x[:, 0] @ p.wB.to(dtype)).float()
        C_ = (x[:, 0] @ p.wC.to(dtype)).float()
    dt, a = _dt_and_a(p, x[:, 0])                                       # [B,H]
    H = a.shape[0]
    y = ssd_step(state, xb.reshape(xb.shape[0], H, -1), dt, a, _grouped(p, B_),
                 _grouped(p, C_), p.d_skip)
    y = _out(p, y.reshape(xb.shape), z)
    out = torch.einsum("bf,fd->bd", y, p.wo.to(dtype))[:, None, :]
    return out, state, conv_cache.copy_(window[:, 1:, :])
