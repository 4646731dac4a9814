"""xLSTM blocks: mLSTM (matrix memory, chunked-parallel) and sLSTM (scalar
memory with recurrent gate mixing).

The counterpart of the JAX package's ``models/xlstm.py``, with its
parameter names, layouts and arithmetic, so weights convert by a rename.

mLSTM recurrence per head (state C [Dk,Dv], normalizer n [Dk]):
    C_t = f_t·C_{t-1} + i_t·(k_t ⊗ v_t)
    n_t = f_t·n_{t-1} + i_t·k_t
    y_t = (q_t·C_t) / max(|q_t·n_t|, 1)
The full sequence runs in the chunk-parallel form (the algebra of the SSD
chunking in ``ssm.py``), decode the step recurrence.  As in the reference,
the input gate is a sigmoid, not the paper's exp (a documented deviation:
the chunked form stays stable in fp32 without a max-stabiliser), a ragged
last chunk is padded with neutral steps (log f = 0, i = 0) and the states
are fp32.  One difference: the reference forms exp(L_i − L_j) for every
(i, j) of a chunk and multiplies by the causal mask afterwards; above the
diagonal the exponent is positive and overflows to inf once a chunk's
summed log f passes about −88 (xlstm-1.3b's first layer reaches −97 on
random weights), and inf·0 = NaN.  Here the exponent is masked to −inf
before the exp, so the result is finite and equals the reference's
wherever the reference's is finite.

The sLSTM keeps the paper's per-head block-diagonal recurrent gate mixing
and runs as a time scan, one step per token; its state is (h, c, n).  No
TPU kernel sits behind either block: both are plain torch on every device.
Every weight is cast to the activation dtype where it is used.

On a mesh (DTensor activations) the projections go through the mesh-aware
``layers.einsum``/``matmul``, and each cell runs per rank on its local
shards in one region (``kernels._mesh.run``), as K2 and K3 do: the mLSTM's
gates and chunked form (or its step) with the batch and, where they divide,
the heads split; the sLSTM's scan with the batch split and its gates whole
(its regrouping interleaves the four gates of each head-dim, which a split
of 4·d cannot keep), its recurrent weights' gradient partial over the
batch split.  DTensor has no sharding strategy for ``log_sigmoid`` and
would dispatch the sLSTM's scan op by op.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import _mesh
from .common import make_param
from .layers import RMSNorm, _is_dtensor, einsum, lsc, matmul, rms_norm


# ---------------------------------------------------------------- mLSTM ----
class MLSTM(nn.Module):
    """q/k/v are per-head block-diagonal projections (as in the xLSTM
    paper's mLSTM cell): di²/H parameters each instead of di²."""

    def __init__(self, gen, d_model: int, n_heads: int, expand: int = 2, device=None,
                 eps: float = 1e-5):
        super().__init__()
        di = expand * d_model
        Dh = di // n_heads
        self.w_up = make_param(gen, (d_model, 2 * di), ("embed", "ffn"), d_model ** -0.5,
                               device=device)
        self.wq = make_param(gen, (n_heads, Dh, Dh), ("heads", None, None), Dh ** -0.5,
                             device=device)
        self.wk = make_param(gen, (n_heads, Dh, Dh), ("heads", None, None), Dh ** -0.5,
                             device=device)
        self.wv = make_param(gen, (n_heads, Dh, Dh), ("heads", None, None), Dh ** -0.5,
                             device=device)
        self.wi = make_param(gen, (di, n_heads), ("ffn", None), di ** -0.5, device=device)
        self.wf = make_param(gen, (di, n_heads), ("ffn", None), di ** -0.5, device=device)
        self.f_bias = make_param(gen, (n_heads,), (None,), init="ones", device=device)
        self.out_norm = RMSNorm(di, device, eps)
        self.w_down = make_param(gen, (di, d_model), ("ffn", "embed"), di ** -0.5, device=device)


def _mlstm_chunked(q, k, v, log_f, i_gate, chunk: int):
    """q/k/v [B,S,H,D]; log_f/i_gate [B,S,H] → y [B,S,H,D] fp32, (C_T, n_T)."""
    Bsz, S, H, D = q.shape
    Q = min(chunk, S)
    S0 = S
    if S % Q:
        # neutral padding: f=1 (log_f=0), i=0 ⇒ padded steps are no-ops
        pad = Q - S % Q
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        log_f, i_gate = (F.pad(t, (0, 0, 0, pad)) for t in (log_f, i_gate))
        S = S + pad
    nc = S // Q
    f32 = torch.float32
    scale = D ** -0.5

    qc = q.reshape(Bsz, nc, Q, H, D).to(f32) * scale
    kc = k.reshape(Bsz, nc, Q, H, D).to(f32)
    vc = v.reshape(Bsz, nc, Q, H, D).to(f32)
    lf = log_f.reshape(Bsz, nc, Q, H).to(f32)
    ig = i_gate.reshape(Bsz, nc, Q, H).to(f32)
    L = torch.cumsum(lf, dim=2)
    Llast = L[:, :, -1]

    G = torch.einsum("bcihd,bcjhd->bcijh", qc, kc)
    # the exponent is masked to -inf above the diagonal before the exp (see
    # the module's docstring): the reference multiplies by the mask after it
    causal = torch.ones(Q, Q, dtype=torch.bool, device=q.device).tril()
    diff = L[:, :, :, None, :] - L[:, :, None, :, :]              # [b,c,i,j,h]
    decay = torch.exp(diff.masked_fill(~causal[:, :, None], float("-inf")))
    att = G * decay * ig[:, :, None, :, :]
    y_diag = torch.einsum("bcijh,bcjhd->bcihd", att, vc)
    # denominator: q_i·n_i — the intra part is just the row-sum of att
    den_diag = att.sum(dim=3)                                      # [b,c,i,h]

    w = torch.exp(Llast[:, :, None, :] - L) * ig                   # [b,c,q,h]
    csC = torch.einsum("bcjhk,bcjhv->bchkv", w[..., None] * kc, vc)
    csn = torch.einsum("bcjh,bcjhk->bchk", w, kc)

    dec = torch.exp(Llast)                                         # [b,c,h]
    C = torch.zeros(Bsz, H, D, D, dtype=f32, device=q.device)
    n = torch.zeros(Bsz, H, D, dtype=f32, device=q.device)
    Cprev, nprev = [], []
    for c in range(nc):
        Cprev.append(C)
        nprev.append(n)
        C = dec[:, c, :, None, None] * C + csC[:, c]
        n = dec[:, c, :, None] * n + csn[:, c]
    Cprev = torch.stack(Cprev, dim=1)                              # [b,c,h,k,v]
    nprev = torch.stack(nprev, dim=1)

    eL = torch.exp(L)
    y_inter = torch.einsum("bcihk,bchkv->bcihv", qc, Cprev) * eL[..., None]
    den_inter = torch.einsum("bcihk,bchk->bcih", qc, nprev) * eL
    den = den_diag + den_inter
    y = (y_diag + y_inter) / torch.clamp(den.abs(), min=1.0)[..., None]
    return y.reshape(Bsz, S, H, D)[:, :S0], (C, n)


def mlstm_cell_step(q, k, v, log_f, i_gate, C, n):
    """Single step: q/k/v [B,H,D], gates [B,H], C [B,H,D,D], n [B,H,D]."""
    f32 = torch.float32
    scale = q.shape[-1] ** -0.5
    q, k, v = q.to(f32) * scale, k.to(f32), v.to(f32)
    f = torch.exp(log_f.to(f32))
    i = i_gate.to(f32)
    C = f[:, :, None, None] * C + i[:, :, None, None] * torch.einsum("bhk,bhv->bhkv", k, v)
    n = f[:, :, None] * n + i[:, :, None] * k
    num = torch.einsum("bhk,bhkv->bhv", q, C)
    den = torch.clamp(torch.einsum("bhk,bhk->bh", q, n).abs(), min=1.0)
    return num / den[..., None], C, n


def _mlstm_qkvg(p: MLSTM, xm, n_heads: int):
    """xm [B,S,di] → q, k, v [B,S,H,Dh] and the gates' pre-activations
    f_pre, i_pre [B,S,H] (``_mlstm_cell`` applies them)."""
    di = xm.shape[-1]
    D = di // n_heads
    dtype = xm.dtype
    xh = xm.reshape(*xm.shape[:-1], n_heads, D)
    q = einsum("bshd,hde->bshe", xh, p.wq.to(dtype))
    k = einsum("bshd,hde->bshe", xh, p.wk.to(dtype))
    v = einsum("bshd,hde->bshe", xh, p.wv.to(dtype))
    return q, k, v, matmul(xm, p.wf.to(dtype)), matmul(xm, p.wi.to(dtype))


def _mlstm_cell(q, k, v, f_pre, i_pre, f_bias, chunk: int, state=None):
    """The gates (log f = log σ(f_pre + f_bias), i = σ(i_pre), fp32), then
    the chunked form over [B,S,H,·] (``state`` None) or one step from
    ``state`` (C, n) (S = 1) → (y [B,S,H,Dh] fp32, (C, n)).  On DTensors,
    per rank on the local shards: the resolver's batch and heads split of
    q (``_mesh.base_placements``), f_bias and the states following the
    heads, f_bias's gradient partial over the batch split."""
    def local(q, k, v, f_pre, i_pre, f_bias, *st):
        log_f = F.logsigmoid(f_pre.float() + f_bias.float())
        i_gate = torch.sigmoid(i_pre.float())
        if not st:
            y, (C, n) = _mlstm_chunked(q, k, v, log_f, i_gate, chunk)
            return y, C, n
        y, C, n = mlstm_cell_step(q[:, 0], k[:, 0], v[:, 0], log_f[:, 0], i_gate[:, 0], *st)
        return y[:, None], C, n

    st = () if state is None else tuple(state)
    if not _is_dtensor(q):
        y, C, n = local(q, k, v, f_pre, i_pre, f_bias, *st)
        return y, (C, n)
    from torch.distributed.tensor import Partial, Replicate, Shard

    base = _mesh.base_placements(q, "mlstm")
    heads = [Shard(0) if p.is_shard(2) else Replicate() for p in base]
    heads_grad = [Partial() if p.is_shard(0) else h for p, h in zip(base, heads)]
    states = [Shard(1) if p.is_shard(2) else p for p in base]
    ins = (base,) * 5 + (heads,) + (states,) * len(st)
    y, C, n = _mesh.run(local, (q, k, v, f_pre, i_pre, f_bias, *st), ins,
                        (list(base), states, states), q.device_mesh,
                        (base,) * 5 + (heads_grad,) + (states,) * len(st))
    return y, (C, n)


def mlstm_forward(p: MLSTM, x, n_heads: int, chunk: int = 128, return_state: bool = False):
    """x [B,S,D] → [B,S,D]; with ``return_state`` also (C_T, n_T) fp32."""
    dtype = x.dtype
    up = lsc(einsum("bsd,df->bsf", x, p.w_up.to(dtype)), "batch", "seq", "ffn")
    xm, z = up.chunk(2, dim=-1)
    q, k, v, f_pre, i_pre = _mlstm_qkvg(p, xm, n_heads)
    y, state = _mlstm_cell(q, k, v, f_pre, i_pre, p.f_bias, chunk)
    y = y.reshape(xm.shape).to(dtype)
    y = rms_norm(y, p.out_norm.w, p.out_norm.eps) * F.silu(z)
    out = einsum("bsf,fd->bsd", y, p.w_down.to(dtype))
    if return_state:
        return out, state
    return out


def mlstm_decode(p: MLSTM, x, state, n_heads: int):
    """x [B,1,D], state (C, n) → (out [B,1,D], (C, n)); the inputs are left
    as they were."""
    dtype = x.dtype
    up = einsum("bsd,df->bsf", x, p.w_up.to(dtype))
    xm, z = up.chunk(2, dim=-1)
    q, k, v, f_pre, i_pre = _mlstm_qkvg(p, xm, n_heads)
    y, (C, n) = _mlstm_cell(q, k, v, f_pre, i_pre, p.f_bias, 1, state)
    y = y.reshape(xm.shape).to(dtype)
    y = rms_norm(y, p.out_norm.w, p.out_norm.eps) * F.silu(z)
    out = einsum("bsf,fd->bsd", y, p.w_down.to(dtype))
    return out, (C, n)


# ---------------------------------------------------------------- sLSTM ----
class SLSTM(nn.Module):
    def __init__(self, gen, d_model: int, n_heads: int, device=None, eps: float = 1e-5):
        super().__init__()
        dh = d_model // n_heads
        self.wx = make_param(gen, (d_model, 4 * d_model), ("embed", "ffn"), d_model ** -0.5,
                             device=device)
        self.r = make_param(gen, (n_heads, dh, 4 * dh), ("heads", None, None), dh ** -0.5,
                            device=device)
        self.bias = make_param(gen, (4 * d_model,), ("ffn",), init="zeros", device=device)
        self.out_norm = RMSNorm(d_model, device, eps)
        self.wo = make_param(gen, (d_model, d_model), ("embed", "embed2"), d_model ** -0.5,
                             device=device)


def slstm_cell_step(gx, r, h, c, n, n_heads: int):
    """gx [B,4d] (input-projected gates); h/c/n [B,H,dh] fp32; r [H,dh,4dh]
    (the JAX package promotes it to h's fp32, so it is cast here)."""
    f32 = torch.float32
    B, H = h.shape[0], n_heads
    dh = h.shape[-1]
    rec = torch.einsum("bhd,hde->bhe", h, r.to(h.dtype)).reshape(B, 4 * H * dh)
    g = (gx.to(f32) + rec.to(f32)).reshape(B, H, dh, 4)
    i = torch.sigmoid(g[..., 0])
    f = torch.sigmoid(g[..., 1] + 1.0)
    z = torch.tanh(g[..., 2])
    o = torch.sigmoid(g[..., 3])
    c = f * c + i * z
    n = f * n + i
    h = o * c / torch.clamp(n, min=1.0)
    return h, c, n


# The dry-run's knob (``launch.dryrun``): a trace unrolls the sLSTM's time
# scan, one cell step a token (4096 steps a block at train_4k), so the
# dry-run traces its first n steps only and extrapolates the cost to all
# of them; the steps it does not take repeat the last h.  None: every step.
_scan_steps = None


@contextlib.contextmanager
def scan_steps(n):
    """Within this block, ``_slstm_scan`` takes only its first ``n`` steps
    (None: all), for the dry-run's trace."""
    global _scan_steps
    before, _scan_steps = _scan_steps, n
    try:
        yield
    finally:
        _scan_steps = before


def _slstm_scan(gx, r, n_heads: int, state=None):
    """gx [B,S,4d] (input-projected gates, bias added), regrouped so that
    they interleave per head-dim ([B,S,H,dh,4] flattened), then one cell
    step per token from ``state`` (h, c, n) [B,H,dh] fp32 (zeros if None)
    → (hs [B,S,d] fp32, (h, c, n)).  On DTensors, per rank with the batch
    split and the gates whole; r's gradient partial over the batch split."""
    def local(gx, r, *st):
        B, S, d4 = gx.shape
        d = d4 // 4
        g = gx.reshape(B, S, 4, n_heads, d // n_heads).movedim(2, -1).reshape(B, S, d4)
        r = r.float()          # cast once, not once a step
        if st:
            h, c, n = st
        else:
            h = torch.zeros(B, n_heads, d // n_heads, dtype=torch.float32, device=gx.device)
            c, n = h, h
        hs = []
        for t in range(S if _scan_steps is None else min(S, _scan_steps)):
            h, c, n = slstm_cell_step(g[:, t], r, h, c, n, n_heads)
            hs.append(h)
        hs += [h] * (S - len(hs))
        return torch.stack(hs, dim=1).reshape(B, S, d), h, c, n

    st = () if state is None else tuple(state)
    if not _is_dtensor(gx):
        hs, h, c, n = local(gx, r, *st)
        return hs, (h, c, n)
    from torch.distributed.tensor import Partial, Replicate, Shard

    batch = [Shard(0) if p.is_shard(0) else Replicate() for p in gx.placements]
    whole = [Replicate()] * len(batch)
    r_grad = [Partial() if p.is_shard() else p for p in batch]
    hs, h, c, n = _mesh.run(local, (gx, r, *st), (batch, whole) + (batch,) * len(st),
                            (batch,) * 4, gx.device_mesh, (batch, r_grad) + (batch,) * len(st))
    return hs, (h, c, n)


def slstm_forward(p: SLSTM, x, n_heads: int, return_state: bool = False):
    """x [B,S,d] → [B,S,d], one cell step per token; with ``return_state``
    also the final (h, c, n)."""
    gx = matmul(x, p.wx.to(x.dtype)) + p.bias.to(x.dtype)
    hs, state = _slstm_scan(gx, p.r, n_heads)
    y = rms_norm(hs.to(x.dtype), p.out_norm.w, p.out_norm.eps)
    out = einsum("bsd,de->bse", y, p.wo.to(x.dtype))
    if return_state:
        return out, state
    return out


def slstm_decode(p: SLSTM, x, state, n_heads: int):
    """x [B,1,d], state (h, c, n) → (out [B,1,d], (h, c, n))."""
    gx = matmul(x, p.wx.to(x.dtype)) + p.bias.to(x.dtype)
    hs, state = _slstm_scan(gx, p.r, n_heads, state)
    y = rms_norm(hs.to(x.dtype), p.out_norm.w, p.out_norm.eps)
    return einsum("bsd,de->bse", y, p.wo.to(x.dtype)), state
