"""Plain torch versions of the SSD scan kernels (``csrc/ssd_scan.cu`` and,
with ``split=True``, ``csrc/ssd_scan_sm90.cu``).

Both take the model layout: x [B,S,H,P], dt [B,S,H] (> 0), B and C shared
across heads as [B,S,N] or in groups as [B,S,G,N], a [H] (< 0); both return (y [B,S,H,P] in x's
dtype, final state [B,H,N,P] in fp32).  Neither copies B or C per head.

The recurrence is h_t = exp(a·dt_t)·h_{t-1} + dt_t·B_t⊗x_t, y_t = C_t·h_t.

The JAX package's chunked path (``repro.models.ssm._ssd_chunked``) forms
exp(L_i − L_j) for every (i, j) and masks it afterwards; for i < j the
exponent is positive and overflows to inf once a chunk's summed a·dt passes
about 88 (chunk 128 with a = −1 and dt ≈ softplus(N(0,1)) does), and
inf·0 = NaN.  Here the exponent is masked to −inf before the exp, as the
Pallas kernel selects before it multiplies, so the result is finite and
equals the reference wherever the reference is finite.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def split_bf16(v):
    """v as two bf16 terms in fp32, hi = bf16(v) and lo = bf16(v - hi): v -
    hi is exact in fp32 and hi + lo is v within 2**-16 |v|."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def ssd_scan_torch(x, dt, Bm, Cm, a, chunk: int = 128,
                   decay_dtype: torch.dtype = torch.float32, split: bool = False):
    """The kernel's chunked arithmetic in fp32, all chunks at once, then the
    short recurrence of the chunk states.  Per chunk of Q = min(chunk, S)
    steps: L = cumsum(a·dt); y = ((C·Bᵀ) ∘ exp(L_i − L_j) ∘ dt_j, i ≥ j)·x
    + exp(L_i)·C·h_in; h_out = exp(L_last)·h_in + Σ_j exp(L_last − L_j)·dt_j
    ·B_j⊗x_j.  A ragged last chunk is padded with dt = 0, which leaves the
    result unchanged.  ``decay_dtype`` (the JAX package's hill-climb lever;
    both kernels take fp32 and bf16) sets the type of the decay tile and of
    the intra-chunk product's operands, which accumulate in fp32.

    ``split=True`` is the plain version of the sm90 kernel, which multiplies
    on the bf16 tensor cores: each of its three products with an fp32
    operand takes that operand as two bf16 terms (``split_bf16``), grouped
    as the kernel groups them: the mixing tile M_ij = (C_i·B_j)·exp(L_i −
    L_j)·dt_j (dt goes into M, not into x), the state weights
    exp(L_last − L_j)·dt_j·B_j, and h_in, with exp(L_i) applied after C·h_in.
    With ``decay_dtype=torch.bfloat16`` both kernels form the intra-chunk
    term as the reference's ``_ssd_chunked`` does with a bf16 decay: L, the
    difference L_i − L_j (masked before the exp) and the exp each rounded to
    bf16, G = C·Bᵀ and x·dt rounded to bf16, the products accumulated in
    fp32; dt goes into x, not into M; L is summed in step order.  M = bf16(G)·bf16(exp) has at most 16
    significant bits, so its two bf16 terms hold it exactly and the split
    form differs from the unsplit one in the order of the sums alone.  The
    state weights, the pass across chunks and exp(L_i) stay fp32.

    B and C in G groups, [B,S,G,N] (head h reads group h // (H/G)), run
    group by group over the group's heads, as the kernels read them."""
    if Bm.dim() == 4:
        hpg = x.shape[2] // Bm.shape[2]
        parts = [ssd_scan_torch(x[:, :, g * hpg:(g + 1) * hpg], dt[:, :, g * hpg:(g + 1) * hpg],
                                Bm[:, :, g], Cm[:, :, g], a[g * hpg:(g + 1) * hpg], chunk,
                                decay_dtype, split)
                 for g in range(Bm.shape[2])]
        return torch.cat([y for y, _ in parts], 2), torch.cat([h for _, h in parts], 1)
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    f32 = torch.float32
    xf, dtf, Bf, Cf = x.to(f32), dt.to(f32), Bm.to(f32), Cm.to(f32)
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
    xc = xf.reshape(Bsz, nc, Q, H, P)
    Bc = Bf.reshape(Bsz, nc, Q, N)
    Cc = Cf.reshape(Bsz, nc, Q, N)
    dtc = dtf.reshape(Bsz, nc, Q, H)
    if decay_dtype == f32:
        L = torch.cumsum(dtc * a.to(f32), dim=2)          # [b,c,q,h]
    else:
        # in fp32 step order, as both kernels sum it for a bf16 decay, so
        # that the bf16 rounding of L is theirs on any device (torch's
        # cumsum on the CPU does not sum in fp32 step order)
        la, run, steps = dtc * a.to(f32), 0.0, []
        for r in range(Q):
            run = run + la[:, :, r]
            steps.append(run)
        L = torch.stack(steps, dim=2)
    Llast = L[:, :, -1]                                   # [b,c,h]

    # intra-chunk (i >= j): the exponent is masked before the exp
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    Ld = L.to(decay_dtype)
    diff = Ld[:, :, :, None, :] - Ld[:, :, None, :, :]    # [b,c,i,j,h]
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(diff.masked_fill(~causal[:, :, None], float("-inf")))
    if split and decay_dtype == torch.float32:
        M = G[..., None] * decay * dtc[:, :, None]          # [b,c,i,j,h]
        y = sum(torch.einsum("bcijh,bcjhp->bcihp", m, xc) for m in split_bf16(M))
    elif split:
        M = G.to(decay_dtype).float()[..., None] * decay.float()     # exact in fp32
        xdt = (xc * dtc[..., None]).to(decay_dtype).float()
        y = sum(torch.einsum("bcijh,bcjhp->bcihp", m, xdt) for m in split_bf16(M))
    else:
        xdt = xc * dtc[..., None]
        y = torch.einsum("bcij,bcijh,bcjhp->bcihp", G.to(decay_dtype).to(f32),
                         decay.to(f32), xdt.to(decay_dtype).to(f32))

    # each chunk's own contribution to the state, then the chunk recurrence
    w = torch.exp(Llast[:, :, None, :] - L) * dtc          # [b,c,q,h]
    if split:
        wB = w[..., None] * Bc[:, :, :, None]             # [b,c,j,h,n]
        cs = sum(torch.einsum("bcjhn,bcjhp->bchnp", t, xc) for t in split_bf16(wB))
    else:
        cs = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Bc, w, xc)
    dec = torch.exp(Llast)                                # [b,c,h]
    h = torch.zeros(Bsz, H, N, P, dtype=f32, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = dec[:, c, :, None, None] * h + cs[:, c]
    h_in = torch.stack(h_in, dim=1)                       # [b,c,h,n,p]

    # inter-chunk: y_i += exp(L_i)·C_i·h_in
    if split:
        Ch = sum(torch.einsum("bcin,bchnp->bcihp", Cc, t) for t in split_bf16(h_in))
        y = y + torch.exp(L)[..., None] * Ch
    else:
        y = y + torch.einsum("bcin,bchnp,bcih->bcihp", Cc, h_in, torch.exp(L))
    return y.reshape(Bsz, nc * Q, H, P)[:, :S].to(x.dtype), h


def ssd_scan_recurrence(x, dt, Bm, Cm, a):
    """The time recurrence, one step at a time in fp32: the oracle, as
    ``repro.kernels.ssd.ref.ssd_scan_ref`` is the JAX package's.  Grouped B
    and C [B,S,G,N] are repeated to the heads."""
    Bsz, S, H, P = x.shape
    if Bm.dim() == 4:
        hpg = H // Bm.shape[2]
        ys, hs = zip(*(ssd_scan_recurrence(x[:, :, g * hpg:(g + 1) * hpg],
                                           dt[:, :, g * hpg:(g + 1) * hpg], Bm[:, :, g],
                                           Cm[:, :, g], a[g * hpg:(g + 1) * hpg])
                       for g in range(Bm.shape[2])))
        return torch.cat(ys, 2), torch.cat(hs, 1)
    N = Bm.shape[-1]
    f32 = torch.float32
    a = a.to(f32)
    h = torch.zeros(Bsz, H, N, P, dtype=f32, device=x.device)
    ys = []
    for t in range(S):
        dt_t = dt[:, t].to(f32)                           # [b,h]
        h = torch.exp(a * dt_t)[:, :, None, None] * h + torch.einsum(
            "bh,bn,bhp->bhnp", dt_t, Bm[:, t].to(f32), x[:, t].to(f32))
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t].to(f32), h))
    return torch.stack(ys, dim=1).to(x.dtype), h
