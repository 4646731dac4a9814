"""Plain torch version of the flash attention kernel.  Its O(S²) oracle is
``models.layers.attention_naive``."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
BLOCK_K = 32  # kv rows per tile, as in the kernel (kBK)


def flash_attention_torch(q, k, v, causal: bool = True):
    """The kernel's arithmetic in plain torch: online softmax over kv tiles
    of ``BLOCK_K`` rows with m, l and acc in fp32 (p stays fp32 for P·V), scale
    1/√D, output in q's dtype.  q [B,S,Hq,D], k [B,S,Hkv,D], v [B,S,Hkv,Dv]
    → [B,S,Hq,Dv].  All query rows go through each kv tile at once."""
    B, S, Hq, D = q.shape
    Hkv, Dv = k.shape[2], v.shape[-1]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, S, Hkv, G, D)
    rows = torch.arange(S, device=q.device)
    m = torch.full((B, Hkv, G, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, Hkv, G, S, Dv, dtype=torch.float32, device=q.device)
    for k0 in range(0, S, BLOCK_K):
        kb = k[:, k0:k0 + BLOCK_K].float()
        vb = v[:, k0:k0 + BLOCK_K].float()
        s = torch.einsum("bshgd,bthd->bhgst", qf, kb) * scale
        cols = k0 + torch.arange(kb.shape[1], device=q.device)
        if causal:
            s = s.masked_fill(~(rows[:, None] >= cols[None, :]), NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgst,bthd->bhgsd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]         # [B,Hkv,G,S,Dv]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, Dv).to(q.dtype)
