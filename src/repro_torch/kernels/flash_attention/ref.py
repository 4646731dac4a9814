"""Plain torch versions of the flash attention kernels.  Their O(S²)
oracle is ``models.layers.attention_naive``."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
BLOCK_K = 32  # kv rows per tile of the scalar kernel (kBK)
SM90_BLOCK_K = 128  # kv rows per tile of the sm90 kernel (kBN)


def flash_attention_torch(q, k, v, causal: bool = True, p_split: bool = False,
                          block_k: int = BLOCK_K):
    """A kernel's arithmetic in plain torch: online softmax over kv tiles of
    ``block_k`` rows with m, l and acc in fp32, scale 1/√D, output in q's
    dtype.  q [B,S,Hq,D], k [B,S,Hkv,D], v [B,S,Hkv,Dv] → [B,S,Hq,Dv].  All
    query rows go through each kv tile at once.

    ``p_split=False`` keeps p = exp(s - m) in fp32 for P·V, as the scalar
    kernel and the TPU kernel do.  ``p_split=True`` does what the sm90
    kernel does on the bf16 tensor cores: P·V = hi·V + lo·V with the two
    bf16 terms hi = bf16(p) and lo = bf16(p - hi), whose sum is p within
    2**-16 of itself; l still sums the fp32 p.  The sm90 kernel's plain
    version is ``p_split=True, block_k=SM90_BLOCK_K``."""
    B, S, Hq, D = q.shape
    Hkv, Dv = k.shape[2], v.shape[-1]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, S, Hkv, G, D)
    rows = torch.arange(S, device=q.device)
    m = torch.full((B, Hkv, G, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, Hkv, G, S, Dv, dtype=torch.float32, device=q.device)
    for k0 in range(0, S, block_k):
        kb = k[:, k0:k0 + block_k].float()
        vb = v[:, k0:k0 + block_k].float()
        s = torch.einsum("bshgd,bthd->bhgst", qf, kb) * scale
        cols = k0 + torch.arange(kb.shape[1], device=q.device)
        if causal:
            s = s.masked_fill(~(rows[:, None] >= cols[None, :]), NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        if p_split:
            hi = p.to(torch.bfloat16).float()
            pv = (torch.einsum("bhgst,bthd->bhgsd", hi, vb)
                  + torch.einsum("bhgst,bthd->bhgsd", (p - hi).to(torch.bfloat16).float(), vb))
        else:
            pv = torch.einsum("bhgst,bthd->bhgsd", p, vb)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]         # [B,Hkv,G,S,Dv]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, Dv).to(q.dtype)
