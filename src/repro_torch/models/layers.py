"""Transformer layers: RMSNorm, RoPE and Qwen2-VL's M-RoPE, GQA attention
(naive, chunked online-softmax and decode) and the SwiGLU MLP.

Plain functions on tensors, with the JAX package's parameter layouts
(``wq [d_model, H, hd]``, ``wo [H, hd, d_model]``, ``wg [d_model, d_ff]``, …)
and einsum subscripts, so weights convert by a rename alone.  Parameters
are bf16 whatever the activation dtype; JAX promotes a mixed fp32×bf16
einsum to fp32, torch does not promote, so every weight is cast to the
activation dtype where it is used.

Prefill attention (``attention``, which ``models.mla`` calls too) on a
CUDA tensor goes through the hand-written kernel
(``kernels.flash_attention``); on the CPU it takes ``attention_chunked``,
the JAX package's own path.  Decode attention is plain torch, as it is plain
jnp in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.flash_attention.ops import flash_attention
from .common import make_param

NEG_INF = -1e30


# -- norms ---------------------------------------------------------------------------
def rms_norm(x, w, eps=1e-5):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.w = make_param(None, (d,), init="ones", device=device)

    def forward(self, x):
        return rms_norm(x, self.w)


# -- RoPE ----------------------------------------------------------------------------
def rope_angles(positions, head_dim: int, theta: float = 10000.0):
    """positions [...]: int -> cos/sin [..., head_dim/2] in fp32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x [B,S,H,D]; cos/sin [B,S,D/2] or [S,D/2] (broadcast over heads)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    cos, sin = cos.to(x.dtype), sin.to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def mrope_angles(positions3, head_dim: int, sections, theta: float = 10000.0):
    """Qwen2-VL M-RoPE: positions3 [B,S,3] (t,h,w); ``sections`` split the
    rotary half-dim across the three position streams → cos/sin [B,S,half]
    in fp32 (positions are cast to fp32 before the angles, as in the JAX
    package)."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to {half}")
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions3.device) / half)
    coss, sins = [], []
    start = 0
    for i, sec in enumerate(sections):
        ang = positions3[..., i].float()[..., None] * freqs[start:start + sec]
        coss.append(torch.cos(ang))
        sins.append(torch.sin(ang))
        start += sec
    return torch.cat(coss, -1), torch.cat(sins, -1)


# -- attention ------------------------------------------------------------------------
def attention_naive(q, k, v, causal=True, kv_len=None, pos_offset=0):
    """Reference O(S²)-memory attention (oracle for tests; never the prod path).
    q [B,Sq,Hq,D], k/v [B,Skv,Hkv,D] with Hq = G*Hkv."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    scores = torch.einsum("bshgd,bthd->bhgst", qg, k).float() / math.sqrt(D)
    q_pos = pos_offset + torch.arange(Sq, device=q.device)
    kv_pos = torch.arange(Skv, device=q.device)
    mask = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= kv_pos[None, :]
    if kv_len is not None:
        mask &= kv_pos[None, :] < kv_len
    scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", p, v)
    return out.reshape(B, Sq, Hq, D)


def attention_chunked(q, k, v, causal=True, kv_len=None, pos_offset=0,
                      q_chunk=2048, kv_chunk=2048):
    """Online-softmax flash attention in plain torch, chunk by chunk over q
    and kv: the peak intermediate is [B,Hkv,G,qc,kc].  p is cast to v's
    dtype before P·V, as in the JAX package."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]  # value head dim may differ (MLA)
    G = Hq // Hkv
    qc, kc = min(q_chunk, Sq), min(kv_chunk, Skv)
    scale = 1.0 / math.sqrt(D)
    limit = Skv if kv_len is None else kv_len
    outs = []
    for q0 in range(0, Sq, qc):
        qb = q[:, q0:q0 + qc]
        n = qb.shape[1]
        qb = qb.reshape(B, n, Hkv, G, D).permute(0, 2, 3, 1, 4)       # [B,Hkv,G,qc,D]
        q_pos = pos_offset + q0 + torch.arange(n, device=q.device)
        m = torch.full((B, Hkv, G, n), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        o = torch.zeros(B, Hkv, G, n, Dv, dtype=torch.float32, device=q.device)
        for k0 in range(0, Skv, kc):
            kb = k[:, k0:k0 + kc].permute(0, 2, 1, 3)                  # [B,Hkv,kc,D]
            vb = v[:, k0:k0 + kc].permute(0, 2, 1, 3)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kb).float() * scale
            kv_pos = k0 + torch.arange(kb.shape[2], device=q.device)
            msk = (kv_pos < limit)[None, :].expand(n, -1)
            if causal:
                msk = msk & (q_pos[:, None] >= kv_pos[None, :])
            s = s.masked_fill(~msk, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.to(vb.dtype), vb).float()
            m = m_new
        out = (o / torch.clamp(l[..., None], min=1e-30)).to(v.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, n, Hq, Dv))
    return torch.cat(outs, dim=1)


def attention(q, k, v, causal=True, q_chunk=2048, kv_chunk=2048):
    """Prefill attention: K2 (``flash_attention``) on a CUDA tensor, the JAX
    package's chunked path on the CPU."""
    if q.is_cuda:
        return flash_attention(q, k, v, causal=causal)
    return attention_chunked(q, k, v, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk)


def attention_decode(q, k_cache, v_cache, pos):
    """Single-token decode vs a (padded) cache.  q [B,1,Hq,D],
    caches [B,T,Hkv,D], ``pos`` = number of valid cache entries (int or [B])."""
    B, _, Hq, D = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bthd->bhgt", qg, k_cache).float() / math.sqrt(D)
    kv_pos = torch.arange(T, device=q.device)
    limit = pos if isinstance(pos, int) else pos.reshape(-1, 1)
    valid = (kv_pos[None, :] < limit).expand(B, T)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhgt,bthd->bhgd", p, v_cache)
    return out.reshape(B, 1, Hq, D)


# -- GQA attention block ----------------------------------------------------------------
class GQA(nn.Module):
    def __init__(self, gen, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                 device=None):
        super().__init__()
        self.wq = make_param(gen, (d_model, n_heads, head_dim), d_model ** -0.5,
                             device=device)
        self.wk = make_param(gen, (d_model, n_kv, head_dim), d_model ** -0.5,
                             device=device)
        self.wv = make_param(gen, (d_model, n_kv, head_dim), d_model ** -0.5,
                             device=device)
        self.wo = make_param(gen, (n_heads, head_dim, d_model),
                             (n_heads * head_dim) ** -0.5, device=device)


def gqa_qkv(p: GQA, x):
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p.wk.to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p.wv.to(x.dtype))
    return q, k, v


def gqa_out(p: GQA, attn):
    return torch.einsum("bshk,hkd->bsd", attn, p.wo.to(attn.dtype))


def gqa_forward(p: GQA, x, cos, sin, causal=True, q_chunk=2048, kv_chunk=2048):
    """Full-sequence attention block → (out, (k, v)) with k after RoPE."""
    q, k, v = gqa_qkv(p, x)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = attention(q, k, v, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk)
    return gqa_out(p, attn), (k, v)


def gqa_decode(p: GQA, x, cache_k, cache_v, pos: int, cos, sin):
    """x [B,1,D]; writes K/V at ``pos`` and attends over the valid prefix.
    The caches are updated in place (the JAX package returns new arrays);
    they are returned too, as in the reference."""
    if pos >= cache_k.shape[1]:
        raise ValueError(f"decode position {pos} is past the cache length "
                         f"{cache_k.shape[1]}")
    q, k, v = gqa_qkv(p, x)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    cache_k[:, pos:pos + 1] = k.to(cache_k.dtype)
    cache_v[:, pos:pos + 1] = v.to(cache_v.dtype)
    out = attention_decode(q, cache_k, cache_v, pos + 1)
    return gqa_out(p, out), cache_k, cache_v


# -- SwiGLU MLP -----------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, gen, d_model: int, d_ff: int, device=None):
        super().__init__()
        self.wg = make_param(gen, (d_model, d_ff), d_model ** -0.5, device=device)
        self.wu = make_param(gen, (d_model, d_ff), d_model ** -0.5, device=device)
        self.wd = make_param(gen, (d_ff, d_model), d_ff ** -0.5, device=device)


def mlp_forward(p: MLP, x):
    g = torch.einsum("bsd,df->bsf", x, p.wg.to(x.dtype))
    u = torch.einsum("bsd,df->bsf", x, p.wu.to(x.dtype))
    h = F.silu(g) * u
    return torch.einsum("bsf,fd->bsd", h, p.wd.to(x.dtype))
