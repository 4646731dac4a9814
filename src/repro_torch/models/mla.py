"""Multi-head Latent Attention (DeepSeek-V2), as in the JAX package's
``models/mla.py``: the KV cache holds only the compressed latent ``c_kv``
[B,S,kv_lora] and the shared decoupled RoPE key [B,S,rope_dim].

Prefill expands the latent into full keys [B,S,H,nope+rope] and values
[B,S,H,v_dim] and runs causal attention over them: K2 on the card, whose
sm90 route takes bf16 at D 192, Dv 128 and whose scalar route takes fp32
(``layers.attention``).  Decode is the *absorbed* form, plain torch as it
is plain jnp in the reference: W_uk is folded into the query and W_uv
applied after the attention in latent space.

With ``rope_scaling`` (``layers.YaRN``, DeepSeek-V2's published form) the
RoPE dims take YaRN's frequencies and the softmax scale is
mscale² / √(nope + rope) (``YaRN.softmax_factor``): prefill multiplies q by
the factor before the attention, which divides by √(nope + rope) as K2
does for every caller; decode scales its fp32 scores.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .common import make_param
from .layers import (RMSNorm, apply_rope, attention, einsum, lsc, matmul, rope_angles,
                     write_slice)


class MLA(nn.Module):
    def __init__(self, gen, d_model: int, n_heads: int, q_lora: int, kv_lora: int,
                 nope_dim: int = 128, rope_dim: int = 64, v_dim: int = 128, device=None,
                 eps: float = 1e-5):
        super().__init__()
        self.wdq = make_param(gen, (d_model, q_lora), ("embed", None), d_model ** -0.5,
                              device=device)
        self.q_norm = RMSNorm(q_lora, device, eps)
        self.wuq = make_param(gen, (q_lora, n_heads, nope_dim + rope_dim),
                              (None, "heads", "head"), q_lora ** -0.5,
                              device=device)
        self.wdkv = make_param(gen, (d_model, kv_lora), ("embed", None), d_model ** -0.5,
                               device=device)
        self.kv_norm = RMSNorm(kv_lora, device, eps)
        self.wuk = make_param(gen, (kv_lora, n_heads, nope_dim), (None, "heads", "head"),
                              kv_lora ** -0.5,
                              device=device)
        self.wuv = make_param(gen, (kv_lora, n_heads, v_dim), (None, "heads", "head"),
                              kv_lora ** -0.5,
                              device=device)
        self.wkr = make_param(gen, (d_model, rope_dim), ("embed", None), d_model ** -0.5,
                              device=device)
        self.wo = make_param(gen, (n_heads, v_dim, d_model), ("heads", "head", "embed"),
                             (n_heads * v_dim) ** -0.5, device=device)


def _queries(p: MLA, x, cos, sin, nope_dim):
    dt = x.dtype
    cq = p.q_norm(matmul(x, p.wdq.to(dt)))
    q = einsum("bsq,qhk->bshk", cq, p.wuq.to(dt))
    return q[..., :nope_dim], apply_rope(q[..., nope_dim:], cos, sin)


def _latent(p: MLA, x, cos, sin):
    """The cache's two entries for x: c_kv [B,S,kvl] and the RoPE key
    [B,S,1,rope]."""
    dt = x.dtype
    ckv = p.kv_norm(matmul(x, p.wdkv.to(dt)))
    kr = apply_rope(matmul(x, p.wkr.to(dt))[:, :, None, :], cos, sin)
    return ckv, kr


def mla_forward(p: MLA, x, positions, nope_dim=128, rope_dim=64, rope_theta=10000.0,
                q_chunk=2048, kv_chunk=2048, unroll=False, rope_scaling=None):
    """Prefill: x [B,S,D] → (out [B,S,D], (c_kv [B,S,kvl], k_rope [B,S,rope]))."""
    B, S, _ = x.shape
    dt = x.dtype
    cos, sin = rope_angles(positions, rope_dim, rope_theta, rope_scaling)
    qn, qr = _queries(p, x, cos, sin, nope_dim)
    ckv, kr = _latent(p, x, cos, sin)
    kn = einsum("bsc,chk->bshk", ckv, p.wuk.to(dt))
    v = einsum("bsc,chk->bshk", ckv, p.wuv.to(dt)).contiguous()
    H = kn.shape[2]
    q = torch.cat([qn, qr], -1)
    if rope_scaling is not None and rope_scaling.softmax_factor != 1.0:
        q = q * rope_scaling.softmax_factor
    k = torch.cat([kn, kr.expand(B, S, H, kr.shape[-1])], -1)
    q = lsc(q, "batch", "seq", "heads", None)
    k = lsc(k, "batch", "seq", "heads", None)
    attn = attention(q, k, v, causal=True, q_chunk=q_chunk, kv_chunk=kv_chunk,
                     unroll=unroll)
    out = einsum("bshk,hkd->bsd", attn, p.wo.to(dt))
    return out, (ckv, kr[:, :, 0, :])


def mla_decode(p: MLA, x, cache_ckv, cache_kr, pos: int, nope_dim=128, rope_dim=64,
               rope_theta=10000.0, rope_scaling=None):
    """Absorbed decode: x [B,1,D]; cache_ckv [B,T,kvl] and cache_kr
    [B,T,rope] are written at ``pos`` in place and returned.  The
    reference's ``dynamic_update_slice`` clamps a ``pos`` past the cache
    onto its last slot; the port raises ``ValueError``, as its
    ``gqa_decode`` does."""
    if pos >= cache_ckv.shape[1]:
        raise ValueError(f"decode position {pos} is past the cache length "
                         f"{cache_ckv.shape[1]}")
    B = x.shape[0]
    dt = x.dtype
    positions = torch.full((B, 1), pos, device=x.device)
    cos, sin = rope_angles(positions, rope_dim, rope_theta, rope_scaling)
    qn, qr = _queries(p, x, cos, sin, nope_dim)                     # [B,1,H,*]
    ckv_t, kr_t = _latent(p, x, cos, sin)
    write_slice(cache_ckv, pos, ckv_t)
    write_slice(cache_kr, pos, kr_t[:, :, 0, :])
    # absorb W_uk into the query: q_lat [B,H,kvl]
    q_lat = torch.einsum("bhk,chk->bhc", qn[:, 0], p.wuk.to(dt))
    s = torch.einsum("bhc,btc->bht", q_lat, cache_ckv).float()
    s = s + torch.einsum("bhk,btk->bht", qr[:, 0], cache_kr).float()
    if rope_scaling is None:
        s = s / math.sqrt(nope_dim + rope_dim)
    else:
        s = s * (rope_scaling.softmax_factor / math.sqrt(nope_dim + rope_dim))
    valid = torch.arange(cache_ckv.shape[1], device=x.device) < pos + 1
    s = s.masked_fill(~valid[None, None, :], -1e30)
    prob = torch.softmax(s, dim=-1).to(cache_ckv.dtype)
    ctx = torch.einsum("bht,btc->bhc", prob, cache_ckv)            # latent context
    out_v = torch.einsum("bhc,chk->bhk", ctx, p.wuv.to(dt))         # expand to v_dim
    out = torch.einsum("bhk,hkd->bd", out_v, p.wo.to(dt))[:, None, :]
    return out, cache_ckv, cache_kr
