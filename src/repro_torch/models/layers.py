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
the JAX package's own path (``unroll=True``: its causal block skip).  Decode
attention is plain torch, as it is plain jnp in the reference.

``lsc`` is the reference's logical sharding constraint, at the reference's
sites: with no resolver installed (``set_activation_resolver``) it is the
identity; with one, a DTensor activation is redistributed to the placements
the resolver gives for its logical axes (``distributed.sharding``).
"""
from __future__ import annotations

import math
from contextvars import ContextVar

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import _mesh
from ..kernels.flash_attention.ops import flash_attention
from .common import make_param

NEG_INF = -1e30

# -- logical activation sharding ----------------------------------------------------
# The distributed layer installs a resolver (logical axes, shape) ->
# placements; model code annotates activations with logical axes and stays
# mesh-agnostic.
_ACT_RESOLVER: ContextVar = ContextVar("act_resolver", default=None)


def set_activation_resolver(resolver):
    return _ACT_RESOLVER.set(resolver)


def reset_activation_resolver(token):
    _ACT_RESOLVER.reset(token)


def lsc(x, *axes):
    """Logical sharding constraint: x itself without a resolver or when x
    is a plain tensor; a DTensor x redistributed to the resolver's
    placements for ``axes`` otherwise."""
    resolver = _ACT_RESOLVER.get()
    if resolver is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    placements = resolver(axes, x.shape)
    if tuple(placements) == tuple(x.placements):
        return x
    return x.redistribute(resolver.mesh, placements)


def _is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor"


def _unflatten(x, dim: int, sizes):
    """``x.unflatten(dim, sizes)``.  DTensor shards the result's first size
    where it shards ``dim``, so a DTensor whose ``dim`` is split over more
    ranks than ``sizes[0]`` divides (24 heads of 128 over 16) is first made
    whole on those mesh dims (GSPMD would pad; DTensor cannot)."""
    if _is_dtensor(x):
        from torch.distributed.tensor import Replicate

        dim = dim % x.dim()
        split = [i for i, p in enumerate(x.placements) if p.is_shard(dim)]
        n = math.prod(x.device_mesh.size(i) for i in split)
        if split and sizes[0] % n:
            placements = list(x.placements)
            for i in split:
                placements[i] = Replicate()
            x = x.redistribute(x.device_mesh, placements)
    return x.unflatten(dim, sizes)


def einsum(eq: str, a, b):
    """``torch.einsum(eq, a, b)``; on DTensors each rank's einsum of its
    local shards (``_einsum_on_mesh``)."""
    if not (_is_dtensor(a) or _is_dtensor(b)):
        return torch.einsum(eq, a, b)
    return _einsum_on_mesh(eq, a, b)


def matmul(x, w):
    """``x @ w`` for x [..., K] and a 2-D w [K, N]; on DTensors through
    ``einsum``."""
    if not (_is_dtensor(x) or _is_dtensor(w)):
        return x @ w
    lead = "abcdefgh"[:x.dim() - 1]
    return _einsum_on_mesh(f"{lead}k,kn->{lead}n", x, w, torch.matmul)


def _einsum_on_mesh(eq: str, a, b, local=None):
    """A two-operand einsum over DTensors, as GSPMD places one: on each mesh
    dim the operand ``a`` (the activation) keeps its split, ``b`` follows
    it (a weight split elsewhere there is gathered: FSDP's all-gather), the
    output is split where the split letter survives and partial where it is
    summed over.  Where ``a`` is whole and ``b`` split on a letter summed
    over, ``b`` is gathered if it is no larger than twice the output (the
    all-reduce a partial output would take), as the MoE's expert weights
    are against their [E, C, ·] rows at training shapes; else ``a`` follows
    it.  Each rank then runs the plain einsum on its shards inside
    ``local_map`` (``local``, the same product in another form, where
    given), so no reshape of a split dim reaches DTensor's sharding
    propagation, in the forward or the backward (which cannot unflatten 24
    heads split 16 ways, nor flatten a batch and a sequence split over two
    mesh dims)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = (a if _is_dtensor(a) else b).device_mesh
    a, b = (t if _is_dtensor(t) else DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                                         run_check=False) for t in (a, b))
    ins, out = eq.replace(" ", "").split("->")
    sa, sb = ins.split(",")
    if "." in eq or len(sa) != a.dim() or len(sb) != b.dim():
        raise ValueError(f"einsum on a mesh takes explicit subscripts, not {eq!r}")

    def letter(spec, p):
        return spec[p.dim] if isinstance(p, Shard) else None

    sizes = {**dict(zip(sb, b.shape)), **dict(zip(sa, a.shape))}
    gather_b = b.numel() <= 2 * math.prod(sizes[c] for c in out)
    pa, pb, po, ga, gb = [], [], [], [], []
    for i in range(mesh.ndim):
        lead = letter(sa, a.placements[i]) or letter(sb, b.placements[i])
        if (lead is not None and letter(sa, a.placements[i]) is None and lead not in out
                and gather_b):
            lead = None     # gathering b moves fewer bytes than reducing the output
        if lead is None:
            for p in (pa, pb, po, ga, gb):
                p.append(Replicate())
            continue
        pa.append(Shard(sa.index(lead)) if lead in sa else Replicate())
        pb.append(Shard(sb.index(lead)) if lead in sb else Replicate())
        po.append(Shard(out.index(lead)) if lead in out else Partial())
        # an operand whole on this mesh dim met one shard of the other: its
        # gradient is this rank's part of a sum
        ga.append(pa[-1] if lead in sa else Partial())
        gb.append(pb[-1] if lead in sb else Partial())
    fn = local_map(local or (lambda x, y: torch.einsum(eq, x, y)), out_placements=po,
                   in_placements=(pa, pb), in_grad_placements=(ga, gb),
                   redistribute_inputs=True, device_mesh=mesh)
    return fn(a, b)


def embed_lookup(table, ids):
    """``table[ids]``: rows of table [V, D] for ids [...] → [..., D].  On a
    DTensor table each rank looks up its own shard: where the ids are split
    (batch) the table is whole and its gradient partial; where the table's
    rows are split (vocab) each rank gives its own rows, zeros elsewhere,
    and the output is their partial sum (DTensor's ``_MaskPartial``, written
    out: DTensor's own index ops do not shard this lookup's backward)."""
    if not (_is_dtensor(table) or _is_dtensor(ids)):
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    if not _is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim, run_check=False)
    pt, pi, po, gt = [], [], [], []
    for i in range(mesh.ndim):
        p = ids.placements[i]
        if p.is_shard():
            pt.append(Replicate()), pi.append(p), po.append(Shard(p.dim)), gt.append(Partial())
        elif table.placements[i].is_shard(0):
            pt.append(Shard(0)), pi.append(Replicate()), po.append(Partial()), gt.append(Shard(0))
        else:
            pt.append(Replicate()), pi.append(Replicate()), po.append(Replicate())
            gt.append(Replicate())
    split = [i for i in range(mesh.ndim) if pt[i].is_shard(0)]
    rows = table.shape[0] // math.prod(mesh.size(i) for i in split)
    shard = 0
    for i in split:                     # this rank's rows, major to minor
        shard = shard * mesh.size(i) + mesh.get_local_rank(i)

    def local(t, idx):
        if not split:
            return t[idx]
        rel = idx - shard * rows
        inside = (rel >= 0) & (rel < rows)
        return t[rel.clamp(0, rows - 1)] * inside[..., None].to(t.dtype)

    return local_map(local, out_placements=po, in_placements=(pt, pi),
                     in_grad_placements=(gt, pi), redistribute_inputs=True,
                     device_mesh=mesh)(table, ids)


def gather_last(x, idx):
    """``x[..., idx]`` per position: x [..., V], idx [...] → [...].  On a
    DTensor each rank gathers from its own rows, with V whole: DTensor's
    own gather would take its backward through zeros of x's global shape
    on every rank."""
    if not _is_dtensor(x):
        return torch.gather(x, -1, idx[..., None])[..., 0]
    from torch.distributed.tensor import Replicate, Shard

    last = x.dim() - 1
    px = [Replicate() if p.is_shard(last) else p for p in x.placements]
    pi = [p if isinstance(p, Shard) else Replicate() for p in px]
    return _mesh.run(lambda t, i: torch.gather(t, -1, i[..., None])[..., 0], (x, idx),
                     (px, pi), pi, x.device_mesh)


def write_slice(cache, start, value) -> None:
    """``cache[:, start:start + n] = value`` in place (n = value.shape[1]),
    cast to the cache's dtype.  ``start`` is an int, or a 0-d int64 tensor
    on the cache's device (a captured decode step's position), written at
    by ``index_copy_`` along dim 1 with no read on the host.  On a DTensor
    cache each rank writes, into its own shard, the part of ``value`` that
    falls there: a cache split on dim 1 (the sequence, "seq_kv") takes a
    write at any position, which a DTensor slice of a split dim would make
    into a copy."""
    n = value.shape[1]
    if isinstance(start, torch.Tensor):
        rows = start.reshape(1) + torch.arange(n, device=cache.device)
        cache.index_copy_(1, rows, value.to(cache.dtype))
        return
    if not _is_dtensor(cache):
        cache[:, start:start + n] = value.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate

    mesh = cache.device_mesh
    split = [i for i, p in enumerate(cache.placements) if p.is_shard(1)]
    whole = [Replicate() if p.is_shard(1) else p for p in cache.placements]
    value = value.to(cache.dtype).redistribute(mesh, whole).to_local()
    local = cache.to_local()
    shard = 0
    for i in split:                     # this rank's shard of dim 1, major to minor
        shard = shard * mesh.size(i) + mesh.get_local_rank(i)
    lo = shard * local.shape[1]
    a, b = max(start, lo), min(start + n, lo + local.shape[1])
    if a < b:
        local[:, a - lo:b - lo] = value[:, a - start:b - start]


# -- norms ---------------------------------------------------------------------------
def rms_norm(x, w, eps=1e-5):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.w = make_param(None, (d,), ("embed",), init="ones", device=device)

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
                      q_chunk=2048, kv_chunk=2048, unroll=False):
    """Online-softmax flash attention in plain torch, chunk by chunk over q
    and kv: the peak intermediate is [B,Hkv,G,qc,kc].  p is cast to v's
    dtype before P·V, as in the JAX package.  ``unroll=True`` takes
    ``_attention_unrolled``, which skips the kv blocks a causal mask hides
    whole (the reference's dry-run probes use it)."""
    if unroll:
        return _attention_unrolled(q, k, v, causal, kv_len, pos_offset, q_chunk, kv_chunk)
    return _attention_blocks(q, k, v, causal, kv_len, pos_offset, q_chunk, kv_chunk, False)


def _attention_unrolled(q, k, v, causal, kv_len, pos_offset, q_chunk, kv_chunk):
    """The reference's straight-line attention with causal block skipping: a
    kv block wholly past a q block's last position is not computed (its
    rows would add exp(-inf) = 0 to each sum, so the result is unchanged)."""
    return _attention_blocks(q, k, v, causal, kv_len, pos_offset, q_chunk, kv_chunk, True)


def _attention_blocks(q, k, v, causal, kv_len, pos_offset, q_chunk, kv_chunk, skip):
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
            if skip and causal and k0 > pos_offset + q0 + n - 1:
                continue  # fully-masked block: triangular skip
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


def attention(q, k, v, causal=True, q_chunk=2048, kv_chunk=2048, unroll=False):
    """Prefill attention: K2 (``flash_attention``) on a CUDA tensor, the JAX
    package's chunked path on the CPU (``unroll``: its causal block skip).
    On a DTensor (the mesh path) the same, by the DTensor's device, each
    rank on its local shards: on the card K2's own mesh path; on the CPU
    the chunked path at K2's placements, except that q's heads are made
    whole where k's cannot be split as they are (64 query heads over 16
    ranks, 8 kv heads)."""
    if q.is_cuda:
        return flash_attention(q, k, v, causal=causal)
    if not _is_dtensor(q):
        return attention_chunked(q, k, v, causal=causal, q_chunk=q_chunk,
                                 kv_chunk=kv_chunk, unroll=unroll)
    from torch.distributed.tensor import Replicate

    placements = _mesh.base_placements(q, "attention")
    if k.shape[2] % _mesh.heads_split(q.device_mesh, placements):
        placements = tuple(Replicate() if p.is_shard(2) else p for p in placements)
    return _mesh.run(
        lambda q, k, v: attention_chunked(q, k, v, causal=causal, q_chunk=q_chunk,
                                          kv_chunk=kv_chunk, unroll=unroll),
        (q, k, v), (placements,) * 3, list(placements), q.device_mesh)


def attention_decode(q, k_cache, v_cache, pos):
    """Single-token decode vs a (padded) cache.  q [B,1,Hq,D],
    caches [B,T,Hkv,D], ``pos`` = number of valid cache entries (int, [B]
    or a 0-d tensor)."""
    B, _, Hq, D = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qg = _unflatten(q[:, 0], 1, (Hkv, G))
    s = einsum("bhgd,bthd->bhgt", qg, k_cache).float() / math.sqrt(D)
    kv_pos = torch.arange(T, device=q.device)
    limit = pos if isinstance(pos, int) else pos.reshape(-1, 1)
    valid = (kv_pos[None, :] < limit).expand(B, T)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = einsum("bhgt,bthd->bhgd", p, v_cache)
    return out.reshape(B, 1, Hq, D)


# -- GQA attention block ----------------------------------------------------------------
class GQA(nn.Module):
    def __init__(self, gen, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                 device=None):
        super().__init__()
        self.wq = make_param(gen, (d_model, n_heads, head_dim), ("embed", "heads", "head"),
                             d_model ** -0.5, device=device)
        self.wk = make_param(gen, (d_model, n_kv, head_dim), ("embed", "kv_heads", "head"),
                             d_model ** -0.5, device=device)
        self.wv = make_param(gen, (d_model, n_kv, head_dim), ("embed", "kv_heads", "head"),
                             d_model ** -0.5, device=device)
        self.wo = make_param(gen, (n_heads, head_dim, d_model), ("heads", "head", "embed"),
                             (n_heads * head_dim) ** -0.5, device=device)


def gqa_qkv(p: GQA, x):
    q = einsum("bsd,dhk->bshk", x, p.wq.to(x.dtype))
    k = einsum("bsd,dhk->bshk", x, p.wk.to(x.dtype))
    v = einsum("bsd,dhk->bshk", x, p.wv.to(x.dtype))
    return q, k, v


def gqa_out(p: GQA, attn):
    return einsum("bshk,hkd->bsd", attn, p.wo.to(attn.dtype))


def gqa_forward(p: GQA, x, cos, sin, causal=True, q_chunk=2048, kv_chunk=2048,
                unroll=False):
    """Full-sequence attention block → (out, (k, v)) with k after RoPE."""
    q, k, v = gqa_qkv(p, x)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    q = lsc(q, "batch", "seq", "heads", None)
    k = lsc(k, "batch", "seq", "kv_heads", None)
    attn = attention(q, k, v, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk,
                     unroll=unroll)
    return gqa_out(p, attn), (k, v)


def gqa_decode(p: GQA, x, cache_k, cache_v, pos, cos, sin):
    """x [B,1,D]; writes K/V at ``pos`` and attends over the valid prefix.
    The caches are updated in place (the JAX package returns new arrays);
    they are returned too, as in the reference.  ``pos`` is an int, or a
    0-d int64 tensor on the device (a captured step), whose bound its
    caller checks: here that would read it on the host."""
    if isinstance(pos, int) and pos >= cache_k.shape[1]:
        raise ValueError(f"decode position {pos} is past the cache length "
                         f"{cache_k.shape[1]}")
    q, k, v = gqa_qkv(p, x)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    write_slice(cache_k, pos, k)
    write_slice(cache_v, pos, v)
    out = attention_decode(q, cache_k, cache_v, pos + 1)
    return gqa_out(p, out), cache_k, cache_v


# -- SwiGLU MLP -----------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, gen, d_model: int, d_ff: int, device=None):
        super().__init__()
        self.wg = make_param(gen, (d_model, d_ff), ("embed", "ffn"), d_model ** -0.5, device=device)
        self.wu = make_param(gen, (d_model, d_ff), ("embed", "ffn"), d_model ** -0.5, device=device)
        self.wd = make_param(gen, (d_ff, d_model), ("ffn", "embed"), d_ff ** -0.5, device=device)


def mlp_forward(p: MLP, x):
    g = einsum("bsd,df->bsf", x, p.wg.to(x.dtype))
    u = einsum("bsd,df->bsf", x, p.wu.to(x.dtype))
    h = lsc(F.silu(g) * u, "batch", "seq", "ffn")
    return einsum("bsf,fd->bsd", h, p.wd.to(x.dtype))
