"""Mixture-of-Experts layer: sort-based capacity dispatch, as in the JAX
package's ``models/moe.py``.

Token-slots (token t, choice j of its top-k) are sorted by expert and
gathered into dense [E, C, D] groups, so the expert products are three
batched matmuls over [E, C, D] (plain torch: the reference leaves them to
XLA, outside any Pallas kernel).  Slots past an expert's capacity C are
dropped; they contribute only through the residual (and the shared
experts).  What decides a token's fate is integer work and must match the
reference exactly:

- top-k: ``jax.lax.top_k`` puts the lower expert index first among equal
  probabilities.  ``torch.topk`` documents no order for ties, so the port
  takes the first k of a *stable* descending sort, which keeps the lower
  index first, as the reference does.
- capacity: ``C = int(max(1, ceil(T·k/E) · capacity_factor))``.
- dispatch: a stable sort of the flat slots by expert (``jnp.argsort`` is
  stable), so an expert keeps its first C slots in token order.

The combine gathers each token's k gated expert outputs and adds them in
the order of its choices, one fixed order: no atomics (``index_add_`` on a
CUDA bf16 tensor adds repeated indices in no fixed order), so two runs give
the same bits.  The reference scatter-adds in its own order; the sums agree
within rounding.

On a mesh (DTensor activations) the layer computes the reference's
function over the global T tokens, as GSPMD computes it: the router's
probabilities are made whole and every rank routes them in one region
(``_route_on_mesh``: one capacity, one sort, the same dropped slots); the
dispatch into [E, C, D] split on "experts" and the combine back into [T, D]
split on the batch run per rank (``_dispatch``, ``_combine``) with stated
gradient placements; the expert products go through the mesh-aware
``layers.einsum``.  DTensor has no strategy for the routing's bincount and
cannot shard the index ops' backward.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import _mesh
from .common import make_param
from .layers import MLP, _is_dtensor, einsum, lsc, matmul, mlp_forward


class MoE(nn.Module):
    def __init__(self, gen, d_model: int, d_ff_expert: int, n_experts: int,
                 n_shared: int = 0, device=None):
        super().__init__()
        self.router = make_param(gen, (d_model, n_experts), ("embed", None), d_model ** -0.5,
                                 device=device)
        self.wg = make_param(gen, (n_experts, d_model, d_ff_expert),
                             ("experts", "embed", "ffn"), d_model ** -0.5,
                             device=device)
        self.wu = make_param(gen, (n_experts, d_model, d_ff_expert),
                             ("experts", "embed", "ffn"), d_model ** -0.5,
                             device=device)
        self.wd = make_param(gen, (n_experts, d_ff_expert, d_model),
                             ("experts", "ffn", "embed"), d_ff_expert ** -0.5,
                             device=device)
        self.shared = (MLP(gen, d_model, d_ff_expert * n_shared, device)
                       if n_shared > 0 else None)


def capacity(n_tokens: int, top_k: int, n_experts: int, capacity_factor: float) -> int:
    """Slots per expert, the reference's formula to the rounding."""
    return int(max(1, -(-(n_tokens * top_k) // n_experts) * capacity_factor))


@dataclasses.dataclass
class Routing:
    """Where each of the T·k token-slots goes.  ``top_e`` [T,k]: its
    expert; ``kept`` [T,k]: the slot is inside its expert's capacity;
    ``where`` [T,k]: its row in the flat [E·C] expert batch (meaningful
    where kept); ``token_idx`` [E,C]: the token each expert row reads (rows
    past an expert's count read a clamped slot and get gate 0, as in the
    reference); ``gate`` [E,C]: the renormalised routing weight, fp32."""
    top_e: torch.Tensor
    kept: torch.Tensor
    where: torch.Tensor
    token_idx: torch.Tensor
    gate: torch.Tensor
    aux_loss: torch.Tensor
    cap: int

    @property
    def dropped(self) -> int:
        """Token-slots past their expert's capacity."""
        return int((~self.kept).sum())


def route(router, xf, top_k: int, capacity_factor: float) -> Routing:
    """xf [T,D] → the routing of its T·k token-slots and the Switch aux
    loss.  The router runs in fp32, the reference's default, which no
    caller of either package changes.  On a mesh the routing is computed
    whole on every rank (``_route_on_mesh``)."""
    probs = torch.softmax(matmul(xf.float(), router.float()), dim=-1)    # [T,E]
    if _is_dtensor(probs):
        return _route_on_mesh(probs, top_k, capacity_factor)
    cap = capacity(xf.shape[0], top_k, router.shape[-1], capacity_factor)
    return Routing(*_route_probs(probs, top_k, cap), cap)


def _route_probs(probs, top_k: int, cap: int):
    """The integer work of the routing, from probs [T,E] → (top_e, kept,
    where, token_idx, gate, aux_loss): ``Routing``'s tensors."""
    T, E = probs.shape
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :top_k], top_e[:, :top_k]              # ties: lower index
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # load-balancing auxiliary loss (Switch): E * sum_e f_e * p_e
    TK = T * top_k
    flat_e = top_e.reshape(TK)
    counts = torch.zeros(E, dtype=flat_e.dtype, device=probs.device).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    aux_loss = E * torch.sum(probs.mean(0) * (counts.float() / TK))

    sort_idx = torch.argsort(flat_e, stable=True)                  # [TK]
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(sort_idx)
    rank[sort_idx] = torch.arange(TK, device=probs.device)
    within = rank - offsets[flat_e]                                # slot's place in its expert
    kept = within < cap
    where = flat_e * cap + torch.clamp(within, max=cap - 1)

    col = torch.arange(cap, device=probs.device)
    slot = torch.clamp(offsets[:, None] + col[None, :], max=TK - 1)   # [E,C]
    valid = col[None, :] < counts[:, None]
    token_slot = sort_idx[slot]
    gate = top_p.reshape(TK)[token_slot] * valid
    return (top_e, kept.reshape(T, top_k), where.reshape(T, top_k), token_slot // top_k,
            gate, aux_loss)


def _route_on_mesh(probs, top_k: int, capacity_factor: float) -> Routing:
    """The routing of a DTensor probs [T,E] (the tokens split on the batch's
    mesh dims): probs are made whole, T·E·4 bytes on every rank (67 MB at
    phi3.5-moe × train_4k's 1 M tokens and 16 experts, 671 MB at
    deepseek-v2's 160), the one activation the mesh path gathers whole
    where the reference keeps it split, and every rank computes the same
    ``Routing`` in one region: one capacity from the global T, one stable
    sort of all T·k slots, the reference's kept and dropped slots.
    Routing per rank over its own tokens would take the capacity over local
    T and drop other slots: another function."""
    from torch.distributed.tensor import Replicate

    mesh = probs.device_mesh
    whole = [Replicate()] * mesh.ndim
    T, E = probs.shape
    cap = capacity(T, top_k, E, capacity_factor)
    outs = _mesh.run(lambda p: _route_probs(p, top_k, cap), (probs,), (whole,),
                     (whole,) * 6, mesh)
    return Routing(*outs, cap)


def _split_dims(xf, experts):
    """Per mesh dim of xf [T,D]'s mesh: (tokens split there, experts split
    there), the experts' split read off an expert weight's placements
    (``experts``; [E,·,·] at "experts", as the activations [E,C,D] are):
    the resolver is not installed where autograd recomputes a block in
    another thread."""
    return [(p.is_shard(0), q.is_shard(0)) for p, q in zip(xf.placements, experts)]


def _shard_of(mesh, dims) -> int:
    """This rank's shard index over the mesh dims ``dims``, major to minor."""
    shard = 0
    for i in dims:
        shard = shard * mesh.size(i) + mesh.get_local_rank(i)
    return shard


def _dispatch(xf, token_idx, experts):
    """expert_in [E,C,D] = xf[token_idx]: the tokens each expert row reads.
    On a mesh, per rank: on a mesh dim that splits the tokens, each rank
    reads the rows of its own tokens, zeros elsewhere, and the output is
    their partial sum; on one that splits the experts, its experts' rows;
    on one that splits both (experts on the data axis), the tokens are
    made whole there first (the exchange GSPMD makes an all-to-all).  xf's
    gradient is partial where it meets one shard of the experts."""
    E, C = token_idx.shape
    D = xf.shape[-1]
    if not _is_dtensor(xf):
        return xf[token_idx.reshape(-1)].reshape(E, C, D)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = xf.device_mesh
    dims = _split_dims(xf, experts)
    masked = [i for i, (tok, exp) in enumerate(dims) if tok and not exp]
    px, gx, pi, po = [], [], [], []
    for tok, exp in dims:
        px.append(Shard(0) if tok and not exp else Replicate())
        gx.append(Shard(0) if tok and not exp else Partial() if exp else Replicate())
        pi.append(Shard(0) if exp else Replicate())
        po.append(Shard(0) if exp else Partial() if tok else Replicate())
    shard = _shard_of(mesh, masked)

    def local(x, idx):
        n = x.shape[0]
        rel = idx.reshape(-1) - shard * n
        inside = (rel >= 0) & (rel < n)
        rows = x[rel.clamp(0, n - 1)] * inside[:, None].to(x.dtype) if masked else x[rel]
        return rows.reshape(idx.shape[0], C, D)

    return _mesh.run(local, (xf, token_idx), (px, pi), po, mesh, (gx, pi))


def _combine(out_e, where, kept, xf, experts):
    """out [T,D]: each token's k expert outputs out_e [E,C,D] at its rows
    ``where`` [T,k], zero where dropped, added in the order of its choices.
    On a mesh, per rank at xf's token split: on a mesh dim that splits the
    experts, each rank adds the rows of its experts, zeros elsewhere, and
    the output is their partial sum; where the tokens are split, each rank
    takes its own tokens' rows (made whole on a dim that splits both)."""
    E, C, D = out_e.shape
    k = where.shape[1]

    def add(rows, idx, keep):
        contrib = rows.reshape(-1, D)[idx] * keep[..., None].to(rows.dtype)   # [T,k,D]
        out = contrib[:, 0]
        for j in range(1, k):
            out = out + contrib[:, j]
        return out

    if not _is_dtensor(out_e):
        return add(out_e, where, kept)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = out_e.device_mesh
    dims = _split_dims(xf, experts)
    tokens = [i for i, (tok, _) in enumerate(dims) if tok]
    masked = [i for i, (tok, exp) in enumerate(dims) if exp and not tok]
    pe, ge, po = [], [], []
    for tok, exp in dims:
        pe.append(Shard(0) if exp and not tok else Replicate())
        ge.append(Shard(0) if exp and not tok else Partial() if tok else Replicate())
        po.append(Shard(0) if tok else Partial() if exp else Replicate())
    whole = [Replicate()] * mesh.ndim
    n_tok = math.prod(mesh.size(i) for i in tokens)
    tshard, eshard = _shard_of(mesh, tokens), _shard_of(mesh, masked)

    def local(rows, idx, keep):
        n = idx.shape[0] // n_tok
        idx, keep = idx[tshard * n:(tshard + 1) * n], keep[tshard * n:(tshard + 1) * n]
        if masked:
            m = rows.shape[0] * C
            idx = idx - eshard * m
            keep = keep & (idx >= 0) & (idx < m)
            idx = idx.clamp(0, m - 1)
        return add(rows, idx, keep)

    return _mesh.run(local, (out_e, where, kept), (pe, whole, whole), po, mesh,
                     (ge, whole, whole))


def moe_forward(p: MoE, x, top_k: int, capacity_factor: float = 1.25):
    """x [B,S,D] → (out [B,S,D], aux_loss)."""
    B, S, D = x.shape
    dt = x.dtype
    xf = x.reshape(B * S, D)
    r = route(p.router, xf, top_k, capacity_factor)
    experts = p.wg.placements if _is_dtensor(p.wg) else ()
    expert_in = lsc(_dispatch(xf, r.token_idx, experts), "experts", None, None)
    g = einsum("ecd,edf->ecf", expert_in, p.wg.to(dt))
    u = einsum("ecd,edf->ecf", expert_in, p.wu.to(dt))
    h = lsc(F.silu(g) * u, "experts", None, "ffn")
    out_e = einsum("ecf,efd->ecd", h, p.wd.to(dt))
    out_e = out_e * r.gate[..., None].to(dt)
    # each token's k contributions in the order of its choices; a dropped
    # slot adds 0
    out = lsc(_combine(out_e, r.where, r.kept, xf, experts).reshape(B, S, D),
              "batch", "seq", None)
    if p.shared is not None:
        out = out + mlp_forward(p.shared, x)
    return out, r.aux_loss
