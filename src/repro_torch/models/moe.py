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

DeepSeek-V2's published routing and its expert-parallel share (options off
by default, so the defaults compute the reference's function):

- ``n_group``/``topk_group``: group-limited greedy routing (its
  ``MoEGate``): the softmax over every expert; a group of E/n_group
  consecutive experts scores its largest probability; the top
  ``topk_group`` groups are kept (ties to the lower group, by the same
  stable sort) and the other groups' probabilities set to 0; the top k
  are taken from what is left.  ``norm_topk_prob=False`` leaves the k
  weights unnormalised; ``routed_scaling_factor`` multiplies them.
- ``held=(first, count)`` (``MoE``'s, from ``ModelConfig.experts_held``):
  the layer holds the weights of experts [first, first + count) only, as
  one chip of an expert-parallel layer does, routes over all E (the
  router keeps its E outputs) and computes its own experts' part: a slot
  whose expert is held elsewhere adds nothing here.  The shared experts
  are added on every chip.  Off a mesh only; the exchange between chips
  is not built.
- ``capacity_factor=None``: dropless, as the published inference path
  computes every selected expert.  The caller says how: ``ragged`` (a
  full-sequence pass, the prefill's) reads the held experts' counts on
  the host, one read a layer, and runs each expert's products over its
  own rows alone, in the slots' sorted order (one grouped GEMM a
  projection over all the experts' runs), so no row is padded (a
  padded [E, C, D] batch at C = the largest count would cost what the
  busiest expert holds times every expert).  On a card the read is
  queued before the shared experts' MLP, so the device computes that
  while the host waits for the counts and launches the experts'
  products (``_read_behind``).  Otherwise (a decode step) no host read:
  where the step's T·k slots are fewer than the E experts, all T·k slots
  stay, the held ones sorted first by expert, and the same grouped GEMMs
  run over the counts and offsets on the device (``_grouped_experts``), so
  an expert no slot chose has none of its weights read; the rows past the
  last held slot are not written, and the combine selects them out.  At a
  decode batch's few tokens the products are bound by reading the
  weights, so this reads only the routed experts' bytes.  Where T·k ≥ E,
  nearly every expert is chosen, and C = T: a token picks an expert at
  most once, so T is always enough.  Off a mesh only.
- ``pads`` [T] (the model's, from ``ModelConfig.unrouted_pad``): tokens
  that take no routed slot, the serving engine's left pads.  They hold no
  token, and a batch's pads share one hidden state, so routed they would
  all follow one routing decision, which rounding can flip near a tie.
  They still pass through the shared experts.

Nemotron-H's (DeepSeek-V3's ``noaux_tc`` rule, as ``NemotronHTopkRouter``
has it), also off by default:

- ``Rule.scoring="sigmoid"``: s = sigmoid(x·W_router) in fp32; the experts
  are the top k of s + the layer's ``e_score_correction_bias`` [E] (fp32;
  a stable sort, ties to the lower index), weighted by s alone, normalised
  with + 1e-20 where ``norm_topk_prob``, times ``routed_scaling_factor``.
  With ``n_group`` > 1 it raises: V3's group score (the sum of a group's
  best two) is not built.
- ``MoE``'s ``act="relu2"``: ungated experts, down(relu(up·x)²), holding
  ``wu`` and ``wd`` alone; the shared expert likewise, of width
  ``d_ff_shared``.

``moe_forward`` adds, where given ``counts`` (an int64 [5] on the device,
the model's running sums; no host read), the slots routed (pads' left
out), the slots whose expert is held here, the expert rows computed (held
experts × C, or the held slots on the grouped routes), the held slots
dropped past the capacity, and the held experts whose weights the products
read (those with a row on the grouped routes, every one at C = T or under
a capacity).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import _mesh
from .common import make_param
from .layers import MLP, _is_dtensor, einsum, lsc, matmul, mlp_forward


@dataclasses.dataclass(frozen=True)
class Rule:
    """How a token picks its experts (the module's doc): ``n_group`` 0 is
    greedy over every expert, else the ``topk_group`` best of ``n_group``
    groups; ``norm_topk_prob`` renormalises the k weights and
    ``routed_scaling_factor`` multiplies them; ``scoring`` softmax, or
    sigmoid chosen with a correction bias.  The defaults are the JAX
    package's rule."""
    n_group: int = 0
    topk_group: int = 0
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    scoring: str = "softmax"       # or "sigmoid", with the layer's correction bias

    def __post_init__(self):
        if self.scoring not in ("softmax", "sigmoid"):
            raise ValueError(f"routing scores {self.scoring!r}: softmax or sigmoid")
        if self.scoring == "sigmoid" and self.n_group > 1:
            raise ValueError("sigmoid routing over groups (the sum of a group's best two "
                             "scores) is not built: n_group must be 0 or 1")


class MoE(nn.Module):
    """The router over all ``n_experts``; the expert weights of ``held``
    (first, count) only, all of them by default.  ``act`` "swiglu" (wg, wu,
    wd) or "relu2" (wu, wd); ``score_bias`` adds the sigmoid rule's
    ``e_score_correction_bias`` [E]; ``d_ff_shared`` is the shared experts'
    width, ``d_ff_expert * n_shared`` by default."""

    def __init__(self, gen, d_model: int, d_ff_expert: int, n_experts: int,
                 n_shared: int = 0, device=None, held=None, act: str = "swiglu",
                 score_bias: bool = False, d_ff_shared: int = 0):
        super().__init__()
        if act not in ("swiglu", "relu2"):
            raise ValueError(f"expert activation {act!r}: swiglu or relu2")
        if held is not None:
            first, count = held
            if not (0 <= first and 0 < count and first + count <= n_experts):
                raise ValueError(f"experts held {held} are not a range of the {n_experts}")
            held = (first, count)
        self.held = held
        n_held = n_experts if held is None else held[1]
        self.router = make_param(gen, (d_model, n_experts), ("embed", None), d_model ** -0.5,
                                 device=device)
        if score_bias:
            self.e_score_correction_bias = make_param(gen, (n_experts,), (None,),
                                                      init="zeros", device=device)
        else:
            self.e_score_correction_bias = None
        self.wg = None if act == "relu2" else make_param(
            gen, (n_held, d_model, d_ff_expert), ("experts", "embed", "ffn"), d_model ** -0.5,
            device=device)
        self.wu = make_param(gen, (n_held, d_model, d_ff_expert),
                             ("experts", "embed", "ffn"), d_model ** -0.5,
                             device=device)
        self.wd = make_param(gen, (n_held, d_ff_expert, d_model),
                             ("experts", "ffn", "embed"), d_ff_expert ** -0.5,
                             device=device)
        self.shared = (MLP(gen, d_model, d_ff_shared or d_ff_expert * n_shared, device, act)
                       if n_shared > 0 else None)


def capacity(n_tokens: int, top_k: int, n_experts: int, capacity_factor: float) -> int:
    """Slots per expert, the reference's formula to the rounding."""
    return int(max(1, -(-(n_tokens * top_k) // n_experts) * capacity_factor))


@dataclasses.dataclass
class Routing:
    """Where each of the T·k token-slots goes.  ``top_e`` [T,k]: its
    expert; ``kept`` [T,k]: the slot's expert is held here and the slot is
    inside its capacity; ``where`` [T,k]: its row in the flat [E·C] expert
    batch of the held experts (meaningful where kept); ``token_idx``
    [E,C]: the token each expert row reads (rows past an expert's count
    read a clamped slot and get gate 0, as in the reference); ``gate``
    [E,C]: the routing weight, fp32; ``held`` [T,k]: the slot's expert is
    held here and its token is not a pad (all True by default).  Grouped
    (dropless, ``_route_probs``' ``cap`` None): ``counts`` holds each held
    expert's count on the device, ``token_idx`` and ``gate`` are flat [T·k]
    over the slots in their sorted order, the held slots first, and
    ``where`` a slot's place in it; where ragged, ``ragged_rows`` reads the
    counts into ``sizes``, keeps the held slots alone and sets ``cap`` to
    the largest count."""
    top_e: torch.Tensor
    kept: torch.Tensor
    where: torch.Tensor
    token_idx: torch.Tensor
    gate: torch.Tensor
    aux_loss: torch.Tensor
    held: torch.Tensor
    cap: int
    counts: Optional[torch.Tensor] = None
    sizes: Optional[List[int]] = None

    @property
    def rows(self):
        """The expert rows the products compute (a device sum on a decode
        step's grouped route)."""
        if self.sizes is not None:
            return sum(self.sizes)
        return self.gate.numel() if self.counts is None else self.counts.sum()

    @property
    def experts_read(self):
        """The held experts whose weights the products read: those with a
        row on the grouped routes (a device sum at decode), every one at
        C = T or under a capacity."""
        if self.sizes is not None:
            return sum(n > 0 for n in self.sizes)
        return self.gate.shape[0] if self.counts is None else (self.counts > 0).sum()

    @property
    def dropped(self) -> int:
        """Held token-slots past their expert's capacity."""
        return int((self.held & ~self.kept).sum())

    def ragged_rows(self, sizes: List[int]) -> None:
        """Ragged: the held experts' counts, read on the host.  With no held
        slot, one row is kept for the combine to read (it keeps none)."""
        n = max(sum(sizes), 1)
        self.sizes, self.cap = sizes, max(sizes, default=1)
        self.token_idx, self.gate = self.token_idx[:n], self.gate[:n]


def route(router, xf, top_k: int, capacity_factor, rule: Rule = Rule(), held=None,
          ragged: bool = False, pads=None, bias=None) -> Routing:
    """xf [T,D] → the routing of its T·k token-slots and the Switch aux
    loss.  The router runs in fp32, the reference's default, which no
    caller of either package changes.  On a mesh the routing is computed
    whole on every rank (``_route_on_mesh``); ``held``, ``pads``, the
    dropless capacity (``capacity_factor=None``) and sigmoid scores are off
    a mesh only.  Dropless, ``ragged`` leaves the held experts' counts on
    the device for the caller to read; else the slots stay grouped by
    expert over the counts on the device where T·k < E, and C = T where
    T·k ≥ E (the module's doc).  ``bias`` [E]: the sigmoid rule's
    correction bias."""
    logits = matmul(xf.float(), router.float())
    if rule.scoring == "sigmoid":
        probs = torch.sigmoid(logits)                                      # [T,E]
    else:
        probs = torch.softmax(logits, dim=-1)
    if _is_dtensor(probs):
        if held is not None or capacity_factor is None or pads is not None \
                or rule.scoring != "softmax":
            raise ValueError("an MoE layer holding a share of the experts, dropless, "
                             "leaving pads unrouted or scoring by sigmoid runs off a mesh "
                             "only: the exchange between chips is not built")
        return _route_on_mesh(probs, top_k, capacity_factor, rule)
    T, E = probs.shape
    if capacity_factor is not None:
        cap = capacity(T, top_k, E, capacity_factor)
    else:
        # one layer's expert products on an H100 (PERF.md §6): at T·k < E
        # the grouped route reads 30% of Nemotron's experts and 19% of
        # DeepSeek-V2's held 20, 0.32 against 0.84 ms and 0.11 against 0.32
        # ms; at DeepSeek-V2's T 64 (T·k = 2.4 E) it reads 87% of them and
        # is no faster, 0.356 against 0.355 ms, so C = T from T·k = E on
        cap = None if ragged or T * top_k < E else T
    return Routing(*_route_probs(probs, top_k, cap, held, rule, pads, bias))


def _top_k(probs, top_k: int, rule: Rule = Rule(), bias=None):
    """probs [T,E] → (top_p, top_e) [T,k], greedy over every expert or,
    with ``rule.n_group``, over the ``topk_group`` best groups; sigmoid
    scores are chosen by probs + ``bias`` and weighted by probs (see the
    module's doc)."""
    if rule.scoring == "sigmoid":
        choice = probs if bias is None else probs + bias.float()
        top_e = torch.sort(choice, dim=-1, descending=True, stable=True)[1][:, :top_k]
        top_p = probs.gather(1, top_e)
        if rule.norm_topk_prob:
            top_p = top_p / (top_p.sum(-1, keepdim=True) + 1e-20)
        return top_p * rule.routed_scaling_factor, top_e
    scores = probs
    n_group, topk_group = rule.n_group, rule.topk_group
    if n_group:
        T, E = probs.shape
        groups = probs.reshape(T, n_group, E // n_group).amax(-1)          # [T,G]
        best = torch.sort(groups, dim=-1, descending=True, stable=True)[1][:, :topk_group]
        keep = torch.zeros_like(groups, dtype=torch.bool).scatter_(1, best, True)
        scores = probs.masked_fill(~keep.repeat_interleave(E // n_group, dim=1), 0.0)
    top_p, top_e = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :top_k], top_e[:, :top_k]              # ties: lower index
    if rule.norm_topk_prob:
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    if rule.routed_scaling_factor != 1.0:
        top_p = top_p * rule.routed_scaling_factor
    return top_p, top_e


def _route_probs(probs, top_k: int, cap, held=None, rule: Rule = Rule(), pads=None,
                 bias=None):
    """The integer work of the routing, from probs [T,E] → (top_e, kept,
    where, token_idx, gate, aux_loss, held slots, cap, counts): ``Routing``'s
    fields.  ``held`` (first, count) gives the experts held here, all by
    default; ``pads`` [T] the tokens that take no slot; ``cap`` None is
    dropless over each expert's own rows; ``bias``: ``_top_k``'s."""
    T, E = probs.shape
    top_p, top_e = _top_k(probs, top_k, rule, bias)

    # load-balancing auxiliary loss (Switch): E * sum_e f_e * p_e
    TK = T * top_k
    flat_e = top_e.reshape(TK)
    counts = torch.zeros(E, dtype=flat_e.dtype, device=probs.device).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    aux_loss = E * torch.sum(probs.mean(0) * (counts.float() / TK))

    # the held experts' slots sort first, by expert; the others, and the
    # pads', into one last bucket, n, which keeps no slot
    first, n = held if held is not None else (0, E)
    local = flat_e - first if first else flat_e
    mine = (local >= 0) & (local < n)
    bucketed = held is not None or pads is not None
    if pads is not None:
        mine = mine & ~pads.repeat_interleave(top_k)
    key = torch.where(mine, local, n) if bucketed else local
    if bucketed:
        counts = torch.zeros(n + 1, dtype=flat_e.dtype, device=probs.device).index_add_(
            0, key, torch.ones_like(key))[:n]
    sort_idx = torch.argsort(key, stable=True)                     # [TK]
    rank = torch.empty_like(sort_idx)
    rank[sort_idx] = torch.arange(TK, device=probs.device)
    mine_tk = mine.reshape(T, top_k)
    if cap is None:
        # the held slots sort first, by expert; a slot's row is its rank
        where = torch.where(mine, rank, 0).reshape(T, top_k)
        return (top_e, mine_tk, where, sort_idx // top_k, top_p.reshape(TK)[sort_idx],
                aux_loss, mine_tk, 0, counts)
    offsets = torch.cumsum(counts, 0) - counts
    if bucketed:
        offsets = torch.cat([offsets, counts.sum()[None]])
    within = rank - offsets[key]                                   # slot's place in its expert
    kept = within < cap
    if bucketed:
        kept = kept & mine
        key = key.clamp(max=n - 1)
    where = key * cap + torch.clamp(within, max=cap - 1)

    col = torch.arange(cap, device=probs.device)
    slot = torch.clamp(offsets[:n, None] + col[None, :], max=TK - 1)   # [n,C]
    valid = col[None, :] < counts[:, None]
    token_slot = sort_idx[slot]
    gate = top_p.reshape(TK)[token_slot] * valid
    return (top_e, kept.reshape(T, top_k), where.reshape(T, top_k), token_slot // top_k,
            gate, aux_loss, mine_tk, cap, None)


def _route_on_mesh(probs, top_k: int, capacity_factor: float, rule: Rule) -> Routing:
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
    outs = _mesh.run(lambda p: _route_probs(p, top_k, cap, rule=rule)[:7], (probs,), (whole,),
                     (whole,) * 7, mesh)
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
    D = out_e.shape[-1]
    k = where.shape[1]

    def add(rows, idx, keep):
        # a select, not a product: a row no slot keeps may be unwritten, and 0 × NaN is NaN
        contrib = torch.where(keep[..., None], rows.reshape(-1, D)[idx], 0.0)   # [T,k,D]
        out = contrib[:, 0]
        for j in range(1, k):
            out = out + contrib[:, j]
        return out

    if not _is_dtensor(out_e):
        return add(out_e, where, kept)
    from torch.distributed.tensor import Partial, Replicate, Shard

    C = out_e.shape[1]
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


def _batched_experts(p: MoE, xf, token_idx, experts):
    """Each held expert's SwiGLU (or relu²) over its C rows of xf [T,D]
    at ``token_idx`` [E,C] → [E,C,D]: three (two) batched matmuls over
    every held expert's weights.  ``experts``: ``_dispatch``'s."""
    dt = xf.dtype
    expert_in = lsc(_dispatch(xf, token_idx, experts), "experts", None, None)
    u = einsum("ecd,edf->ecf", expert_in, p.wu.to(dt))
    if p.wg is None:
        h = lsc(torch.square(F.relu(u)), "experts", None, "ffn")
    else:
        g = einsum("ecd,edf->ecf", expert_in, p.wg.to(dt))
        h = lsc(F.silu(g) * u, "experts", None, "ffn")
    return einsum("ecf,efd->ecd", h, p.wd.to(dt))


def _read_behind(counts, work):
    """counts (int64, on the device) → (its list on the host, ``work()``).
    On a card the copy is queued before ``work``'s kernels and the host
    waits for the copy alone, so the device computes ``work`` while the
    host reads the counts and launches what they size."""
    if counts.device.type != "cuda":
        return counts.tolist(), work()
    host = torch.empty(counts.shape, dtype=counts.dtype, pin_memory=True)
    host.copy_(counts, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record()
    out = work()
    copied.synchronize()
    return host.tolist(), out


def _ragged_experts(p: MoE, xs, sizes, counts):
    """The prefill's ``_grouped_experts`` over xs [N,D] whose runs'
    ``sizes`` were read on the host: one zero row where N = 0, for the
    combine to read."""
    if not sum(sizes):
        return xs.new_zeros(1, xs.shape[-1])
    return _grouped_experts(p, xs, counts)


def _grouped_experts(p: MoE, xs, counts):
    """Each held expert's SwiGLU (or relu²) over its own rows of xs [N,D],
    which come first in runs of ``counts`` by expert (int64 on xs's device)
    → [N,D]: one grouped GEMM a projection over every expert's run
    (``torch._grouped_mm``, the runs' ends from ``counts``), so the host
    launches a few kernels a layer whatever the number of experts, and an
    expert with no row has an empty problem, none of its weights read.
    Rows past the last run are not written."""
    offs = torch.cumsum(counts, 0).to(torch.int32)
    dt = xs.dtype

    def mm(x, w):
        return torch._grouped_mm(x, w.to(dt), offs=offs)

    if p.wg is None:
        return mm(torch.square(F.relu(mm(xs, p.wu))), p.wd)
    return mm(F.silu(mm(xs, p.wg)) * mm(xs, p.wu), p.wd)


def moe_forward(p: MoE, x, top_k: int, capacity_factor=1.25, counts=None,
                rule: Rule = Rule(), ragged: bool = False, pads=None):
    """x [B,S,D] → (out [B,S,D], aux_loss).  ``ragged`` and ``pads`` [B,S]:
    ``route``'s; ``counts``: see the module's doc."""
    B, S, D = x.shape
    dt = x.dtype
    xf = x.reshape(B * S, D)
    flat_pads = None if pads is None else pads.reshape(B * S)
    r = route(p.router, xf, top_k, capacity_factor, rule, held=p.held, ragged=ragged,
              pads=flat_pads, bias=p.e_score_correction_bias)
    experts = p.wu.placements if _is_dtensor(p.wu) else ()
    shared = None
    if r.counts is None:
        out_e = _batched_experts(p, xf, r.token_idx, experts)
    elif ragged:
        sizes, shared = _read_behind(
            r.counts, lambda: None if p.shared is None else mlp_forward(p.shared, x))
        r.ragged_rows(sizes)
        out_e = _ragged_experts(p, xf[r.token_idx], sizes, r.counts)
    else:
        out_e = _grouped_experts(p, xf[r.token_idx], r.counts)
    out_e = out_e * r.gate[..., None].to(dt)
    # each token's k contributions in the order of its choices; a dropped
    # slot, or one whose expert is held elsewhere, adds 0
    out = lsc(_combine(out_e, r.where, r.kept, xf, experts).reshape(B, S, D),
              "batch", "seq", None)
    if p.shared is not None:
        out = out + (mlp_forward(p.shared, x) if shared is None else shared)
    if counts is not None:
        counts[0].add_(r.top_e.numel() if flat_pads is None
                       else (~flat_pads).sum() * top_k)
        counts[1].add_(r.held.sum())
        counts[2].add_(r.rows)
        counts[3].add_((r.held & ~r.kept).sum())
        counts[4].add_(r.experts_read)
    return out, r.aux_loss
