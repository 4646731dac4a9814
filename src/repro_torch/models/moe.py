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
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .common import make_param
from .layers import MLP, lsc, mlp_forward


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
    cap: int
    aux_loss: torch.Tensor

    @property
    def dropped(self) -> int:
        """Token-slots past their expert's capacity."""
        return int((~self.kept).sum())


def route(router, xf, top_k: int, capacity_factor: float) -> Routing:
    """xf [T,D] → the routing of its T·k token-slots and the Switch aux
    loss.  The router runs in fp32, the reference's default, which no
    caller of either package changes."""
    T = xf.shape[0]
    E = router.shape[-1]
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)    # [T,E]
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :top_k], top_e[:, :top_k]              # ties: lower index
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # load-balancing auxiliary loss (Switch): E * sum_e f_e * p_e
    counts = torch.bincount(top_e.reshape(-1), minlength=E)
    aux_loss = E * torch.sum(probs.mean(0) * (counts.float() / (T * top_k)))

    TK = T * top_k
    cap = capacity(T, top_k, E, capacity_factor)
    flat_e = top_e.reshape(TK)
    sort_idx = torch.argsort(flat_e, stable=True)                  # [TK]
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(sort_idx)
    rank[sort_idx] = torch.arange(TK, device=xf.device)
    within = rank - offsets[flat_e]                                # slot's place in its expert
    kept = within < cap
    where = flat_e * cap + torch.clamp(within, max=cap - 1)

    col = torch.arange(cap, device=xf.device)
    slot = torch.clamp(offsets[:, None] + col[None, :], max=TK - 1)   # [E,C]
    valid = col[None, :] < counts[:, None]
    token_slot = sort_idx[slot]
    gate = top_p.reshape(TK)[token_slot] * valid
    return Routing(top_e, kept.reshape(T, top_k), where.reshape(T, top_k),
                   token_slot // top_k, gate, cap, aux_loss)


def moe_forward(p: MoE, x, top_k: int, capacity_factor: float = 1.25):
    """x [B,S,D] → (out [B,S,D], aux_loss)."""
    B, S, D = x.shape
    dt = x.dtype
    xf = x.reshape(B * S, D)
    r = route(p.router, xf, top_k, capacity_factor)
    E, C = r.token_idx.shape
    expert_in = lsc(xf[r.token_idx.reshape(-1)].reshape(E, C, D), "experts", None, None)
    g = torch.einsum("ecd,edf->ecf", expert_in, p.wg.to(dt))
    u = torch.einsum("ecd,edf->ecf", expert_in, p.wu.to(dt))
    h = lsc(F.silu(g) * u, "experts", None, "ffn")
    out_e = torch.einsum("ecf,efd->ecd", h, p.wd.to(dt))
    out_e = (out_e * r.gate[..., None].to(dt)).reshape(E * C, D)
    # each token's k contributions in the order of its choices; a dropped
    # slot adds 0
    contrib = out_e[r.where] * r.kept[..., None].to(out_e.dtype)   # [T,k,D]
    out = contrib[:, 0]
    for j in range(1, top_k):
        out = out + contrib[:, j]
    out = lsc(out.reshape(B, S, D), "batch", "seq", None)
    if p.shared is not None:
        out = out + mlp_forward(p.shared, x)
    return out, r.aux_loss
