"""The plain fp32 reference of the nemotron_h family (Nemotron 3 Nano), as
the configuration file states it (``modeling_nemotron_h.py``'s forward).

- The embedding x = E[tokens]; then one block a character of
  ``hybrid_override_pattern``, x += mixer(rmsnorm(x)), and no FFN beside
  the mixer; the unembedding rmsnorm(x)·W_lm.  Every RMSNorm takes
  ``layer_norm_epsilon``.
- M, Mamba2 (``NemotronHMamba2Mixer``): z = u·W_z; [x, B, C] = [u·W_x, u·W_B,
  u·W_C] through one causal depthwise conv of width ``conv_kernel`` with
  bias and SiLU; B and C are ``n_groups`` groups of ``ssm_state_size``,
  head h reading group h // (H/G); dt = softplus(u·W_dt + dt_bias),
  a = -exp(a_log); the scan h_t = exp(a·dt_t)·h_{t-1} + dt_t·B_t⊗x_t,
  y_t = C_t·h_t + D·x_t over ``mamba_num_heads`` heads of ``mamba_head_dim``;
  then the gate before the norm (``MambaRMSNormGated``, norm_before_gate
  false): g = y·SiLU(z), an RMSNorm over each group of H·P/G channels, times
  its weight; g·W_o.
- E, the MoE (``NemotronHMOE``, its router ``NemotronHTopkRouter``, the
  ``noaux_tc`` rule): s = sigmoid(u·W_router); the top
  ``num_experts_per_tok`` of s + ``e_score_correction_bias`` (``n_group``
  1: one group) are the token's experts, weighted by their s alone,
  normalised (``norm_topk_prob``, + 1e-20) and × ``routed_scaling_factor``;
  each adds weight · down(relu(up·u)²), computed on its routed rows only;
  the shared expert, down(relu(up·u)²) of
  ``moe_shared_expert_intermediate_size``, adds its own.  Ties go to the
  lower index.
- *, attention (``NemotronHAttention``): q, k, v = u·W_q, u·W_k, u·W_v with
  ``num_attention_heads`` query heads and ``num_key_value_heads`` K/V heads
  (query head h reads K/V head h // (H/H_kv)) of ``head_dim``, no position
  embedding, causal softmax(q·kᵀ/√head_dim)·v, then W_o.

Prompts are left-padded with token 0, as the serving engine pads them.
The pad positions are attended and scanned like any other and, where the
file names an ``unrouted_pad_token``, each row's leading run of that token
takes no routed expert (the shared expert still adds its own): prompts
never hold token 0, so the run is the pads exactly.  The scan is exact in
fp32, chunk by chunk.  Rows are independent, so any subset of a batch's
rows may be computed together.  Each weight is upcast where it is used, so
one layer's fp32 copies at a time are alive, an expert's alone in the MoE.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import F32, causal_attention, mm, product, rms_norm


def ssd(x, dt, Bm, Cm, a, chunk: int = 64):
    """y of the scan, without the skip: x [b, L, H, P], dt [b, L, H], Bm and
    Cm [b, L, N] shared by the H heads, a [H], all fp32; exact in fp32 chunk
    by chunk (the decay masked before its exp)."""
    b, L, H, P = x.shape
    N = Bm.shape[-1]
    h = torch.zeros(b, H, N, P, dtype=F32, device=x.device)
    ys = []
    for c0 in range(0, L, chunk):
        xs, dts = x[:, c0:c0 + chunk], dt[:, c0:c0 + chunk]
        Bs, Cs = Bm[:, c0:c0 + chunk], Cm[:, c0:c0 + chunk]
        q = xs.shape[1]
        la = torch.cumsum(dts * a, dim=1)                               # [b, q, H]
        tril = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
        seg = (la[:, :, None, :] - la[:, None, :, :]).masked_fill(
            ~tril[None, :, :, None], float("-inf"))
        M = torch.einsum("bin,bjn->bij", Cs, Bs)[..., None] * seg.exp() * dts[:, None]
        y = torch.einsum("bijh,bjhp->bihp", M, xs)
        y = y + la.exp()[..., None] * torch.einsum("bin,bhnp->bihp", Cs, h)
        wts = (la[:, -1:] - la).exp() * dts                              # [b, q, H]
        h = la[:, -1].exp()[..., None, None] * h + torch.einsum(
            "bjh,bjn,bjhp->bhnp", wts, Bs, xs)
        ys.append(y)
    return torch.cat(ys, dim=1)


def mamba2(w, p: str, u, conf, prec):
    b, L, _ = u.shape
    H, P = conf["mamba_num_heads"], conf["mamba_head_dim"]
    G, N = conf["n_groups"], conf["ssm_state_size"]
    Di, W = H * P, conf["conv_kernel"]
    z = mm(u, w[p + "wz"], prec)
    raw = torch.cat([mm(u, w[p + "wx"], prec), mm(u, w[p + "wB"], prec),
                     mm(u, w[p + "wC"], prec)], dim=-1)                   # [b, L, Di + 2GN]
    xp = F.pad(raw, (0, 0, W - 1, 0))
    cw = w[p + "conv_w"].to(F32)
    conv = F.silu(sum(xp[:, i:i + L] * cw[i] for i in range(W)) + w[p + "conv_b"].to(F32))
    xb, Bm, Cm = conv.split([Di, G * N, G * N], dim=-1)
    dt = F.softplus(mm(u, w[p + "wdt"], prec) + w[p + "dt_bias"].to(F32))
    a = -torch.exp(w[p + "a_log"].to(F32))
    xh = xb.reshape(b, L, H, P)
    Bm, Cm = Bm.reshape(b, L, G, N), Cm.reshape(b, L, G, N)
    hg = H // G
    y = torch.cat([ssd(xh[:, :, g * hg:(g + 1) * hg], dt[:, :, g * hg:(g + 1) * hg],
                       Bm[:, :, g], Cm[:, :, g], a[g * hg:(g + 1) * hg]) for g in range(G)],
                  dim=2)
    y = y + xh * w[p + "d_skip"].to(F32)[None, None, :, None]
    g = (y.reshape(b, L, Di) * F.silu(z)).reshape(b, L, G, Di // G)
    g = g * torch.rsqrt((g * g).mean(-1, keepdim=True) + conf["layer_norm_epsilon"])
    return mm(g.reshape(b, L, Di) * w[p + "out_norm.w"].to(F32), w[p + "wo"], prec)


def route(s, bias, conf):
    """Sigmoid scores s [T, E] → (weights, experts) [T, k] of the published
    rule: chosen by s + bias, weighted by s."""
    k = conf["num_experts_per_tok"]
    top_e = torch.sort(s + bias, dim=-1, descending=True, stable=True)[1][:, :k]
    top_w = s.gather(1, top_e)
    if conf["norm_topk_prob"]:
        top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20)
    return top_w * conf["routed_scaling_factor"], top_e


def relu2(x, wu, wd, prec):
    return mm(torch.square(F.relu(mm(x, wu, prec))), wd, prec)


def moe(w, p: str, u, conf, prec, pads):
    """u [b, L, d] → the layer's output; ``pads`` [b, L] take no routed
    expert."""
    b, L, d = u.shape
    x = u.reshape(-1, d)
    s = torch.sigmoid(mm(x, w[p + "router"], prec))
    top_w, top_e = route(s, w[p + "e_score_correction_bias"].to(F32), conf)
    top_e = top_e.masked_fill(pads.reshape(-1, 1), -1)
    out = torch.zeros_like(x)
    for e in range(conf["n_routed_experts"]):
        rows, slot = (top_e == e).nonzero(as_tuple=True)
        if rows.numel():
            y = relu2(x[rows], w[p + "wu"][e], w[p + "wd"][e], prec)
            out.index_add_(0, rows, y * top_w[rows, slot][:, None])
    out = out + relu2(x, w[p + "shared.wu"], w[p + "shared.wd"], prec)
    return out.reshape(b, L, d)


def attention(w, p: str, u, conf, prec):
    b, L, _ = u.shape
    rep = conf["num_attention_heads"] // conf["num_key_value_heads"]
    q, k, v = (product("bld,dhk->blhk", u, w[p + n], prec, "d", "d")
               for n in ("wq", "wk", "wv"))
    a = causal_attention(q, k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2),
                         prec)
    wo = w[p + "wo"]
    return mm(a.reshape(b, L, -1), wo.reshape(-1, wo.shape[-1]), prec)


@torch.no_grad()
def logits(w, conf, tokens, S: int, out_positions, prec: str = "fp32"):
    """tokens [b, L] (int; the first S positions the padded prompts) → fp32
    logits [b, len(out_positions), V] at ``out_positions``, each predicting
    the token after it.  Rows are independent, so S is not needed."""
    eps = conf["layer_norm_epsilon"]
    pad = conf.get("unrouted_pad_token")
    pads = (torch.zeros_like(tokens, dtype=torch.bool) if pad is None
            else (tokens == pad).long().cumprod(-1).bool())
    mixers = {"M": ("mamba.", mamba2), "*": ("attn.", attention)}
    x = w["embed"][tokens].to(F32)
    for i, kind in enumerate(conf["hybrid_override_pattern"]):
        p = f"layers.{i}."
        u = rms_norm(x, w[p + "norm.w"], eps)
        if kind == "E":
            x = x + moe(w, p + "moe.", u, conf, prec, pads)
        else:
            name, mixer = mixers[kind]
            x = x + mixer(w, p + name, u, conf, prec)
        del u
    x = rms_norm(x[:, out_positions], w["final_norm.w"], eps)
    return mm(x, w["lm_head"], prec)
