"""The plain fp32 reference of the mla_moe family (DeepSeek-V2), as the
configuration file states it, on one chip's share of each MoE layer.

- The embedding x = E[tokens]; then ``num_hidden_layers`` pre-norm blocks,
  x += MLA(rmsnorm(x)), x += FFN(rmsnorm(x)): layer 0's FFN a SwiGLU MLP of
  ``intermediate_size``, the others' the MoE below; the unembedding
  rmsnorm(x)·W_lm.  Every RMSNorm takes ``rms_norm_eps``.
- MLA in its expanded form over the whole sequence: c_q = rmsnorm(x·W_dq),
  q = c_q·W_uq, split into nope and rope dims; c_kv = rmsnorm(x·W_dkv),
  k_nope = c_kv·W_uk, v = c_kv·W_uv, one RoPE key x·W_kr shared by the
  heads.  The rope dims take YaRN's rotation (``rope_scaling``: the
  blended frequencies, cos and sin × mscale(factor, mscale) /
  mscale(factor, mscale_all_dim)), the dims paired (i, i + rope/2); causal
  attention of q = [q_nope, q_rope] against k = [k_nope, k_rope] with the
  softmax scale mscale(factor, mscale_all_dim)² / √(nope + rope); the
  heads' outputs through W_o.
- The MoE, as DeepSeek-V2's ``MoEGate`` and ``moe_infer`` (dropless):
  p = softmax(u·W_router) over all ``router_experts``; a group of
  router_experts / n_group consecutive experts scores its largest p; the
  top ``topk_group`` groups are kept and the other experts' p set to 0;
  the top ``num_experts_per_tok`` of what is left are the token's experts,
  their p unnormalised (``norm_topk_prob`` false) × ``routed_scaling_factor``.
  Of those, the experts held here (``experts_held_first`` and the next
  ``n_routed_experts``) each add weight · SwiGLU(u); the others add
  nothing here.  The shared experts, one SwiGLU MLP of
  ``moe_intermediate_size`` · ``n_shared_experts``, add theirs.  Ties go to
  the lower index.

Prompts are left-padded with token 0, as the serving engine pads them.
The pad positions are attended like any other and, where the file names
an ``unrouted_pad_token``, each row's leading run of that token takes no
routed expert (the shared experts still add theirs): prompts never hold
token 0, so the run is the pads exactly.  Rows are independent, so any
subset of a batch's rows may be computed together.
Each weight is upcast where it is used, so one layer's fp32 copies at a
time are alive.
"""
from __future__ import annotations

import math

import torch

from .common import F32, causal_attention, mm, product, rms_norm, swiglu


def mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def yarn_rope(x, positions, conf):
    """x [B, L, H, D] rotated at ``positions`` [L] with YaRN's frequencies
    (the reference implementation's ``DeepseekV2YarnRotaryEmbedding``)."""
    rs, theta = conf["rope_scaling"], float(conf["rope_theta"])
    D = x.shape[-1]
    half = D // 2

    def pair(turns):
        return D * math.log(rs["original_max_position_embeddings"]
                            / (turns * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(pair(rs["beta_fast"])), 0)
    high = min(math.ceil(pair(rs["beta_slow"])), D - 1)
    exps = torch.arange(0, D, 2, dtype=F32, device=x.device) / D
    extra = 1.0 / theta ** exps
    inter = 1.0 / (rs["factor"] * theta ** exps)
    ramp = ((torch.arange(half, dtype=F32, device=x.device) - low)
            / (high - low if high > low else 0.001)).clamp(0, 1)
    freqs = inter * ramp + extra * (1 - ramp)
    ang = positions.to(F32)[:, None] * freqs
    f = mscale(rs["factor"], rs["mscale"]) / mscale(rs["factor"], rs["mscale_all_dim"])
    cos, sin = (ang.cos() * f)[None, :, None, :], (ang.sin() * f)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def mla(w, p: str, u, conf, prec):
    eps = conf["rms_norm_eps"]
    b, L, _ = u.shape
    nope = conf["qk_nope_head_dim"]
    pos = torch.arange(L, device=u.device)
    cq = rms_norm(mm(u, w[p + "wdq"], prec), w[p + "q_norm.w"], eps)
    q = product("blq,qhk->blhk", cq, w[p + "wuq"], prec, "q", "q")
    ckv = rms_norm(mm(u, w[p + "wdkv"], prec), w[p + "kv_norm.w"], eps)
    kn = product("blc,chk->blhk", ckv, w[p + "wuk"], prec, "c", "c")
    v = product("blc,chk->blhk", ckv, w[p + "wuv"], prec, "c", "c")
    kr = yarn_rope(mm(u, w[p + "wkr"], prec)[:, :, None, :], pos, conf)
    H = kn.shape[2]
    q = torch.cat([q[..., :nope], yarn_rope(q[..., nope:], pos, conf)], -1)
    k = torch.cat([kn, kr.expand(b, L, H, kr.shape[-1])], -1)
    del kn, kr
    rs = conf["rope_scaling"]
    # causal_attention divides by √(nope + rope); q carries mscale²
    q.mul_(mscale(rs["factor"], rs["mscale_all_dim"]) ** 2)
    a = causal_attention(q, k, v, prec)
    del q, k, v
    wo = w[p + "wo"]
    return mm(a.reshape(b, L, -1), wo.reshape(-1, wo.shape[-1]), prec)


def route(probs, conf):
    """probs [N, E] → (weights, experts) [N, k] of the published rule."""
    N, E = probs.shape
    G, kg, k = conf["n_group"], conf["topk_group"], conf["num_experts_per_tok"]
    groups = probs.reshape(N, G, E // G).amax(-1)
    best = torch.sort(groups, dim=-1, descending=True, stable=True)[1][:, :kg]
    keep = torch.zeros(N, G, dtype=torch.bool, device=probs.device)
    keep[torch.arange(N, device=probs.device)[:, None], best] = True
    scores = probs * keep[:, :, None].expand(N, G, E // G).reshape(N, E)
    top_p, top_e = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    if conf["norm_topk_prob"]:
        top_p = top_p / top_p.sum(-1, keepdim=True)
    return top_p * conf["routed_scaling_factor"], top_e


def moe(w, p: str, u, conf, prec, pads):
    """u [b, L, d] → the layer's output; ``pads`` [b, L] take no routed
    expert."""
    b, L, d = u.shape
    x = u.reshape(-1, d)
    probs = torch.softmax(mm(x, w[p + "router"], prec), dim=-1)
    top_p, top_e = route(probs, conf)
    top_e = top_e.masked_fill(pads.reshape(-1, 1), -1)
    out = torch.zeros_like(x)
    first = conf["experts_held_first"]
    for j in range(conf["n_routed_experts"]):
        rows, slot = (top_e == first + j).nonzero(as_tuple=True)
        if rows.numel():
            y = swiglu(x[rows], w[p + "wg"][j], w[p + "wu"][j], w[p + "wd"][j], prec)
            out.index_add_(0, rows, y * top_p[rows, slot][:, None])
    out = out + swiglu(x, w[p + "shared.wg"], w[p + "shared.wu"], w[p + "shared.wd"], prec)
    return out.reshape(b, L, d)


@torch.no_grad()
def logits(w, conf, tokens, S: int, out_positions, prec: str = "fp32"):
    """tokens [b, L] (int; the first S positions the padded prompts) → fp32
    logits [b, len(out_positions), V] at ``out_positions``, each predicting
    the token after it.  Rows are independent, so S is not needed."""
    eps = conf["rms_norm_eps"]
    pad = conf.get("unrouted_pad_token")
    pads = (torch.zeros_like(tokens, dtype=torch.bool) if pad is None
            else (tokens == pad).long().cumprod(-1).bool())
    x = w["embed"][tokens].to(F32)
    for i in range(conf["num_hidden_layers"]):
        p = "layer0." if i == 0 else f"layers.{i - 1}."
        x = x + mla(w, p + "attn.", rms_norm(x, w[p + "ln1.w"], eps), conf, prec)
        u = rms_norm(x, w[p + "ln2.w"], eps)
        if i == 0:
            x = x + swiglu(u, w[p + "mlp.wg"], w[p + "mlp.wu"], w[p + "mlp.wd"], prec)
        else:
            x = x + moe(w, p + "moe.", u, conf, prec, pads)
        del u
    x = rms_norm(x[:, out_positions], w["final_norm.w"], eps)
    return mm(x, w["lm_head"], prec)
