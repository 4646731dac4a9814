"""The plain fp32 reference of the hybrid family (zamba2), as the
configuration file states it: Zamba2's Mamba2 backbone and the port's form
of its shared block, whose departures from Zyphra's the file lists.

- The embedding x0 = E[tokens].
- Before every ``shared_block_every``-th Mamba2 layer (layers 0, 6,
  12, …) one attention block, its weights shared by every site, reads
  s = [x, x0] · P_site (a [2d, d] projection per site) and adds its whole
  output to x: x += s + a + f, where a = attention(rmsnorm(s)) (causal,
  RoPE on q and k, ``num_attention_heads`` heads of ``shared_block_head_dim``)
  and f = SwiGLU(rmsnorm(s + a)).
- Each Mamba2 layer: u = rmsnorm(x); z = u·Wz; the x branch u·Wx through a
  causal depthwise conv of width 4 and SiLU; B = u·W_B, C = u·W_C (one
  group, shared by the heads); dt = softplus(u·W_dt + dt_bias);
  a = -exp(a_log); the scan h_t = exp(a·dt_t)·h_{t-1} + dt_t·B_t⊗x_t,
  y_t = C_t·h_t + d_skip·x_t; then rmsnorm(y)·SiLU(z)·W_o added to x.
- The unembedding: rmsnorm(x)·W_lm.

Prompts are left-padded with token 0, and the pad positions are attended
and scanned like any other, as the serving engine does.  The scan is
exact in fp32, chunk by chunk.  Rows are independent, so any subset of a
batch's rows may be computed together.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import F32, causal_attention, mm, product, rms_norm, rope, swiglu


def ssd(x, dt, Bm, Cm, a, chunk: int = 64):
    """y of the scan above, without the skip: x [b, L, H, P], dt [b, L, H],
    Bm and Cm [b, L, N], a [H], all fp32."""
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


def _conv(raw, w, bias):
    """Causal depthwise conv: raw [b, L, Di], w [W, Di]."""
    W = w.shape[0]
    xp = F.pad(raw, (0, 0, W - 1, 0))
    return sum(xp[:, i:i + raw.shape[1]] * w[i].to(F32) for i in range(W)) + bias.to(F32)


def mamba2(w, p: str, u, conf, prec):
    b, L, _ = u.shape
    P = conf["mamba_headdim"]
    z = mm(u, w[p + "wz"], prec)
    xb = F.silu(_conv(mm(u, w[p + "wx"], prec), w[p + "conv_w"], w[p + "conv_b"]))
    Bm, Cm = mm(u, w[p + "wB"], prec), mm(u, w[p + "wC"], prec)
    dt = F.softplus(mm(u, w[p + "wdt"], prec) + w[p + "dt_bias"].to(F32))
    a = -torch.exp(w[p + "a_log"].to(F32))
    xh = xb.reshape(b, L, -1, P)
    y = ssd(xh, dt, Bm, Cm, a) + xh * w[p + "d_skip"].to(F32)[None, None, :, None]
    y = rms_norm(y.reshape(b, L, -1), w[p + "out_norm.w"], conf["rms_norm_eps"]) * F.silu(z)
    return mm(y, w[p + "wo"], prec)


def attention_block(w, p: str, s, conf, prec):
    """s + a + f of the shared block (see the module's docstring)."""
    eps, theta = conf["rms_norm_eps"], float(conf["rope_theta"])
    b, L, d = s.shape
    u = rms_norm(s, w[p + "ln1.w"], eps)
    pos = torch.arange(L, device=s.device)
    q, k, v = (product("bld,dhk->blhk", u, w[p + f"attn.{n}"], prec, "d", "d")
               for n in ("wq", "wk", "wv"))
    a = causal_attention(rope(q, pos, theta), rope(k, pos, theta), v, prec)
    wo = w[p + "attn.wo"]
    h = s + mm(a.reshape(b, L, -1), wo.reshape(-1, wo.shape[-1]), prec)
    u = rms_norm(h, w[p + "ln2.w"], eps)
    return h + swiglu(u, w[p + "mlp.wg"], w[p + "mlp.wu"], w[p + "mlp.wd"], prec)


@torch.no_grad()
def logits(w, conf, tokens, S: int, out_positions, prec: str = "fp32"):
    """tokens [b, L] (int; the first S positions the padded prompts) → fp32
    logits [b, len(out_positions), V] at ``out_positions``, each predicting
    the token after it.  Rows are independent, so S is not needed."""
    eps = conf["rms_norm_eps"]
    every = conf["shared_block_every"]
    x0 = w["embed"][tokens].to(F32)
    x = x0
    for i in range(conf["num_hidden_layers"]):
        if i % every == 0:
            s = mm(torch.cat([x, x0], dim=-1), w[f"shared_proj.{i // every}"], prec)
            x = x + attention_block(w, "shared_attn.", s, conf, prec)
        p = f"layers.{i}."
        x = x + mamba2(w, p + "mamba.", rms_norm(x, w[p + "norm.w"], eps), conf, prec)
    x = rms_norm(x[:, out_positions], w["final_norm.w"], eps)
    return mm(x, w["lm_head"], prec)
