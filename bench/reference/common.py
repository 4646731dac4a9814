"""Plain fp32 operations shared by the references.

Every matrix product goes through ``mm`` or ``product``, which take a
precision: ``"fp32"`` (the reference: float32, TF32 off) or ``"fp8"`` (the
control: both operands rounded to float8 e4m3 with one scale per row of
the contracted dimension, the product accumulated in fp32), so one code
path computes both.  Norms, softmax, RoPE and scans stay fp32 in both.

This file imports neither JAX nor anything of the program.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32
FP8_MAX = 448.0


def fp32_only() -> None:
    """float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3, scaled per slice along ``dim`` so that each
    slice's largest magnitude maps to the format's largest, back in fp32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(F32) * scale


def mm(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """x [..., K] @ w [K, N] in fp32 (w upcast here)."""
    x, w = x.to(F32), w.to(F32)
    if prec == "fp8":
        x, w = q8(x, -1), q8(w, 0)
    return x @ w


def product(eq: str, a: torch.Tensor, b: torch.Tensor, prec: str, a_dims: str = "",
            b_dims: str = "") -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` in fp32; with ``fp8`` each operand is
    rounded per slice along its contracted dims (the letters of
    ``a_dims`` and ``b_dims``, which must be one dim each)."""
    a, b = a.to(F32), b.to(F32)
    if prec == "fp8":
        ins = eq.split("->")[0].split(",")
        a = q8(a, ins[0].index(a_dims))
        b = q8(b, ins[1].index(b_dims))
    return torch.einsum(eq, a, b)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.to(F32)
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.to(F32)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x [B, L, H, D] at ``positions`` [L]: the first and
    second halves of D rotated as pairs (i, i + D/2) by position · θ^(-i/(D/2))."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=F32, device=x.device) / half)
    ang = positions.to(F32)[:, None] * freqs                      # [L, half]
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, prec: str, heads_per_step: int = 16) -> torch.Tensor:
    """softmax(q·kᵀ / √D, causal) · v over q [B, L, H, D], k [B, L, H, D],
    v [B, L, H, Dv] → [B, L, H, Dv], a row and a few heads at a time so the
    [L, L] scores fit."""
    B, L, H, D = q.shape
    out = torch.empty(B, L, H, v.shape[-1], dtype=F32, device=q.device)
    mask = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    for b in range(B):
        for h0 in range(0, H, heads_per_step):
            hs = slice(h0, h0 + heads_per_step)
            s = product("qhd,khd->hqk", q[b, :, hs], k[b, :, hs], prec, "d", "d")
            s = (s / math.sqrt(D)).masked_fill(~mask, float("-inf"))
            p = torch.softmax(s, dim=-1)
            out[b, :, hs] = product("hqk,khd->qhd", p, v[b, :, hs], prec, "k", "k")
    return out


def swiglu(x, wg, wu, wd, prec: str) -> torch.Tensor:
    g, u = mm(x, wg, prec), mm(x, wu, prec)
    return mm(torch.nn.functional.silu(g) * u, wd, prec)
