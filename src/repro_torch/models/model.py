"""Decoder LM: config → init / forward / prefill / decode, family ``dense``.

``ModelConfig`` keeps every field of the JAX package's, with torch dtypes in
place of jnp ones.  ``Model`` is an ``nn.Module`` for the llama-style GQA
transformer (granite-20b, deepseek-67b, yi-9b, llama3.2-3b).  The reference
scans its layers over params stacked on axis 0; here that axis is split into
a ``ModuleList``, so ``layers.{i}.attn.wq`` is the reference's
``layers/attn/wq[i]`` (``models.convert.params_from_jax``).  Other families
raise ``NotImplementedError`` (ROADMAP.md, open item 1, steps 1-2).

Weights are drawn on ``device`` from a ``torch.Generator`` seeded with
``seed``; they are bf16 whatever ``cfg.dtype`` is, as in the reference.
``prefill`` and ``decode`` run without autograd; the KV cache is a dict of
stacked [L,B,T,Hkv,hd] tensors that ``decode`` updates in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from . import layers as L
from .common import make_param


@dataclasses.dataclass
class ModelConfig:
    arch: str
    family: str                    # dense|moe|mla_moe|hybrid|xlstm|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    moe_layer_start: int = 0       # layers < start use the dense FFN
    # MLA
    q_lora: int = 0
    kv_lora: int = 0
    nope_head_dim: int = 128
    rope_head_dim: int = 64
    v_head_dim: int = 128
    # SSM / hybrid
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssd_decay_dtype: Any = torch.float32
    attn_every: int = 0            # zamba2: shared attn block cadence
    # xLSTM
    slstm_every: int = 0           # 0 = no sLSTM layers; else layers i%k==1
    mlstm_chunk: int = 128
    # VLM
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    n_patches: int = 0
    # audio
    codebooks: int = 0
    # compute knobs (the JAX package's hillclimb levers; the CPU attention
    # path reads q_chunk/kv_chunk, the rest are kept for config parity)
    scan_layers: bool = True
    remat: bool = True
    remat_policy: str = "full"     # full | dots | none
    q_chunk: int = 2048
    kv_chunk: int = 2048
    unroll_attention: bool = False
    dtype: Any = torch.bfloat16
    seq_shard_activations: bool = True

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.d_model // self.n_heads
        if self.d_ff_expert == 0 and self.n_experts:
            self.d_ff_expert = self.d_ff

    @property
    def supports_long_context(self) -> bool:
        return self.family in ("hybrid", "xlstm")

    def param_count(self) -> int:
        """Parameter count from the shapes ``Model`` builds (dense only)."""
        _require_dense(self)
        d, hd = self.d_model, self.head_dim
        per_layer = (2 * d                                   # ln1, ln2
                     + d * self.n_heads * hd * 2             # wq, wo
                     + d * self.n_kv_heads * hd * 2          # wk, wv
                     + 3 * d * self.d_ff)                    # wg, wu, wd
        return 2 * self.vocab * d + d + self.n_layers * per_layer


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.arch}) is not ported yet; "
            "the port runs 'dense' (ROADMAP.md, open item 1, steps 1-2)")


class DenseLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, device)
        self.attn = L.GQA(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, device)
        self.ln2 = L.RMSNorm(cfg.d_model, device)
        self.mlp = L.MLP(gen, cfg.d_model, cfg.d_ff, device)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0):
        super().__init__()
        _require_dense(cfg)
        self.cfg = cfg
        gen = torch.Generator(device=device).manual_seed(seed)
        d = cfg.d_model
        self.embed = make_param(gen, (cfg.vocab, d), 0.02, device=device)
        self.lm_head = make_param(gen, (d, cfg.vocab), d ** -0.5, device=device)
        self.final_norm = L.RMSNorm(d, device)
        self.layers = nn.ModuleList(DenseLayer(cfg, gen, device)
                                    for _ in range(cfg.n_layers))

    # ------------------------------------------------------------- helpers ----
    def _embed(self, tokens):
        return self.embed[tokens].to(self.cfg.dtype)

    def _rope(self, positions):
        return L.rope_angles(positions, self.cfg.head_dim, self.cfg.rope_theta)

    def _unembed(self, x):
        x = self.final_norm(x)
        logits = torch.einsum("bsd,dv->bsv", x, self.lm_head.to(x.dtype))
        return logits.float()

    def _block(self, lp: DenseLayer, x, cos, sin):
        cfg = self.cfg
        h, kv = L.gqa_forward(lp.attn, lp.ln1(x), cos, sin, q_chunk=cfg.q_chunk,
                              kv_chunk=cfg.kv_chunk)
        x = x + h
        x = x + L.mlp_forward(lp.mlp, lp.ln2(x))
        return x, kv

    # ------------------------------------------------------------ forward ----
    def forward(self, batch: Dict[str, torch.Tensor]):
        """Full-sequence forward → (logits [B,S,V] fp32, aux loss 0)."""
        tokens = batch["tokens"]
        x = self._embed(tokens)
        cos, sin = self._rope(torch.arange(tokens.shape[1], device=tokens.device))
        for lp in self.layers:
            x, _ = self._block(lp, x, cos, sin)
        return self._unembed(x), torch.zeros((), device=tokens.device)

    # ------------------------------------------------------- prefill/decode ----
    def init_cache(self, batch_size: int, max_len: int) -> Dict[str, Any]:
        cfg = self.cfg
        kv = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.head_dim)
        dev = self.embed.device
        return {"k": torch.zeros(kv, dtype=cfg.dtype, device=dev),
                "v": torch.zeros(kv, dtype=cfg.dtype, device=dev),
                "pos": 0}

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], max_len: Optional[int] = None):
        """Forward over the prompt → (last-position logits [B,V] fp32, cache
        holding the prompt's K/V at positions [0, S))."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        cache = self.init_cache(B, max_len or S)
        x = self._embed(tokens)
        cos, sin = self._rope(torch.arange(S, device=tokens.device))
        for i, lp in enumerate(self.layers):
            x, (k, v) = self._block(lp, x, cos, sin)
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
        cache["pos"] = S
        # the last position alone goes through the head: the reference
        # computes every position's logits and keeps the last
        return self._unembed(x[:, -1:])[:, -1], cache

    @torch.no_grad()
    def decode(self, cache: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        """One decode step: batch['tokens'] [B,1] → (logits [B,V] fp32, cache
        with ``pos`` advanced).  The cache's K/V tensors are updated in place."""
        pos = cache["pos"]
        tokens = batch["tokens"]
        B = tokens.shape[0]
        x = self._embed(tokens)
        cos, sin = self._rope(torch.full((B, 1), pos, device=tokens.device))
        for i, lp in enumerate(self.layers):
            h, _, _ = L.gqa_decode(lp.attn, lp.ln1(x), cache["k"][i], cache["v"][i],
                                   pos, cos, sin)
            x = x + h
            x = x + L.mlp_forward(lp.mlp, lp.ln2(x))
        return self._unembed(x)[:, -1], {**cache, "pos": pos + 1}
