"""Decoder LM: config → init / forward / prefill / decode, families
``dense`` and ``hybrid``.

``ModelConfig`` keeps every field of the JAX package's, with torch dtypes in
place of jnp ones.  ``Model`` is an ``nn.Module`` for the llama-style GQA
transformer (granite-20b, deepseek-67b, yi-9b, llama3.2-3b) and for zamba2's
hybrid: a Mamba2 backbone (``models.ssm``) with one weight-shared attention
block applied before every ``attn_every``-th layer to concat(x, embeddings)
through a per-site projection.  The reference scans the dense layers over
params stacked on axis 0; here that axis is split into a ``ModuleList``, so
``layers.{i}.attn.wq`` is the reference's ``layers/attn/wq[i]``, and the
hybrid's ``layers/l{i}`` and ``shared_proj/s{i}`` are ``layers.{i}`` and
``shared_proj.{i}`` (``models.convert.params_from_jax``).  Other families
raise ``NotImplementedError`` (ROADMAP.md, open item 1).

Weights are drawn on ``device`` from a ``torch.Generator`` seeded with
``seed``; they are bf16 whatever ``cfg.dtype`` is, as in the reference.
``prefill`` and ``decode`` run without autograd.  ``decode`` writes the
attention K/V into the cache's tensors in place and returns new SSM and
conv states, so a prefill cache can be decoded from more than once.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from . import layers as L
from . import ssm as SSM
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

    def shared_sites(self):
        """Layers before which the hybrid's shared attention block runs."""
        if not self.attn_every:
            return []
        return [i for i in range(self.n_layers) if i % self.attn_every == 0]

    def param_count(self) -> int:
        """Parameter count from the shapes ``Model`` builds."""
        _require_ported(self)
        d, hd = self.d_model, self.head_dim
        attn_block = (2 * d                                  # ln1, ln2
                      + d * self.n_heads * hd * 2            # wq, wo
                      + d * self.n_kv_heads * hd * 2         # wk, wv
                      + 3 * d * self.d_ff)                   # wg, wu, wd
        outer = 2 * self.vocab * d + d                       # embed, lm_head, final_norm
        if self.family == "dense":
            return outer + self.n_layers * attn_block
        di = self.ssm_expand * d
        H, N = di // self.ssm_headdim, self.ssm_state
        mamba = (d                                           # the layer's norm
                 + 3 * d * di                                # wz, wx, wo
                 + 4 * di + di + di                          # conv_w, conv_b, out_norm
                 + 2 * d * N + d * H + 3 * H)                # wB, wC, wdt, dt_bias, a_log, d_skip
        return (outer + attn_block + len(self.shared_sites()) * 2 * d * d
                + self.n_layers * mamba)


PORTED_FAMILIES = ("dense", "hybrid")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.arch}) is not ported yet; "
            f"the port runs {PORTED_FAMILIES} (ROADMAP.md, open item 1)")


class DenseLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, device)
        self.attn = L.GQA(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, device)
        self.ln2 = L.RMSNorm(cfg.d_model, device)
        self.mlp = L.MLP(gen, cfg.d_model, cfg.d_ff, device)


class MambaLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device=None):
        super().__init__()
        self.norm = L.RMSNorm(cfg.d_model, device)
        self.mamba = SSM.Mamba2(gen, cfg.d_model, cfg.ssm_expand * cfg.d_model,
                                cfg.ssm_state, cfg.ssm_headdim, device=device)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0):
        super().__init__()
        _require_ported(cfg)
        self.cfg = cfg
        gen = torch.Generator(device=device).manual_seed(seed)
        d = cfg.d_model
        self.embed = make_param(gen, (cfg.vocab, d), 0.02, device=device)
        self.lm_head = make_param(gen, (d, cfg.vocab), d ** -0.5, device=device)
        self.final_norm = L.RMSNorm(d, device)
        if cfg.family == "dense":
            self.layers = nn.ModuleList(DenseLayer(cfg, gen, device)
                                        for _ in range(cfg.n_layers))
        else:
            # zamba2: one attention block whose weights every site shares, a
            # [2d, d] projection of concat(x, embeddings) per site
            self.shared_attn = DenseLayer(cfg, gen, device)
            self.layers = nn.ModuleList(MambaLayer(cfg, gen, device)
                                        for _ in range(cfg.n_layers))
            self.shared_proj = nn.ParameterList(
                make_param(gen, (2 * d, d), (2 * d) ** -0.5, device=device)
                for _ in cfg.shared_sites())

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

    def _decode_block(self, lp: DenseLayer, x, k_cache, v_cache, pos, cos, sin):
        h, _, _ = L.gqa_decode(lp.attn, lp.ln1(x), k_cache, v_cache, pos, cos, sin)
        x = x + h
        return x + L.mlp_forward(lp.mlp, lp.ln2(x))

    def _site_input(self, site: int, x, x0):
        """Zamba2's shared block reads concat(x, embeddings) through the
        site's own projection; its output is added to x."""
        return torch.cat([x, x0], dim=-1) @ self.shared_proj[site].to(x.dtype)

    def _layers(self, x, cos, sin, cache=None):
        """Every layer over the full sequence.  With ``cache``, write the
        attention K/V at positions [0, S) and, for the hybrid, each Mamba2
        layer's final state and conv cache."""
        cfg = self.cfg
        S = x.shape[1]
        if cfg.family == "dense":
            for i, lp in enumerate(self.layers):
                x, (k, v) = self._block(lp, x, cos, sin)
                if cache is not None:
                    cache["k"][i, :, :S] = k
                    cache["v"][i, :, :S] = v
            return x
        x0 = x
        sites = cfg.shared_sites()
        for i, lp in enumerate(self.layers):
            if i in sites:
                site = sites.index(i)
                h, (k, v) = self._block(self.shared_attn, self._site_input(site, x, x0),
                                        cos, sin)
                x = x + h
                if cache is not None:
                    cache["k"][site, :, :S] = k
                    cache["v"][site, :, :S] = v
            args = (lp.mamba, lp.norm(x), cfg.ssm_chunk)
            if cache is None:
                x = x + SSM.mamba2_forward(*args, decay_dtype=cfg.ssd_decay_dtype)
            else:
                out, (state, conv) = SSM.mamba2_forward(
                    *args, return_state=True, decay_dtype=cfg.ssd_decay_dtype)
                cache["ssm"][i], cache["conv"][i] = state, conv
                x = x + out
        return x

    # ------------------------------------------------------------ forward ----
    def forward(self, batch: Dict[str, torch.Tensor]):
        """Full-sequence forward → (logits [B,S,V] fp32, aux loss 0)."""
        tokens = batch["tokens"]
        cos, sin = self._rope(torch.arange(tokens.shape[1], device=tokens.device))
        x = self._layers(self._embed(tokens), cos, sin)
        return self._unembed(x), torch.zeros((), device=tokens.device)

    # ------------------------------------------------------- prefill/decode ----
    def init_cache(self, batch_size: int, max_len: int) -> Dict[str, Any]:
        cfg = self.cfg
        dev = self.embed.device
        if cfg.family == "dense":
            kv = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.head_dim)
            return {"k": torch.zeros(kv, dtype=cfg.dtype, device=dev),
                    "v": torch.zeros(kv, dtype=cfg.dtype, device=dev),
                    "pos": 0}
        di = cfg.ssm_expand * cfg.d_model
        H = di // cfg.ssm_headdim
        kv = (len(cfg.shared_sites()), batch_size, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {"ssm": torch.zeros(cfg.n_layers, batch_size, H, cfg.ssm_state,
                                   cfg.ssm_headdim, dtype=torch.float32, device=dev),
                "conv": torch.zeros(cfg.n_layers, batch_size, 3, di, dtype=cfg.dtype,
                                    device=dev),
                "k": torch.zeros(kv, dtype=cfg.dtype, device=dev),
                "v": torch.zeros(kv, dtype=cfg.dtype, device=dev),
                "pos": 0}

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], max_len: Optional[int] = None):
        """Forward over the prompt → (last-position logits [B,V] fp32, cache
        holding the prompt's K/V at positions [0, S) and, for the hybrid, the
        Mamba2 states after it)."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        cache = self.init_cache(B, max_len or S)
        cos, sin = self._rope(torch.arange(S, device=tokens.device))
        x = self._layers(self._embed(tokens), cos, sin, cache)
        cache["pos"] = S
        # the last position alone goes through the head: the reference
        # computes every position's logits and keeps the last
        return self._unembed(x[:, -1:])[:, -1], cache

    @torch.no_grad()
    def decode(self, cache: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        """One decode step: batch['tokens'] [B,1] → (logits [B,V] fp32, cache
        with ``pos`` advanced).  The cache's K/V tensors are updated in place;
        the hybrid's SSM and conv states come back as new tensors."""
        cfg = self.cfg
        pos = cache["pos"]
        tokens = batch["tokens"]
        B = tokens.shape[0]
        x = self._embed(tokens)
        cos, sin = self._rope(torch.full((B, 1), pos, device=tokens.device))
        if cfg.family == "dense":
            for i, lp in enumerate(self.layers):
                x = self._decode_block(lp, x, cache["k"][i], cache["v"][i], pos, cos, sin)
            return self._unembed(x)[:, -1], {**cache, "pos": pos + 1}
        x0 = x
        sites = cfg.shared_sites()
        ssm, conv = [], []
        for i, lp in enumerate(self.layers):
            if i in sites:
                site = sites.index(i)
                x = x + self._decode_block(self.shared_attn, self._site_input(site, x, x0),
                                           cache["k"][site], cache["v"][site], pos, cos, sin)
            out, s, cc = SSM.mamba2_decode(lp.mamba, lp.norm(x), cache["ssm"][i],
                                           cache["conv"][i])
            x = x + out
            ssm.append(s)
            conv.append(cc)
        return self._unembed(x)[:, -1], {**cache, "ssm": torch.stack(ssm),
                                         "conv": torch.stack(conv), "pos": pos + 1}
