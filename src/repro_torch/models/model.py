"""Decoder LM: config → init / forward / prefill / decode.

``ModelConfig`` keeps every field of the JAX package's, with torch dtypes in
place of jnp ones, and adds DeepSeek-V2's published forms, each off by
default (so the defaults compute the JAX package's function): RMSNorm's
``rms_eps`` in every norm, group-limited routing (``n_group``,
``topk_group``), unnormalised and scaled gates (``norm_topk_prob``,
``routed_scaling_factor``), YaRN (``rope_scaling``, MLA's), the dropless
capacity (``capacity_factor=None``), one chip's share of the routed
experts (``experts_held``) and pads that take no routed expert
(``unrouted_pad``); and Nemotron-H's, likewise off by default: the layer
pattern (``layer_pattern``), Mamba2's groups, conv over [x, B, C] and gate
before a grouped norm (``ssm_groups``, ``ssm_conv_bc``,
``ssm_gate_norm_groups``), sigmoid routing with a correction bias
(``router_scoring``), relu² experts (``expert_act``) and the shared
expert's own width (``d_ff_shared``).  ``Model`` is an ``nn.Module`` for
these families:

dense   llama-style GQA transformer (granite-20b, deepseek-67b, yi-9b,
        llama3.2-3b)
vlm     the dense backbone with Qwen2-VL's M-RoPE and precomputed patch
        embeddings scattered over the tokens (the vision frontend is a stub)
audio   the dense backbone over K EnCodec codebooks: tokens [B,K,S], their
        K embeddings summed in, K heads out (logits [B,S,K,V])
moe     dense attention + MoE FFN (phi3.5-moe, ``models.moe``)
mla_moe DeepSeek-V2: MLA attention (``models.mla``) + shared and routed
        experts, layer 0's FFN dense
hybrid  zamba2: a Mamba2 backbone (``models.ssm``) with one weight-shared
        attention block applied before every ``attn_every``-th layer to
        concat(x, embeddings) through a per-site projection
xlstm   mLSTM blocks with an sLSTM block at every layer i with
        i % slstm_every == 1 (``models.xlstm``); attention-free, its decode
        state O(1) in the sequence length
nemotron_h  Nemotron-H: blocks x + mixer(rmsnorm(x)) by ``layer_pattern``,
        M a Mamba2 mixer, E the MoE (sigmoid-routed relu² experts and a
        shared one), * GQA attention with no position embedding; no block
        has an FFN beside its mixer

The reference scans uniform stacks over params stacked on axis 0; here that
axis is split into a ``ModuleList``, so ``layers.{i}.attn.wq`` is the
reference's ``layers/attn/wq[i]``; mla_moe's unstacked ``layer0`` keeps its
name, and its stack ``layers.{i}`` is the reference's layer i + 1.  The
hybrid's and xlstm's ``layers/l{i}`` and the hybrid's ``shared_proj/s{i}``
are ``layers.{i}`` and ``shared_proj.{i}`` (``models.convert.params_from_jax``).

Weights are drawn on ``device`` from a ``torch.Generator`` seeded with
``seed``; they are bf16 whatever ``cfg.dtype`` is, as in the reference.
``prefill`` and ``decode`` run without autograd; ``forward`` and ``loss``
run with it where the parameters require gradients, which the trainer
turns on (``training.train_step``) and serving leaves off.  Every family
has one decode step, ``decode_in_place``, which writes K/V and every
recurrent state into the cache it is given.  ``decode`` runs it op by op
on the caller's cache with the recurrent states cloned, so the K/V land
in the caller's tensors, the SSM, conv and xLSTM states come back new and
a prefill cache can be decoded from more than once; on a CUDA device the
dense, hybrid, mla_moe and nemotron_h families' ``decode`` replays a CUDA graph of it
instead (``models.decode_graph``), which copies the cache it is given
into its own and leaves that one as it was.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..kernels import _mesh
from . import decode_graph as DG
from . import layers as L
from . import mla as MLA
from . import moe as MOE
from . import ssm as SSM
from . import xlstm as XL
from .common import make_param


@dataclasses.dataclass
class ModelConfig:
    arch: str
    family: str                    # dense|moe|mla_moe|hybrid|xlstm|vlm|audio|nemotron_h
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    rope_scaling: Optional[L.YaRN] = None   # MLA's RoPE: None plain, else YaRN
    rms_eps: float = 1e-5
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: Optional[float] = 1.25   # None: dropless
    moe_layer_start: int = 0       # layers < start use the dense FFN
    n_group: int = 0               # group-limited routing; 0: greedy over all experts
    topk_group: int = 0
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    experts_held: Optional[Tuple[int, int]] = None   # (first, count); None: all
    router_scoring: str = "softmax"     # or "sigmoid" with a correction bias (moe.Rule)
    expert_act: str = "swiglu"          # or "relu2": ungated experts
    d_ff_shared: int = 0                # the shared experts' width; 0: d_ff_expert × n_shared
    # a token id: each row's leading run of it (the serving engine's left
    # pads, token 0) takes no routed expert in a full-sequence pass
    unrouted_pad: Optional[int] = None
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
    ssm_inner: int = 0             # Mamba2's heads × head dim; 0: ssm_expand × d_model
    ssm_groups: int = 1            # Mamba2's n_groups of B and C
    ssm_conv_bc: bool = False      # the conv over [x, B, C], not x alone
    ssm_gate_norm_groups: bool = False   # y·silu(z), then RMSNorm over each group
    attn_every: int = 0            # zamba2: shared attn block cadence
    # Nemotron-H: one block a character, M Mamba2, E MoE, * attention
    layer_pattern: str = ""
    # xLSTM
    slstm_every: int = 0           # 0 = no sLSTM layers; else layers i%k==1
    mlstm_chunk: int = 128
    # VLM
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    n_patches: int = 0
    # audio
    codebooks: int = 0
    # compute knobs (the JAX package's hillclimb levers): remat and
    # remat_policy pick each block's activation checkpointing under
    # autograd (``_remat``); the CPU attention reads q_chunk, kv_chunk and
    # unroll_attention (the causal block skip); the port's layers are a
    # ModuleList whatever scan_layers says, which names the reference's
    # stacking only (``models.convert``)
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
        if self.n_group and (self.n_experts % self.n_group
                             or not 0 < self.topk_group <= self.n_group):
            raise ValueError(f"{self.arch}: {self.n_experts} experts in {self.n_group} "
                             f"groups, {self.topk_group} kept")
        if self.rope_scaling is not None and self.family != "mla_moe":
            raise ValueError(f"{self.arch}: rope_scaling (YaRN) is MLA's; the {self.family} "
                             f"family takes plain RoPE")
        if self.family == "nemotron_h":
            bad = set(self.layer_pattern) - set(PATTERN_KINDS)
            if bad or len(self.layer_pattern) != self.n_layers:
                raise ValueError(f"{self.arch}: layer_pattern {self.layer_pattern!r} must be "
                                 f"{self.n_layers} blocks of {PATTERN_KINDS} (M Mamba2, E MoE, "
                                 f"* attention)")
        self.routing                     # the rule's own checks

    @property
    def routing(self) -> MOE.Rule:
        """The routing rule, as ``moe.route`` takes it."""
        return MOE.Rule(self.n_group, self.topk_group, self.norm_topk_prob,
                        self.routed_scaling_factor, self.router_scoring)

    @property
    def ssm_d_inner(self) -> int:
        """Mamba2's inner width, Di."""
        return self.ssm_inner or self.ssm_expand * self.d_model

    @property
    def supports_long_context(self) -> bool:
        return self.family in ("hybrid", "xlstm")

    def is_slstm(self, i: int) -> bool:
        """Whether xlstm's layer i is an sLSTM block (else mLSTM)."""
        return bool(self.slstm_every) and i % self.slstm_every == 1

    def shared_sites(self):
        """Layers before which the hybrid's shared attention block runs."""
        if not self.attn_every:
            return []
        return [i for i in range(self.n_layers) if i % self.attn_every == 0]

    def param_count(self) -> int:
        """Parameter count from the shapes ``Model`` builds."""
        _require_ported(self)
        d, hd, fam = self.d_model, self.head_dim, self.family
        norms = 2 * d                                        # ln1, ln2
        gqa = d * self.n_heads * hd * 2 + d * self.n_kv_heads * hd * 2   # wq, wo; wk, wv

        def mlp(f):
            return 3 * d * f                                 # wg, wu, wd

        held = self.experts_held[1] if self.experts_held else self.n_experts
        moe = (d * self.n_experts + held * mlp(self.d_ff_expert)
               + mlp(self.d_ff_expert * self.n_shared_experts))          # router, experts, shared
        H, ql, kvl = self.n_heads, self.q_lora, self.kv_lora
        mla = (d * ql + ql + ql * H * (self.nope_head_dim + self.rope_head_dim)
               + d * kvl + kvl + kvl * H * (self.nope_head_dim + self.v_head_dim)
               + d * self.rope_head_dim + H * self.v_head_dim * d)
        books = self.codebooks if fam == "audio" else 1
        outer = 2 * books * self.vocab * d + d               # embed, lm_head/heads, final_norm
        if fam == "xlstm":
            di, H = self.ssm_expand * d, self.n_heads
            Dh, dh = di // H, d // H
            mlstm = (d * 2 * di + 3 * H * Dh * Dh            # w_up; wq, wk, wv
                     + 2 * di * H + H + di + di * d)         # wi, wf, f_bias, out_norm, w_down
            slstm = d * 4 * d + H * dh * 4 * dh + 4 * d + d + d * d   # wx, r, bias, out_norm, wo
            n_s = sum(map(self.is_slstm, range(self.n_layers)))
            return outer + self.n_layers * d + n_s * slstm + (self.n_layers - n_s) * mlstm
        if fam in ("dense", "vlm", "audio"):
            return outer + self.n_layers * (norms + gqa + mlp(self.d_ff))
        if fam == "moe":
            return outer + self.n_layers * (norms + gqa + moe)
        if fam == "mla_moe":
            return (outer + norms + mla + mlp(self.d_ff_expert * 8)
                    + (self.n_layers - 1) * (norms + mla + moe))
        di = self.ssm_d_inner
        Hs, GN = di // self.ssm_headdim, self.ssm_groups * self.ssm_state
        conv = di + 2 * GN if self.ssm_conv_bc else di
        mamba = (d                                           # the layer's norm
                 + 3 * d * di                                # wz, wx, wo
                 + 4 * conv + conv + di                      # conv_w, conv_b, out_norm
                 + 2 * d * GN + d * Hs + 3 * Hs)             # wB, wC, wdt, dt_bias, a_log, d_skip
        if fam == "nemotron_h":
            f = 2 if self.expert_act == "relu2" else 3
            shared = self.d_ff_shared or self.d_ff_expert * self.n_shared_experts
            moe = (d + d * self.n_experts + held * f * d * self.d_ff_expert
                   + (f * d * shared if self.n_shared_experts else 0)
                   + (self.n_experts if self.router_scoring == "sigmoid" else 0))
            kinds = {"M": mamba, "E": moe, "*": d + gqa}
            return outer + sum(kinds[k] for k in self.layer_pattern)
        return (outer + norms + gqa + mlp(self.d_ff) + len(self.shared_sites()) * 2 * d * d
                + self.n_layers * mamba)

    def active_param_count(self) -> int:
        """Parameters touched per token (N_active of the MoE rooflines), as
        the reference counts them."""
        total = self.param_count()
        if not self.n_experts:
            return total
        per_expert = (2 if self.expert_act == "relu2" else 3) * self.d_model * self.d_ff_expert
        n_moe_layers = (self.layer_pattern.count("E") if self.family == "nemotron_h"
                        else self.n_layers - self.moe_layer_start)
        return total - per_expert * (self.n_experts - self.top_k) * n_moe_layers


# the families whose layers are GQA attention with a K/V cache
GQA_FAMILIES = ("dense", "vlm", "audio", "moe")
PORTED_FAMILIES = GQA_FAMILIES + ("mla_moe", "hybrid", "xlstm", "nemotron_h")
# nemotron_h's blocks by their character in ``layer_pattern``
PATTERN_KINDS = ("M", "E", "*")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.arch}) is not one of the port's "
            f"{PORTED_FAMILIES}")


# the counterpart of jax's dots_with_no_batch_dims_saveable: keep what a
# matrix product made, recompute the rest
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default})


def _dots_saveable(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``fn`` under the config's activation checkpointing: ``"full"``
    recomputes the whole block in the backward, ``"dots"`` keeps the
    outputs of mm/bmm/addmm and recomputes the rest; ``"none"`` or
    ``remat=False`` run it as it is.  Outside autograd (serving under
    ``no_grad``) every policy runs ``fn`` as it is."""
    if not cfg.remat or cfg.remat_policy == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat_policy == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _dots_saveable))
    if cfg.remat_policy != "full":
        raise ValueError(f"remat_policy {cfg.remat_policy!r}: one of full, dots, none")
    return functools.partial(checkpoint, fn, use_reentrant=False)


def _normed(norm: nn.Module, x):
    """A block's normed input, its sequence whole: between blocks the
    reference splits the sequence ("act_seq"), and a DTensor whose batch
    and sequence are split over two mesh dims cannot be flattened for the
    block's matrix products, so the split is gathered here (the identity
    off a mesh)."""
    return L.lsc(norm(x), "batch", "seq", None)


def _residual(x, h):
    """x + a block's output h, h made whole in the sequence first: in the
    backward h's gradient then arrives whole too, which the block's matrix
    products need (see ``_normed``); the identity off a mesh."""
    return x + L.lsc(h, "batch", "seq", None)


def _scatter_patches(x, where, patches):
    """x [B,S,D] with row b's positions ``where`` [B,P] replaced by
    ``patches`` [B,P,D] cast to x's dtype.  On a mesh each rank writes its
    own batch rows (x, where and patches are all split on the batch): the
    reference's scatter (``src/repro/models/model.py:284-289``), which
    DTensor's ``index_put_`` has no strategy for."""
    def local(x, where, patches):
        rows = torch.arange(x.shape[0], device=x.device)[:, None].expand_as(where)
        return x.index_put((rows, where), patches.to(x.dtype))

    if not L._is_dtensor(x):
        return local(x, where, patches)
    from torch.distributed.tensor import Replicate, Shard

    batch = [Shard(0) if p.is_shard(0) else Replicate() for p in x.placements]
    return _mesh.run(local, (x, where, patches), (batch,) * 3, batch, x.device_mesh)


class Layer(nn.Module):
    """A pre-norm block: ``ln1``, attention (GQA, or MLA with ``mla``),
    ``ln2``, then the FFN: a SwiGLU ``mlp`` of width ``d_ff`` (the
    config's by default) or, with ``moe``, the MoE layer."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device=None,
                 mla: bool = False, moe: bool = False, d_ff: Optional[int] = None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, device, cfg.rms_eps)
        if mla:
            self.attn = MLA.MLA(gen, cfg.d_model, cfg.n_heads, cfg.q_lora, cfg.kv_lora,
                                cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim,
                                device, cfg.rms_eps)
        else:
            self.attn = L.GQA(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, device)
        self.ln2 = L.RMSNorm(cfg.d_model, device, cfg.rms_eps)
        if moe:
            self.mlp = None
            self.moe = MOE.MoE(gen, cfg.d_model, cfg.d_ff_expert, cfg.n_experts,
                               cfg.n_shared_experts, device, held=cfg.experts_held)
        else:
            self.mlp = L.MLP(gen, cfg.d_model, d_ff or cfg.d_ff, device)
            self.moe = None


def _mamba2(cfg: ModelConfig, gen: torch.Generator, device=None) -> SSM.Mamba2:
    return SSM.Mamba2(gen, cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state,
                      cfg.ssm_headdim, device=device, eps=cfg.rms_eps, n_groups=cfg.ssm_groups,
                      conv_bc=cfg.ssm_conv_bc, gate_norm_groups=cfg.ssm_gate_norm_groups)


class MambaLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device=None):
        super().__init__()
        self.norm = L.RMSNorm(cfg.d_model, device, cfg.rms_eps)
        self.mamba = _mamba2(cfg, gen, device)


class PatternLayer(nn.Module):
    """A Nemotron-H block, x + mixer(norm(x)): ``mamba`` (M), ``moe`` (E)
    or ``attn`` (*, GQA), the other two ``None``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, kind: str, device=None):
        super().__init__()
        d = cfg.d_model
        self.norm = L.RMSNorm(d, device, cfg.rms_eps)
        self.mamba = _mamba2(cfg, gen, device) if kind == "M" else None
        self.moe = MOE.MoE(gen, d, cfg.d_ff_expert, cfg.n_experts, cfg.n_shared_experts,
                           device, held=cfg.experts_held, act=cfg.expert_act,
                           score_bias=cfg.router_scoring == "sigmoid",
                           d_ff_shared=cfg.d_ff_shared) if kind == "E" else None
        self.attn = (L.GQA(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, device)
                     if kind == "*" else None)


class XLSTMLayer(nn.Module):
    """A pre-norm residual xLSTM block: ``norm`` then ``slstm`` or
    ``mlstm``, the other ``None``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, slstm: bool, device=None):
        super().__init__()
        self.norm = L.RMSNorm(cfg.d_model, device, cfg.rms_eps)
        self.slstm = (XL.SLSTM(gen, cfg.d_model, cfg.n_heads, device, cfg.rms_eps)
                      if slstm else None)
        self.mlstm = None if slstm else XL.MLSTM(gen, cfg.d_model, cfg.n_heads,
                                                 cfg.ssm_expand, device, cfg.rms_eps)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0):
        super().__init__()
        _require_ported(cfg)
        self.cfg = cfg
        gen = (None if torch.device(device).type == "meta"
               else torch.Generator(device=device).manual_seed(seed))
        d, fam = cfg.d_model, cfg.family
        if fam == "audio":
            self.embed = make_param(gen, (cfg.codebooks, cfg.vocab, d),
                                    (None, "vocab", "embed"), 0.02, device=device)
            self.heads = make_param(gen, (cfg.codebooks, d, cfg.vocab),
                                    (None, "embed", "vocab"), d ** -0.5, device=device)
        else:
            self.embed = make_param(gen, (cfg.vocab, d), ("vocab", "embed"), 0.02, device=device)
            self.lm_head = make_param(gen, (d, cfg.vocab), ("embed", "vocab"),
                                      d ** -0.5, device=device)
        self.final_norm = L.RMSNorm(d, device, cfg.rms_eps)
        if fam in GQA_FAMILIES:
            self.layers = nn.ModuleList(Layer(cfg, gen, device, moe=fam == "moe")
                                        for _ in range(cfg.n_layers))
        elif fam == "mla_moe":
            # DeepSeek-V2: layer 0's FFN is dense, of width d_ff_expert * 8
            self.layer0 = Layer(cfg, gen, device, mla=True, d_ff=cfg.d_ff_expert * 8)
            self.layers = nn.ModuleList(Layer(cfg, gen, device, mla=True, moe=True)
                                        for _ in range(cfg.n_layers - 1))
        elif fam == "xlstm":
            self.layers = nn.ModuleList(XLSTMLayer(cfg, gen, cfg.is_slstm(i), device)
                                        for i in range(cfg.n_layers))
        elif fam == "nemotron_h":
            self.layers = nn.ModuleList(PatternLayer(cfg, gen, kind, device)
                                        for kind in cfg.layer_pattern)
        else:
            # zamba2: one attention block whose weights every site shares, a
            # [2d, d] projection of concat(x, embeddings) per site
            self.shared_attn = Layer(cfg, gen, device)
            self.layers = nn.ModuleList(MambaLayer(cfg, gen, device)
                                        for _ in range(cfg.n_layers))
            self.shared_proj = nn.ParameterList(
                make_param(gen, (2 * d, d), ("embed", "embed2"), (2 * d) ** -0.5, device=device)
                for _ in cfg.shared_sites())
        # decode's CUDA graphs by the cache's shapes, made at their first step
        # (``models.decode_graph``), and how many were captured and replayed
        self._decode_graphs: Dict[tuple, DG.DecodeGraph] = {}
        self.decode_graph_captures = 0
        self.decode_graph_replays = 0
        # the MoE layers' running sums (``moe.moe_forward``'s ``counts``):
        # slots routed, held here, expert rows computed, held slots dropped,
        # held experts read; int64 [5] on the device, made at the first MoE
        # call outside autograd
        self.moe_sums: Optional[torch.Tensor] = None

    def _apply(self, fn, *args, **kwargs):
        # a graph reads the parameters at the addresses they had when it was
        # captured: a move or a cast drops the graphs
        self._decode_graphs.clear()
        return super()._apply(fn, *args, **kwargs)

    @property
    def moe_counts(self) -> Optional[torch.Tensor]:
        """The first four of ``moe_sums``, the slots' sums: routed, held,
        expert rows, dropped."""
        return None if self.moe_sums is None else self.moe_sums[:4]

    def load_state_dict(self, *args, **kwargs):
        self._decode_graphs.clear()     # ``assign=True`` puts new tensors in
        return super().load_state_dict(*args, **kwargs)

    # ------------------------------------------------------------- helpers ----
    def _embed(self, batch):
        """tokens [B,S] (audio: [B,K,S], the K codebooks' embeddings summed)
        → [B,S,D] in ``cfg.dtype``.  vlm: ``patch_embeds`` [B,P,D] replace
        the token embeddings at ``patch_positions`` [B,P] (the vision
        frontend is a stub, as in the reference), cast to the embedding's
        bf16 first, as the reference does."""
        cfg = self.cfg
        tokens = batch["tokens"]
        if cfg.family == "audio":
            x = torch.zeros(tokens.shape[0], tokens.shape[2], cfg.d_model, dtype=cfg.dtype,
                            device=tokens.device)
            for kb in range(cfg.codebooks):
                x = x + L.embed_lookup(self.embed[kb], tokens[:, kb]).to(cfg.dtype)
            return L.lsc(x, "batch", "seq", None)
        x = L.embed_lookup(self.embed, tokens)
        if cfg.family == "vlm" and "patch_embeds" in batch:
            x = _scatter_patches(L.lsc(x, "batch", "seq", None), batch["patch_positions"],
                                 batch["patch_embeds"])
        return L.lsc(x.to(cfg.dtype), "batch", "seq", None)

    def _rope(self, batch, S, device):
        """cos/sin for positions [0, S): vlm's M-RoPE from ``positions3``
        [B,S,3] (t, h, w) where the batch has it, else the positions
        broadcast to all three."""
        cfg = self.cfg
        pos = torch.arange(S, device=device)
        if cfg.family == "vlm":
            pos3 = batch.get("positions3")
            if pos3 is None:
                pos3 = pos[None, :, None].expand(1, S, 3)
            return L.mrope_angles(pos3, cfg.head_dim, cfg.mrope_sections, cfg.rope_theta)
        return L.rope_angles(pos, cfg.head_dim, cfg.rope_theta)

    def _unembed(self, x):
        x = _normed(self.final_norm, x)
        if self.cfg.family == "audio":
            logits = L.einsum("bsd,kdv->bskv", x, self.heads.to(x.dtype))
        else:
            logits = L.einsum("bsd,dv->bsv", x, self.lm_head.to(x.dtype))
        return logits.float()

    def _ffn(self, lp: Layer, x, pads=None, ragged: bool = False):
        """x + the layer's FFN of ln2(x) → (x, the MoE's aux loss or None).
        ``pads`` [B,S] and ``ragged`` (a full-sequence pass): ``moe.route``'s."""
        cfg = self.cfg
        if lp.moe is None:
            return _residual(x, L.mlp_forward(lp.mlp, _normed(lp.ln2, x))), None
        m, aux = MOE.moe_forward(lp.moe, _normed(lp.ln2, x), cfg.top_k, cfg.capacity_factor,
                                 counts=self._moe_sums(x), rule=cfg.routing, ragged=ragged,
                                 pads=pads)
        return _residual(x, m), aux

    def _pads(self, batch: Dict[str, torch.Tensor]):
        """[B,S] bool: each row's leading run of ``cfg.unrouted_pad``, or None."""
        pad = self.cfg.unrouted_pad
        if pad is None or not self.cfg.n_experts:
            return None
        return (batch["tokens"] == pad).long().cumprod(-1).bool()

    def _moe_sums(self, x) -> Optional[torch.Tensor]:
        """``moe_sums`` on x's device, for a call outside autograd off a
        mesh (serving's); None elsewhere (training, the mesh)."""
        if torch.is_grad_enabled() or L._is_dtensor(x):
            return None
        if self.moe_sums is None or self.moe_sums.device != x.device:
            self.moe_sums = torch.zeros(5, dtype=torch.int64, device=x.device)
        return self.moe_sums

    def _block(self, lp: Layer, x, cos, sin, pads=None):
        cfg = self.cfg
        h, kv = L.gqa_forward(lp.attn, _normed(lp.ln1, x), cos, sin, q_chunk=cfg.q_chunk,
                              kv_chunk=cfg.kv_chunk, unroll=cfg.unroll_attention)
        x, aux = self._ffn(lp, _residual(x, h), pads, ragged=True)
        return x, kv, aux

    def _mla_block(self, lp: Layer, x, positions, pads=None):
        cfg = self.cfg
        h, latent = MLA.mla_forward(lp.attn, _normed(lp.ln1, x), positions, cfg.nope_head_dim,
                                    cfg.rope_head_dim, cfg.rope_theta, cfg.q_chunk,
                                    cfg.kv_chunk, unroll=cfg.unroll_attention,
                                    rope_scaling=cfg.rope_scaling)
        x, aux = self._ffn(lp, _residual(x, h), pads, ragged=True)
        return x, latent, aux

    def _mla_layers(self):
        return [self.layer0, *self.layers]

    def _decode_block(self, lp: Layer, x, k_cache, v_cache, pos, cos, sin):
        h, _, _ = L.gqa_decode(lp.attn, lp.ln1(x), k_cache, v_cache, pos, cos, sin)
        return self._ffn(lp, x + h)[0]

    def _site_input(self, site: int, x, x0):
        """Zamba2's shared block reads concat(x, embeddings) through the
        site's own projection; its output is added to x."""
        return L.matmul(torch.cat([x, x0], dim=-1), self.shared_proj[site].to(x.dtype))

    def _shared_site(self, site: int, x, x0, cos, sin):
        h, kv, _ = self._block(self.shared_attn, self._site_input(site, x, x0), cos, sin)
        return _residual(x, h), kv

    def _mamba_block(self, lp: MambaLayer, x):
        return _residual(x, SSM.mamba2_forward(lp.mamba, _normed(lp.norm, x),
                                                 self.cfg.ssm_chunk,
                                                 decay_dtype=self.cfg.ssd_decay_dtype))

    def _xlstm_block(self, lp: XLSTMLayer, x):
        """xlstm's block → (its output, to be added to x, and its state)."""
        cfg = self.cfg
        h = _normed(lp.norm, x)
        if lp.slstm is not None:
            return XL.slstm_forward(lp.slstm, h, cfg.n_heads, return_state=True)
        return XL.mlstm_forward(lp.mlstm, h, cfg.n_heads, cfg.mlstm_chunk, return_state=True)

    def _layers(self, x, cos, sin, cache=None, pads=None):
        """Every layer over the full sequence → (x, the MoE layers' summed
        aux loss).  With ``cache``, write the attention K/V (mla_moe: the
        latent and the RoPE key) at positions [0, S) and, for the hybrid,
        each Mamba2 layer's final state and conv cache; ``pads`` [B,S]
        take no routed expert (``_pads``).  Each block runs
        under ``_remat``; the activation between blocks is constrained to
        ("batch", "act_seq") where the reference constrains it."""
        cfg = self.cfg
        S = x.shape[1]
        aux_total = torch.zeros((), device=x.device)
        if cfg.family in GQA_FAMILIES or cfg.family == "mla_moe":
            mla = cfg.family == "mla_moe"
            names = ("ckv", "kr") if mla else ("k", "v")
            positions = torch.arange(S, device=x.device)
            for i, lp in enumerate(self._mla_layers() if mla else self.layers):
                if mla:
                    x, (a, b), aux = _remat(self._mla_block, cfg)(lp, x, positions, pads)
                else:
                    x, (a, b), aux = _remat(self._block, cfg)(lp, x, cos, sin, pads)
                # the reference leaves mla_moe's layer 0 and its prefill as they are
                if not mla or (i and cache is None):
                    x = L.lsc(x, "batch", "act_seq", None)
                if aux is not None:
                    aux_total = aux_total + aux
                if cache is not None:
                    L.write_slice(cache[names[0]][i], 0, a)
                    L.write_slice(cache[names[1]][i], 0, b)
            return x, aux_total
        if cfg.family == "xlstm":
            return self._xlstm_layers(x, cache), aux_total
        if cfg.family == "nemotron_h":
            return self._pattern_layers(x, cache, pads)
        x0 = x
        sites = cfg.shared_sites()
        for i, lp in enumerate(self.layers):
            if i in sites:
                site = sites.index(i)
                x, (k, v) = _remat(self._shared_site, cfg)(site, x, x0, cos, sin)
                if cache is not None:
                    L.write_slice(cache["k"][site], 0, k)
                    L.write_slice(cache["v"][site], 0, v)
            if cache is None:
                x = _remat(self._mamba_block, cfg)(lp, x)
            else:
                out, (state, conv) = SSM.mamba2_forward(
                    lp.mamba, _normed(lp.norm, x), cfg.ssm_chunk, return_state=True,
                    decay_dtype=cfg.ssd_decay_dtype)
                L.write_slice(cache["ssm"][i], 0, state)
                L.write_slice(cache["conv"][i], 0, conv)
                x = x + out
        return x, aux_total

    def _pattern_block(self, lp: PatternLayer, x, pads=None):
        """nemotron_h's block over the full sequence → (its output, to be
        added to x; its state or K/V (None for E); the MoE's aux loss or
        None)."""
        cfg = self.cfg
        h = _normed(lp.norm, x)
        if lp.mamba is not None:
            out, state = SSM.mamba2_forward(lp.mamba, h, cfg.ssm_chunk, return_state=True,
                                            decay_dtype=cfg.ssd_decay_dtype)
            return out, state, None
        if lp.moe is not None:
            out, aux = MOE.moe_forward(lp.moe, h, cfg.top_k, cfg.capacity_factor,
                                       counts=self._moe_sums(x), rule=cfg.routing,
                                       ragged=True, pads=pads)
            return out, None, aux
        out, kv = L.gqa_forward(lp.attn, h, None, None, q_chunk=cfg.q_chunk,
                                kv_chunk=cfg.kv_chunk, unroll=cfg.unroll_attention)
        return out, kv, None

    def _pattern_layers(self, x, cache=None, pads=None):
        """nemotron_h's blocks over the full sequence → (x, the summed aux
        loss); with ``cache``, write each Mamba2 layer's final state and conv
        window and each attention layer's K/V at [0, S)."""
        aux_total = torch.zeros((), device=x.device)
        m = a = 0
        for lp in self.layers:
            out, state, aux = _remat(self._pattern_block, self.cfg)(lp, x, pads)
            if lp.mamba is not None:
                if cache is not None:
                    L.write_slice(cache["ssm"][m], 0, state[0])
                    L.write_slice(cache["conv"][m], 0, state[1])
                m += 1
            elif lp.attn is not None:
                if cache is not None:
                    L.write_slice(cache["k"][a], 0, state[0])
                    L.write_slice(cache["v"][a], 0, state[1])
                a += 1
            else:
                aux_total = aux_total + aux
            x = _residual(x, out)
        return x, aux_total

    def _xlstm_layers(self, x, cache=None):
        """xlstm's blocks over the full sequence; with ``cache``, write each
        mLSTM layer's final (C, n) and each sLSTM layer's (h, c, n)."""
        cfg = self.cfg
        mi = si = 0
        for lp in self.layers:
            out, state = _remat(self._xlstm_block, cfg)(lp, x)
            if lp.slstm is not None:
                if cache is not None:
                    L.write_slice(cache["s_h"][si], 0, torch.stack(state))
                si += 1
            else:
                C, n = state
                if cache is not None:
                    L.write_slice(cache["C"][mi], 0, C)
                    L.write_slice(cache["n"][mi], 0, n)
                mi += 1
            x = _residual(x, out)
        return x

    # ------------------------------------------------------------ forward ----
    def forward(self, batch: Dict[str, torch.Tensor]):
        """Full-sequence forward → (logits [B,S,V] fp32 (audio: [B,S,K,V]),
        the MoE layers' summed aux loss, 0 without MoE)."""
        x = self._embed(batch)
        cos, sin = self._rope(batch, x.shape[1], x.device)
        x, aux = self._layers(x, cos, sin, pads=self._pads(batch))
        return self._unembed(x), aux

    def loss(self, batch: Dict[str, torch.Tensor]):
        """Next-token NLL over the targets >= 0 (audio's targets [B,K,S] are
        transposed to the logits' [B,S,K]), plus 0.01 times the MoE aux loss
        → (loss, {"nll", "aux"}), as the reference's ``Model.loss``."""
        logits, aux = self.forward(batch)
        targets = batch["targets"]
        if self.cfg.family == "audio":
            targets = targets.permute(0, 2, 1)
        mask = (targets >= 0).float()
        tgt = targets.clamp(min=0).long()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -L.gather_last(logp, tgt)
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return loss + 0.01 * aux, {"nll": loss, "aux": aux}

    # ------------------------------------------------------- prefill/decode ----
    def cache_layout(self, batch_size: int, max_len: int) -> Dict[str, tuple]:
        """Every cache tensor's (shape, dtype, logical axes), the
        reference's ``init_cache`` boxes (its leading axis stacks layers,
        shared-attention sites for the hybrid's k and v)."""
        cfg = self.cfg
        B, T = batch_size, max_len
        f32, dt = torch.float32, cfg.dtype
        if cfg.family == "xlstm":
            # O(1) in the length: max_len is not used
            di = cfg.ssm_expand * cfg.d_model
            H = cfg.n_heads
            Dh, dh = di // H, cfg.d_model // H
            n_s = sum(map(cfg.is_slstm, range(cfg.n_layers)))
            n_m = cfg.n_layers - n_s
            return {"C": ((n_m, B, H, Dh, Dh), f32, ("layers", "batch", None, None, None)),
                    "n": ((n_m, B, H, Dh), f32, ("layers", "batch", None, None)),
                    "s_h": ((max(n_s, 1), 3, B, H, dh), f32,
                            ("layers", None, "batch", None, None))}
        if cfg.family in GQA_FAMILIES:
            kv = ((cfg.n_layers, B, T, cfg.n_kv_heads, cfg.head_dim), dt,
                  ("layers", "batch", "seq_kv", "kv_heads", None))
            return {"k": kv, "v": kv}
        if cfg.family == "mla_moe":
            axes = ("layers", "batch", "seq_kv", None)
            return {"ckv": ((cfg.n_layers, B, T, cfg.kv_lora), dt, axes),
                    "kr": ((cfg.n_layers, B, T, cfg.rope_head_dim), dt, axes)}
        di = cfg.ssm_d_inner
        H = di // cfg.ssm_headdim
        # the hybrid's K/V by shared-attention site, nemotron_h's by "*" block
        pattern = cfg.family == "nemotron_h"
        n_ssm = cfg.layer_pattern.count("M") if pattern else cfg.n_layers
        n_kv = cfg.layer_pattern.count("*") if pattern else len(cfg.shared_sites())
        kv = ((n_kv, B, T, cfg.n_kv_heads, cfg.head_dim), dt,
              ("layers" if pattern else None, "batch", "seq_kv", "kv_heads", None))
        conv = ((n_ssm, B, 3, di + 2 * cfg.ssm_groups * cfg.ssm_state), dt,
                ("layers", "batch", None, None)) if cfg.ssm_conv_bc else \
            ((n_ssm, B, 3, di), dt, ("layers", "batch", None, "ffn"))
        return {"ssm": ((n_ssm, B, H, cfg.ssm_state, cfg.ssm_headdim), f32,
                        ("layers", "batch", None, None, None)),
                "conv": conv, "k": kv, "v": kv}

    def init_cache(self, batch_size: int, max_len: int) -> Dict[str, Any]:
        """Zeros of ``cache_layout`` on the parameters' device, ``pos`` 0.
        On a mesh (DTensor parameters, a resolver installed) each tensor is
        a DTensor at the resolver's placements for its logical axes, made
        shard by shard."""
        resolver = L._ACT_RESOLVER.get()
        mesh = resolver is not None and L._is_dtensor(self.embed)
        cache: Dict[str, Any] = {}
        for name, (shape, dtype, axes) in self.cache_layout(batch_size, max_len).items():
            if mesh:
                from torch.distributed.tensor import zeros

                cache[name] = zeros(shape, dtype=dtype, device_mesh=resolver.mesh,
                                    placements=resolver(axes, shape))
            else:
                cache[name] = torch.zeros(shape, dtype=dtype, device=self.embed.device)
        cache["pos"] = 0
        return cache

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], max_len: Optional[int] = None):
        """Forward over the prompt → (last-position logits [B,V] fp32
        (audio: [B,K,V]), cache holding the prompt's K/V (mla_moe: latent
        and RoPE key) at positions [0, S) and, for the hybrid, the Mamba2
        states after it; xlstm's holds its layers' states after the prompt
        and ignores ``max_len``)."""
        tokens = batch["tokens"]
        B, S = tokens.shape[0], tokens.shape[-1]
        cache = self.init_cache(B, max_len or S)
        x = self._embed(batch)
        cos, sin = self._rope(batch, S, tokens.device)
        x, _ = self._layers(x, cos, sin, cache, self._pads(batch))
        cache["pos"] = S
        # the last position alone goes through the head: the reference
        # computes every position's logits and keeps the last
        return self._unembed(x[:, -1:])[:, -1], cache

    @torch.no_grad()
    def decode(self, cache: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        """One decode step: batch['tokens'] [B,1] (audio: [B,K,1]) →
        (logits [B,V] fp32 (audio: [B,K,V]), cache with ``pos`` advanced).
        A ``pos`` past the cache's length on its ``seq_kv`` axis raises
        ``ValueError`` before anything is written.  Where ``DG.replays``
        holds, a CUDA graph of ``decode_in_place`` replays
        (``models.decode_graph``) and the cache returned holds the graph's
        tensors; else ``decode_in_place`` runs op by op on the caller's
        cache with its recurrent states (no ``seq_kv`` axis) cloned."""
        pos = cache["pos"]
        layout = self.cache_layout(1, 1)
        for name, (_, _, axes) in layout.items():
            if "seq_kv" in axes:
                T = cache[name].shape[axes.index("seq_kv")]
                if pos >= T:
                    raise ValueError(f"decode position {pos} is past the cache length {T}")
                break
        if DG.replays(self):
            return DG.decode(self, cache, batch)
        work = {**cache, **{name: cache[name].clone()
                            for name, (_, _, axes) in layout.items() if "seq_kv" not in axes}}
        return self.decode_in_place(work, batch, pos), {**work, "pos": pos + 1}

    @torch.no_grad()
    def decode_in_place(self, cache: Dict[str, Any], batch: Dict[str, torch.Tensor], pos):
        """The step of every family: ``pos`` an int, or a 0-d int64 tensor
        on the cache's device, whose bound ``decode`` checks (``cache["pos"]``
        is not read).  Writes K/V (mla_moe: latent and RoPE key) at ``pos``
        and every recurrent state (the hybrid's SSM and conv, xlstm's C, n
        and s_h) into ``cache`` in place → logits [B,V] fp32.  At a tensor
        ``pos`` it reads nothing on the host and makes no shape from the
        data (the MoE routes unpadded and not ragged: at a capacity set by
        the token count, or, dropless, its T·k slots grouped by expert over
        counts kept on the device where T·k < E, C = T where T·k ≥ E), so a
        CUDA graph can hold it."""
        cfg = self.cfg
        x = self._embed(batch)
        if cfg.family == "xlstm":
            mi = si = 0
            for lp in self.layers:
                h = lp.norm(x)
                if lp.slstm is not None:
                    out, st = XL.slstm_decode(lp.slstm, h, tuple(cache["s_h"][si]), cfg.n_heads)
                    cache["s_h"][si].copy_(torch.stack(st))
                    si += 1
                else:
                    out, (C, n) = XL.mlstm_decode(lp.mlstm, h, (cache["C"][mi], cache["n"][mi]),
                                                  cfg.n_heads)
                    cache["C"][mi].copy_(C)
                    cache["n"][mi].copy_(n)
                    mi += 1
                x = x + out
            return self._unembed(x)[:, -1]
        if cfg.family == "nemotron_h":
            m = a = 0
            for lp in self.layers:
                h = lp.norm(x)
                if lp.mamba is not None:
                    out = SSM.mamba2_decode(lp.mamba, h, cache["ssm"][m], cache["conv"][m])[0]
                    m += 1
                elif lp.moe is not None:
                    out, _ = MOE.moe_forward(lp.moe, h, cfg.top_k, cfg.capacity_factor,
                                             counts=self._moe_sums(x), rule=cfg.routing)
                else:
                    out = L.gqa_decode(lp.attn, h, cache["k"][a], cache["v"][a], pos,
                                       None, None)[0]
                    a += 1
                x = x + out
            return self._unembed(x)[:, -1]
        if cfg.family == "mla_moe":
            for i, lp in enumerate(self._mla_layers()):
                h, _, _ = MLA.mla_decode(lp.attn, lp.ln1(x), cache["ckv"][i], cache["kr"][i],
                                         pos, cfg.nope_head_dim, cfg.rope_head_dim,
                                         cfg.rope_theta, cfg.rope_scaling)
                x, _ = self._ffn(lp, x + h)
            return self._unembed(x)[:, -1]
        B = x.shape[0]
        posb = torch.as_tensor(pos, device=x.device).expand(B, 1)
        if cfg.family == "vlm":
            cos, sin = L.mrope_angles(posb[..., None].expand(B, 1, 3), cfg.head_dim,
                                      cfg.mrope_sections, cfg.rope_theta)
        else:
            cos, sin = L.rope_angles(posb, cfg.head_dim, cfg.rope_theta)
        if cfg.family in GQA_FAMILIES:
            for i, lp in enumerate(self.layers):
                x = self._decode_block(lp, x, cache["k"][i], cache["v"][i], pos, cos, sin)
            return self._unembed(x)[:, -1]
        x0 = x
        sites = cfg.shared_sites()
        for i, lp in enumerate(self.layers):
            if i in sites:
                site = sites.index(i)
                x = x + self._decode_block(self.shared_attn, self._site_input(site, x, x0),
                                           cache["k"][site], cache["v"][site], pos, cos, sin)
            x = x + SSM.mamba2_decode(lp.mamba, lp.norm(x), cache["ssm"][i],
                                      cache["conv"][i])[0]
        return self._unembed(x)[:, -1]
