"""The mla_moe family (DeepSeek-V2) as the benchmark reads it: the port's
``ModelConfig`` for a configuration file, how the benchmark draws each
parameter, the K2 calls and the FLOPs of a prefill and of a decode step,
and a configuration at CPU size.

A configuration holds one chip's share of an expert-parallel layer:
``n_routed_experts`` experts held here, from ``experts_held_first``, of the
router's ``router_experts``.  The counts follow the engine's semantics:
prompts are left-padded to the batch's longest and the pads are attended,
so every padded position is work.  The routed experts are counted at
their expected share of the slots, T·k·held/router_experts (the share
that uniform routing would send here), over every position: the pads
(``unrouted_pad_token``) take no routed expert, so at a prefill's 35-40%
of padding this counts ≈ 3% more FLOPs than were done (the held experts
are ≈ 8% of a position's FLOPs), since ``prefill_flops`` is told B and S
alone.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from benchlib.counts import k2_call

SMOKE = {
    "name": "deepseek-v2-smoke", "family": "mla_moe", "hidden_size": 64,
    "num_hidden_layers": 3, "first_k_dense_replace": 1, "num_attention_heads": 4,
    "num_key_value_heads": 4, "q_lora_rank": 32, "kv_lora_rank": 16, "qk_nope_head_dim": 16,
    "qk_rope_head_dim": 8, "v_head_dim": 16, "intermediate_size": 128,
    "moe_intermediate_size": 16, "n_routed_experts": 8, "router_experts": 64,
    "experts_held_first": 8, "n_group": 8, "topk_group": 3, "num_experts_per_tok": 6,
    "n_shared_experts": 2, "norm_topk_prob": False, "routed_scaling_factor": 16,
    "scoring_func": "softmax", "topk_method": "group_limited_greedy", "hidden_act": "silu",
    "moe_layer_freq": 1, "attention_bias": False, "tie_word_embeddings": False,
    "vocab_size": 256, "rms_norm_eps": 1e-6, "rope_theta": 10000, "unrouted_pad_token": 0,
    "rope_scaling": {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
                     "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                     "mscale_all_dim": 0.707},
    "assumed": {"capacity": "dropless"},
}

# dropless routing makes a row's logits its own: the check may compute any
# subset of a batch's rows together
ROWS_INDEPENDENT = True


def _require(conf: dict, key: str, want) -> None:
    if conf.get(key, want) != want:
        raise ValueError(f"{conf['name']}: the port runs {key} = {want!r}, not {conf[key]!r}")


def model_config(conf: dict):
    """The port's ``ModelConfig`` for a configuration file.  Raises where
    the file asks for something the port cannot run as stated (an older
    port, without DeepSeek-V2's published forms, raises at ``layers.YaRN``
    or at ``ModelConfig``'s new fields)."""
    from repro_torch.models import ModelConfig, layers

    for key, want in (("first_k_dense_replace", 1), ("moe_layer_freq", 1),
                      ("hidden_act", "silu"), ("scoring_func", "softmax"),
                      ("attention_bias", False), ("tie_word_embeddings", False)):
        _require(conf, key, want)
    _require(conf, "num_key_value_heads", conf["num_attention_heads"])
    _require(conf, "intermediate_size", 8 * conf["moe_intermediate_size"])
    method = conf["topk_method"]
    if method not in ("greedy", "group_limited_greedy"):
        raise ValueError(f"{conf['name']}: topk_method {method!r}: the port routes greedy "
                         f"or group_limited_greedy")
    grouped = method == "group_limited_greedy"
    rs = conf.get("rope_scaling")
    if rs is not None and rs.get("type") != "yarn":
        raise ValueError(f"{conf['name']}: rope_scaling {rs.get('type')!r}: the port takes "
                         f"yarn")
    yarn = None if rs is None else layers.YaRN(
        factor=float(rs["factor"]),
        original_max_position_embeddings=int(rs["original_max_position_embeddings"]),
        beta_fast=float(rs["beta_fast"]), beta_slow=float(rs["beta_slow"]),
        mscale=float(rs["mscale"]), mscale_all_dim=float(rs["mscale_all_dim"]))
    nope, rope = conf["qk_nope_head_dim"], conf["qk_rope_head_dim"]
    first, held = conf["experts_held_first"], conf["n_routed_experts"]
    return ModelConfig(
        arch=conf["name"], family="mla_moe", n_layers=conf["num_hidden_layers"],
        d_model=conf["hidden_size"], n_heads=conf["num_attention_heads"],
        n_kv_heads=conf["num_key_value_heads"], d_ff=conf["intermediate_size"],
        vocab=conf["vocab_size"], head_dim=nope + rope, rope_theta=float(conf["rope_theta"]),
        rope_scaling=yarn, rms_eps=float(conf["rms_norm_eps"]),
        n_experts=conf["router_experts"], top_k=conf["num_experts_per_tok"],
        n_shared_experts=conf["n_shared_experts"], d_ff_expert=conf["moe_intermediate_size"],
        capacity_factor=None, moe_layer_start=1,
        n_group=conf["n_group"] if grouped else 0,
        topk_group=conf["topk_group"] if grouped else 0,
        norm_topk_prob=bool(conf["norm_topk_prob"]),
        routed_scaling_factor=float(conf["routed_scaling_factor"]),
        experts_held=(first, held), unrouted_pad=conf.get("unrouted_pad_token"),
        q_lora=conf["q_lora_rank"], kv_lora=conf["kv_lora_rank"],
        nope_head_dim=nope, rope_head_dim=rope, v_head_dim=conf["v_head_dim"],
        scan_layers=False)


def rule(name: str, shape: Tuple[int, ...]):
    """(kind, scale) of the parameter ``name``: kind is normal or ones.

    RMSNorm weights are 1; the embedding is N(0, 0.02²); every other weight
    is N(0, 1/fan_in), its fan-in being the dims it is summed over: the
    first dim of a [in, ...] weight, the second of an expert's
    [E, in, out], the first two of the attention output's [H, v, d]."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "w":
        return "ones", None
    if name == "embed":
        return "normal", 0.02
    if ".moe." in name and ".shared." not in name and leaf in ("wg", "wu", "wd"):
        return "normal", shape[1] ** -0.5
    if leaf == "wo" and len(shape) == 3:           # attention out [H, v, d]
        return "normal", (shape[0] * shape[1]) ** -0.5
    return "normal", shape[0] ** -0.5


def dims(conf: dict) -> dict:
    return dict(d=conf["hidden_size"], L=conf["num_hidden_layers"], V=conf["vocab_size"],
                H=conf["num_attention_heads"], ql=conf["q_lora_rank"],
                kvl=conf["kv_lora_rank"], nope=conf["qk_nope_head_dim"],
                rope=conf["qk_rope_head_dim"], v=conf["v_head_dim"],
                f=conf["intermediate_size"], fe=conf["moe_intermediate_size"],
                E=conf["router_experts"], held=conf["n_routed_experts"],
                k=conf["num_experts_per_tok"], shared=conf["n_shared_experts"])


def kernel_calls(conf: dict, B: int, S: int) -> Dict[str, List[tuple]]:
    """The K2 calls one prefill of [B, S] makes, by their shapes: one a
    layer over the expanded q, k [B, S, H, nope + rope] and v [B, S, H, v]."""
    m = dims(conf)
    return {"k2": [(B, S, m["H"], m["nope"] + m["rope"], m["v"])] * m["L"], "k3": []}


def _projections(m: dict) -> float:
    """MLA's multiply-adds a token outside attention's pairs: q's down and
    up projections, the latent and the RoPE key, K's and V's expansions
    (in decode: the query's absorption of W_uk and the context's W_uv),
    the output."""
    return (m["d"] * m["ql"] + m["ql"] * m["H"] * (m["nope"] + m["rope"])
            + m["d"] * m["kvl"] + m["d"] * m["rope"]
            + m["kvl"] * m["H"] * (m["nope"] + m["v"]) + m["H"] * m["v"] * m["d"])


def _token(m: dict) -> float:
    """FLOPs a token takes outside attention's pairs: every layer's MLA
    projections, layer 0's dense MLP, and in each MoE layer the router,
    the shared experts and the routed experts at their expected share
    here, k · held / router_experts slots."""
    moe = (m["d"] * m["E"] + 3 * m["d"] * m["fe"] * m["shared"]
           + m["k"] * m["held"] / m["E"] * 3 * m["d"] * m["fe"])
    return 2 * (m["L"] * _projections(m) + 3 * m["d"] * m["f"] + (m["L"] - 1) * moe)


def prefill_flops(conf: dict, B: int, S: int) -> float:
    """Model FLOPs of one prefill of [B, S] (the unembedding at the last
    position only, as the engine computes it)."""
    attn = sum(k2_call(*c)[0] for c in kernel_calls(conf, B, S)["k2"])
    unembed = 2 * B * conf["hidden_size"] * conf["vocab_size"]
    return B * S * _token(dims(conf)) + attn + unembed


def decode_flops(conf: dict, B: int, pos: int) -> float:
    """Model FLOPs of one decode step of B tokens at position ``pos`` (the
    step attends to pos + 1 positions) in the absorbed form: per layer and
    head, the scores over the latent and the RoPE key and the context in
    the latent."""
    m = dims(conf)
    T = pos + 1
    attn = m["L"] * 2 * m["H"] * T * (2 * m["kvl"] + m["rope"])
    unembed = 2 * B * m["d"] * m["V"]
    return B * (_token(m) + attn) + unembed
