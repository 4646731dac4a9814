"""The nemotron_h family (Nemotron 3 Nano) as the benchmark reads it: the
port's ``ModelConfig`` for a configuration file, how the benchmark draws
each parameter, the K2 and K3 calls and the FLOPs of a prefill and of a
decode step, and a configuration at CPU size.

The blocks follow ``hybrid_override_pattern``: M a Mamba2 mixer, E the MoE,
* GQA attention with no position embedding, each x + mixer(rmsnorm(x)).
The counts follow the engine's semantics: prompts are left-padded to the
batch's longest, and the pads are attended and scanned, so every padded
position is work.  The routed experts are counted at k slots a position
over every position: the pads (``unrouted_pad_token``) take no routed
expert, so at a prefill's 35-40% of padding this counts more expert FLOPs
than were done, since ``prefill_flops`` is told B and S alone.

K3's calls are counted by group, in shapes ``counts.k3_call`` counts
exactly.  A group's h = H/G heads read one B and one C, and the kernel
computes their C·Bᵀ once for all h (a block of heads is one group), so the
group's scan is counted as one head of width h·P (the h heads side by side:
C·Bᵀ once, the mixing tile times x, C·h and the state update of every
head, x, y, B, C and the state read or written once) and a call of the
other h − 1 heads at width 0 and N 0, which counts their dt and a and no
operation.  The pair's bounds add to the group's own where the wide call
is bytes-bound, as at the cells' shapes; else they exceed it by at most
the h − 1 heads' dt.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from benchlib.counts import k2_call, k3_call

SMOKE = {
    "name": "nemotron-h-smoke", "family": "nemotron_h", "hidden_size": 64,
    "hybrid_override_pattern": "MEM*EM", "num_hidden_layers": 6,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
    "mamba_num_heads": 8, "mamba_head_dim": 8, "ssm_state_size": 16, "n_groups": 2,
    "conv_kernel": 4, "chunk_size": 16, "expand": 2, "mamba_hidden_act": "silu",
    "use_conv_bias": True, "use_bias": False, "mamba_proj_bias": False,
    "n_routed_experts": 8, "num_experts_per_tok": 2, "n_shared_experts": 1,
    "moe_intermediate_size": 32, "moe_shared_expert_intermediate_size": 64,
    "intermediate_size": 32, "n_group": 1, "topk_group": 1, "norm_topk_prob": True,
    "routed_scaling_factor": 2.5, "mlp_hidden_act": "relu2", "mlp_bias": False,
    "attention_bias": False, "layer_norm_epsilon": 1e-5, "norm_eps": 1e-5,
    "residual_in_fp32": False, "tie_word_embeddings": False, "vocab_size": 256,
    "unrouted_pad_token": 0, "assumed": {"capacity": "dropless"},
}

# dropless routing and unrouted pads make a row's logits its own: the check
# may compute any subset of a batch's rows together
ROWS_INDEPENDENT = True

# the correction bias's draw: normal at this scale moves about one of a
# token's six experts in three (about 0.75 of 6 slots a token over sigmoid
# scores of unit-variance logits)
SCORE_BIAS_SCALE = 0.02

# the routed experts' down projections are drawn at this share of
# N(0, 1/fan_in).  With random weights a token's sixth and seventh experts
# nearly tie, so bf16's rounding of the router's input changes ≈ 1.5% of
# the tokens' choices a layer; at N(0, 1/fan_in) such a change moves the
# token's residual ≈ 15%, which changes its later choices in turn, and over
# 23 MoE layers the bf16 program and the fp32 reference part (argmax
# agreement 4-9%, mean gap 1.14-1.39, past the RoPE departure's 1.44).  At
# 1/8 a change moves it ≈ 2%, and the program tracks the reference (mean
# gap ≤ 0.015) while the fp8 control and the departures read 0.068-1.63.
ROUTED_OUT_SCALE = 0.125


def _require(conf: dict, key: str, want) -> None:
    if conf.get(key, want) != want:
        raise ValueError(f"{conf['name']}: the port runs {key} = {want!r}, not {conf[key]!r}")


def model_config(conf: dict):
    """The port's ``ModelConfig`` for a configuration file.  Raises where
    the file asks for something the port cannot run as stated (an older
    port, without the nemotron_h family, raises at ``ModelConfig``'s new
    fields)."""
    from repro_torch.models import ModelConfig

    for key, want in (("mlp_hidden_act", "relu2"), ("mamba_hidden_act", "silu"),
                      ("conv_kernel", 4), ("use_conv_bias", True), ("use_bias", False),
                      ("mamba_proj_bias", False), ("mlp_bias", False),
                      ("attention_bias", False), ("residual_in_fp32", False),
                      ("tie_word_embeddings", False), ("n_group", 1), ("topk_group", 1)):
        _require(conf, key, want)
    pattern = conf["hybrid_override_pattern"]
    _require(conf, "num_hidden_layers", len(pattern))
    eps = float(conf["layer_norm_epsilon"])
    _require(conf, "norm_eps", eps)
    di = conf["mamba_num_heads"] * conf["mamba_head_dim"]
    return ModelConfig(
        arch=conf["name"], family="nemotron_h", n_layers=len(pattern),
        d_model=conf["hidden_size"], n_heads=conf["num_attention_heads"],
        n_kv_heads=conf["num_key_value_heads"], d_ff=conf["intermediate_size"],
        vocab=conf["vocab_size"], head_dim=conf["head_dim"], rms_eps=eps,
        n_experts=conf["n_routed_experts"], top_k=conf["num_experts_per_tok"],
        n_shared_experts=conf["n_shared_experts"], d_ff_expert=conf["moe_intermediate_size"],
        d_ff_shared=conf["moe_shared_expert_intermediate_size"], capacity_factor=None,
        norm_topk_prob=bool(conf["norm_topk_prob"]),
        routed_scaling_factor=float(conf["routed_scaling_factor"]),
        router_scoring="sigmoid", expert_act="relu2",
        unrouted_pad=conf.get("unrouted_pad_token"),
        ssm_state=conf["ssm_state_size"], ssm_headdim=conf["mamba_head_dim"], ssm_inner=di,
        ssm_chunk=conf["chunk_size"], ssm_groups=conf["n_groups"], ssm_conv_bc=True,
        ssm_gate_norm_groups=True, layer_pattern=pattern, scan_layers=False)


def rule(name: str, shape: Tuple[int, ...]):
    """(kind, scale) of the parameter ``name``: kind is normal, ones, a_log
    or dt_bias.

    RMSNorm weights and Mamba2's skip are 1; Mamba2's ``a_log`` and
    ``dt_bias`` follow the published Mamba2 initialisation; the embedding
    is N(0, 0.02²), the conv bias N(0, 0.1²), the router's correction bias
    N(0, ``SCORE_BIAS_SCALE``²), a routed expert's down projection
    N(0, (``ROUTED_OUT_SCALE``)²/fan_in); every other weight is N(0, 1/fan_in), its
    fan-in being the dims it is summed over: the first dim of a [in, ...]
    weight, the second of an expert's [E, in, out], the first two of the
    attention output's [H, hd, d]."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("w", "d_skip"):
        return "ones", None
    if leaf in ("a_log", "dt_bias"):
        return leaf, None
    if leaf == "e_score_correction_bias":
        return "normal", SCORE_BIAS_SCALE
    if leaf == "conv_b":
        return "normal", 0.1
    if name == "embed":
        return "normal", 0.02
    if ".moe." in name and ".shared." not in name and leaf == "wu":
        return "normal", shape[1] ** -0.5
    if ".moe." in name and ".shared." not in name and leaf == "wd":
        return "normal", shape[1] ** -0.5 * ROUTED_OUT_SCALE
    if leaf == "wo" and len(shape) == 3:           # attention out [H, hd, d]
        return "normal", (shape[0] * shape[1]) ** -0.5
    return "normal", shape[0] ** -0.5


def dims(conf: dict) -> dict:
    pattern = conf["hybrid_override_pattern"]
    return dict(d=conf["hidden_size"], V=conf["vocab_size"], pattern=pattern,
                nM=pattern.count("M"), nE=pattern.count("E"), nA=pattern.count("*"),
                Hs=conf["mamba_num_heads"], P=conf["mamba_head_dim"],
                N=conf["ssm_state_size"], G=conf["n_groups"], W=conf["conv_kernel"],
                Q=conf["chunk_size"], H=conf["num_attention_heads"],
                Hkv=conf["num_key_value_heads"], hd=conf["head_dim"],
                E=conf["n_routed_experts"], k=conf["num_experts_per_tok"],
                f=conf["moe_intermediate_size"],
                fs=conf["moe_shared_expert_intermediate_size"] * conf["n_shared_experts"])


def kernel_calls(conf: dict, B: int, S: int) -> Dict[str, List[tuple]]:
    """The K2 and K3 calls one prefill of [B, S] makes, by their shapes: K2
    once an attention block over its query heads (the K/V heads' reads are
    counted at the query heads', which the pairs' operations outweigh), K3
    once a Mamba2 block, counted by group as a head of width h·P and the
    other h − 1 heads' dt (the module's doc)."""
    m = dims(conf)
    h = m["Hs"] // m["G"]
    group = [(B, S, 1, h * m["P"], m["N"], m["Q"])]
    if h > 1:
        group.append((B, S, h - 1, 0, 0, m["Q"]))
    return {"k2": [(B, S, m["H"], m["hd"], m["hd"])] * m["nA"],
            "k3": group * (m["G"] * m["nM"])}


def _token(m: dict) -> float:
    """FLOPs a token takes outside attention's pairs and the scan: the
    Mamba2 projections (z, x, B and C of every group, dt, out) and its conv
    over [x, B, C]; the router, k routed relu² experts and the shared one;
    the attention projections (q, k, v, o)."""
    di, GN = m["Hs"] * m["P"], m["G"] * m["N"]
    mamba = 2 * (2 * m["d"] * di + 2 * m["d"] * GN + m["d"] * m["Hs"] + di * m["d"]) \
        + 2 * m["W"] * (di + 2 * GN)
    moe = 2 * (m["d"] * m["E"] + m["k"] * 2 * m["d"] * m["f"] + 2 * m["d"] * m["fs"])
    attn = 2 * m["d"] * m["hd"] * (2 * m["H"] + 2 * m["Hkv"])
    return m["nM"] * mamba + m["nE"] * moe + m["nA"] * attn


def prefill_flops(conf: dict, B: int, S: int) -> float:
    """Model FLOPs of one prefill of [B, S] (the unembedding at the last
    position only, as the engine computes it)."""
    calls = kernel_calls(conf, B, S)
    attn = sum(k2_call(*c)[0] for c in calls["k2"])
    scan = sum(k3_call(*c)[0] for c in calls["k3"])
    unembed = 2 * B * conf["hidden_size"] * conf["vocab_size"]
    return B * S * _token(dims(conf)) + attn + scan + unembed


def decode_flops(conf: dict, B: int, pos: int) -> float:
    """Model FLOPs of one decode step of B tokens at position ``pos`` (the
    step attends to pos + 1 positions): k routed experts a token, as the
    model needs, whatever the dropless step computes."""
    m = dims(conf)
    T = pos + 1
    scan = m["nM"] * 4 * m["Hs"] * m["N"] * m["P"]          # state update and C·h
    attn = m["nA"] * 2 * 2 * m["H"] * m["hd"] * T
    unembed = 2 * B * m["d"] * m["V"]
    return B * (_token(m) + scan + attn) + unembed
