"""The hybrid family (zamba2) as the benchmark reads it: the port's
``ModelConfig`` for a configuration file, how the benchmark draws each
parameter, the K2 and K3 calls and the FLOPs of a prefill and of a decode
step, and a configuration at CPU size.

The counts follow the engine's semantics: prompts are left-padded to the
batch's longest and the pads are attended and scanned, so every padded
position is work.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from benchlib.counts import k2_call, k3_call

SMOKE = {
    "name": "zamba2-smoke", "family": "hybrid", "hidden_size": 64, "num_hidden_layers": 4,
    "mamba_d_state": 16, "mamba_headdim": 16, "mamba_expand": 2, "mamba_d_conv": 4,
    "shared_block_every": 2, "num_attention_heads": 4, "num_key_value_heads": 4,
    "shared_block_head_dim": 16, "intermediate_size": 128, "vocab_size": 256,
    "rms_norm_eps": 1e-5, "rope_theta": 10000, "ssd_chunk": 16, "assumed": {},
}

# a row's logits depend on that row alone, so the check may compute any
# subset of a batch's rows together
ROWS_INDEPENDENT = True


def model_config(conf: dict):
    """The port's ``ModelConfig`` for a configuration file.  Raises where
    the file asks for something the port cannot run as stated."""
    from repro_torch.models import ModelConfig

    eps = conf.get("rms_norm_eps", 1e-5)
    if abs(eps - 1e-5) > 1e-12:
        raise ValueError(f"{conf['name']}: the port's RMSNorm takes eps 1e-5, not {eps}")
    return ModelConfig(
        arch=conf["name"], family="hybrid", n_layers=conf["num_hidden_layers"],
        d_model=conf["hidden_size"], n_heads=conf["num_attention_heads"],
        n_kv_heads=conf["num_key_value_heads"], d_ff=conf["intermediate_size"],
        vocab=conf["vocab_size"], head_dim=conf["shared_block_head_dim"],
        rope_theta=float(conf["rope_theta"]), ssm_state=conf["mamba_d_state"],
        ssm_headdim=conf["mamba_headdim"], ssm_expand=conf["mamba_expand"],
        ssm_chunk=conf["ssd_chunk"], attn_every=conf["shared_block_every"],
        scan_layers=False)


def rule(name: str, shape: Tuple[int, ...]):
    """(kind, scale) of the parameter ``name``: kind is normal, ones,
    zeros, a_log or dt_bias.

    RMSNorm weights and Mamba2's skip are 1, the conv bias 0; Mamba2's
    ``a_log`` and ``dt_bias`` follow the published Mamba2 initialisation;
    the embedding is N(0, 0.02²); every other weight is N(0, 1/fan_in), its
    fan-in being the dims it is summed over."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "w" or leaf == "d_skip":
        return "ones", None
    if leaf == "conv_b":
        return "zeros", None
    if leaf in ("a_log", "dt_bias"):
        return leaf, None
    if name == "embed":
        return "normal", 0.02
    if leaf == "conv_w":
        return "normal", shape[0] ** -0.5
    if leaf == "wo" and len(shape) == 3:           # attention out [H, hd, d]
        return "normal", (shape[0] * shape[1]) ** -0.5
    return "normal", shape[0] ** -0.5


def hybrid_dims(conf: dict) -> dict:
    d = conf["hidden_size"]
    di = conf["mamba_expand"] * d
    L = conf["num_hidden_layers"]
    return dict(d=d, di=di, Hs=di // conf["mamba_headdim"], P=conf["mamba_headdim"],
                N=conf["mamba_d_state"], L=L, V=conf["vocab_size"],
                H=conf["num_attention_heads"], hd=conf["shared_block_head_dim"],
                f=conf["intermediate_size"], Q=conf["ssd_chunk"],
                sites=len(range(0, L, conf["shared_block_every"])))


def kernel_calls(conf: dict, B: int, S: int) -> Dict[str, List[tuple]]:
    """The K2 and K3 calls one prefill of [B, S] makes, by their shapes."""
    m = hybrid_dims(conf)
    return {"k2": [(B, S, m["H"], m["hd"], m["hd"])] * m["sites"],
            "k3": [(B, S, m["Hs"], m["P"], m["N"], m["Q"])] * m["L"]}


def _hybrid_token(m: dict) -> float:
    """FLOPs a token takes outside attention's pairs and the scan."""
    mamba = 2 * (2 * m["d"] * m["di"] + 2 * m["d"] * m["N"] + m["d"] * m["Hs"]
                 + m["di"] * m["d"]) + 2 * 4 * m["di"]
    site = 2 * (2 * m["d"] * m["d"] + 4 * m["d"] * m["H"] * m["hd"] + 3 * m["d"] * m["f"])
    return m["L"] * mamba + m["sites"] * site


def prefill_flops(conf: dict, B: int, S: int) -> float:
    """Model FLOPs of one prefill of [B, S] (the unembedding at the last
    position only, as the engine computes it)."""
    calls = kernel_calls(conf, B, S)
    attn = sum(k2_call(*c)[0] for c in calls["k2"])
    scan = sum(k3_call(*c)[0] for c in calls["k3"])
    unembed = 2 * B * conf["hidden_size"] * conf["vocab_size"]
    return B * S * _hybrid_token(hybrid_dims(conf)) + attn + scan + unembed


def decode_flops(conf: dict, B: int, pos: int) -> float:
    """Model FLOPs of one decode step of B tokens at position ``pos`` (the
    step attends to pos + 1 positions)."""
    T = pos + 1
    unembed = 2 * B * conf["hidden_size"] * conf["vocab_size"]
    m = hybrid_dims(conf)
    scan = m["L"] * 4 * m["Hs"] * m["N"] * m["P"]              # state update and C·h
    attn = m["sites"] * 2 * 2 * m["H"] * m["hd"] * T
    return B * (_hybrid_token(m) + scan + attn) + unembed
