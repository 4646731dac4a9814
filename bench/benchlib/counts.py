"""The yardstick's arithmetic: the card's peaks, the roofline bound of a
call (a frozen copy of ``chip_smoke.bound_ms``), the operations and bytes
of each kernel call, and a model step's FLOPs.

Every count reads only a configuration file's published sizes and the
shape of a batch the window formed, so a change that replaces a kernel is
read against the same work.  The counts follow the engine's semantics:
prompts are left-padded to the batch's longest and the pads are attended
and scanned, so every padded position is work.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA's data sheet, H100 SXM, dense rates
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12,      # dense bf16 tensor cores
              "tfloat32": 494.7e12,    # dense tf32 tensor cores
              "float32": 67e12}        # fp32 outside the tensor cores


def bound_ms(n_bytes: float, n_ops: float, dtype: str):
    """The least time the card could take: (ms, "bytes" or "operations")."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_OPS_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k2_call(B: int, S: int, H: int, D: int, Dv: int) -> Tuple[float, float]:
    """(operations, bytes) of one causal flash-attention call over bf16
    q, k [B, S, H, D] and v [B, S, H, Dv]: the causal pairs only; q, k and
    v read once and the output [B, S, H, Dv] written once."""
    flops = 2 * B * H * (D + Dv) * S * (S + 1) / 2
    n_bytes = 2 * B * S * H * (2 * D + 2 * Dv)
    return flops, n_bytes


def k3_call(B: int, S: int, H: int, P: int, N: int, Q: int) -> Tuple[float, float]:
    """(operations, bytes) of one SSD scan over bf16 x [B, S, H, P] and
    B, C [B, S, N], fp32 dt [B, S, H] and a [H], in chunks of Q: per head
    and chunk of q steps, C·Bᵀ and the mixing tile times x over the causal
    pairs, C·h and the state update over all q steps; x and dt, B and C
    read once, y written once, the fp32 final state written once."""
    chunks = [min(Q, S - s0) for s0 in range(0, S, Q)]
    flops = sum(2 * (q * (q + 1) // 2 * (N + P) + 2 * q * N * P) for q in chunks) * B * H
    n_bytes = (2 * 2 * B * S * H * P + 4 * B * S * H + 2 * 2 * B * S * N
               + 4 * B * H * N * P + 4 * H)
    return flops, n_bytes


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
    if conf["family"] == "hybrid":
        m = hybrid_dims(conf)
        return {"k2": [(B, S, m["H"], m["hd"], m["hd"])] * m["sites"],
                "k3": [(B, S, m["Hs"], m["P"], m["N"], m["Q"])] * m["L"]}
    raise ValueError(f"no counts for family {conf['family']!r}")


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
