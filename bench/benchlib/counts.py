"""The yardstick's arithmetic: the card's peaks, the roofline bound of a
call (a frozen copy of ``chip_smoke.bound_ms``), the operations and bytes
of each kernel call, and a model step's FLOPs.

Every count reads only a configuration file's published sizes and the
shape of a batch the window formed, so a change that replaces a kernel is
read against the same work.  Which kernel calls a prefill makes and what a
step costs belong to the model's family: ``kernel_calls``,
``prefill_flops`` and ``decode_flops`` hand them to
``bench/families/<family>.py``, which counts with ``k2_call`` and
``k3_call`` here.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from .spec import family

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


def kernel_calls(conf: dict, B: int, S: int) -> Dict[str, List[tuple]]:
    """The kernel calls one prefill of [B, S] makes, by kernel ("k2",
    "k3") and shape: the count of the configuration's family
    (``bench/families/<family>.py``)."""
    return family(conf).kernel_calls(conf, B, S)


def prefill_flops(conf: dict, B: int, S: int) -> float:
    """Model FLOPs of one prefill of [B, S], by the configuration's family."""
    return family(conf).prefill_flops(conf, B, S)


def decode_flops(conf: dict, B: int, pos: int) -> float:
    """Model FLOPs of one decode step of B tokens at position ``pos``, by
    the configuration's family."""
    return family(conf).decode_flops(conf, B, pos)
