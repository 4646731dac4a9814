"""The port's flash_attention (K2) against the JAX package's.

The same numpy inputs go through the Pallas kernel in interpret mode (as
tests/test_kernels.py runs it) and through the port's wrapper, which on CPU
tensors runs the kernel's plain version.  Tolerances are the JAX test's own:
atol 3e-5 in fp32 (the two sum in another order) and 2e-2 in bf16 (one bf16
rounding of the output, whose values are O(1)).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import naive_attention as jax_naive
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_torch
from repro_torch.models.layers import attention_naive

CASES = [  # B, S, Hq, Hkv, D, Dv, dtype, causal
    (1, 64, 4, 4, 16, 16, "float32", True),     # MHA
    (2, 128, 8, 2, 32, 32, "float32", True),    # GQA 4:1
    (2, 96, 4, 1, 16, 16, "float32", True),     # MQA (granite-style kv=1)
    (1, 80, 4, 2, 16, 16, "float32", True),     # ragged seq (padding path)
    (1, 128, 4, 2, 32, 32, "bfloat16", True),   # bf16 inputs
    (1, 64, 4, 4, 16, 16, "float32", False),    # non-causal
    (2, 72, 6, 2, 16, 16, "float32", True),     # G = 3, as llama3.2-3b
    (1, 96, 4, 2, 32, 16, "float32", True),     # Dv != D
]
ATOL = {"float32": 3e-5, "bfloat16": 2e-2}


def _inputs(B, S, Hq, Hkv, D, Dv, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, Dv))]
    if dtype == "bfloat16":
        arrs = [a.astype(ml_dtypes.bfloat16) for a in arrs]
    tdtype = getattr(torch, dtype)
    return arrs, [torch.from_numpy(a.astype(np.float32)).to(tdtype) for a in arrs]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,Dv,dtype,causal", CASES)
def test_flash_attention_matches_pallas(B, S, Hq, Hkv, D, Dv, dtype, causal):
    (qn, kn, vn), (q, k, v) = _inputs(B, S, Hq, Hkv, D, Dv, dtype, B * S + Hq)
    want = jax_flash(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                     causal=causal, block_q=32, block_k=32, interpret=True)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.shape == (B, S, Hq, Dv) and got.dtype == q.dtype
    err = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
    assert err <= ATOL[dtype], err


@pytest.mark.parametrize("causal", [True, False])
def test_naive_attention_matches_reference(causal):
    (qn, kn, vn), (q, k, v) = _inputs(2, 48, 6, 2, 16, 16, "float32", 5)
    want = np.asarray(jax_naive(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                                causal=causal))
    got = attention_naive(q, k, v, causal=causal)
    assert np.abs(got.numpy() - want).max() <= 3e-5
    # and the kernel's plain version agrees with the O(S^2) oracle
    assert (flash_attention_torch(q, k, v, causal=causal) - got).abs().max() <= 3e-5


def test_flash_attention_rejects_bad_inputs():
    q = torch.zeros(1, 8, 3, 16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="dtypes"):
        ops.flash_attention(q[:, :, :2].half(), k.half(), k.half())
