"""The sm90 route of the port's flash_attention (K2) on the CPU: its plain
version against the JAX package's kernel, the route rule, and the TMA
conditions the wrapper checks before a launch.

The sm90 kernel (``csrc/flash_attention_sm90.cu``) multiplies P·V on the
bf16 tensor cores, where the TPU kernel keeps p = exp(s - m) in fp32.  It
feeds p in as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi).  Its plain
version, ``flash_attention_torch(..., p_split=True, block_k=128)``, forms the
same terms; here it runs against the Pallas kernel in interpret mode on the
same numpy inputs.  Tolerance, derived: p - hi is exact in fp32 and at most
2**-8 p; rounding it to bf16 (an 8-bit significand) errs by at most 2**-8 of
it, so hi + lo is p within 2**-16 p.  o is the convex combination
sum_i p_i v_i / l, with l the sum of the fp32 p, so the split moves o by at
most 2**-16 max|v|, a term that also covers the fp32 summation order of
the two sides.  Both outputs are then rounded to bf16: one ulp, at most
2**-7 |want|.  So |got - want| <= 2**-7 |want| + 2**-16 max|v|.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (BLOCK_K, SM90_BLOCK_K,
                                                     flash_attention_torch)
from repro_torch.models import layers

SM90_CASES = [  # B, S, Hq, Hkv, D, Dv, causal
    (1, 1000, 6, 2, 128, 128, True),    # G 3 (as llama3.2-3b), ragged at 128
    (1, 1000, 2, 2, 64, 64, False),     # G 1 (as zamba2-1.2b), ragged, non-causal
    (1, 1000, 3, 1, 64, 64, True),      # G 3 at D 64, ragged
    (2, 256, 3, 1, 128, 128, False),    # G 3, non-causal, two full tiles
    (1, 384, 4, 4, 64, 64, True),       # G 1, causal
    (2, 200, 2, 2, 128, 128, True),     # G 1 at D 128, ragged
    # deepseek-v2's expanded MLA: q and k of nope 128 + rope 64, v of 128
    (1, 1000, 2, 2, 192, 128, True),    # G 1 (as deepseek-v2), ragged
    (1, 1000, 2, 2, 192, 128, False),   # G 1, ragged, non-causal
    (2, 256, 4, 4, 192, 128, False),    # G 1, non-causal, two full tiles
    (1, 300, 6, 2, 192, 128, True),     # G 3, ragged
    (2, 64, 2, 2, 192, 128, True),      # G 1, S below one tile
]


def _inputs(B, S, Hq, Hkv, D, Dv, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, Dv))]
    if dtype == torch.bfloat16:
        arrs = [a.astype(ml_dtypes.bfloat16) for a in arrs]
    return arrs, [torch.from_numpy(a.astype(np.float32)).to(dtype) for a in arrs]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,Dv,causal", SM90_CASES)
def test_sm90_plain_matches_pallas(B, S, Hq, Hkv, D, Dv, causal):
    (qn, kn, vn), (q, k, v) = _inputs(B, S, Hq, Hkv, D, Dv, torch.bfloat16, S + D + Hq)
    want = np.asarray(jax_flash(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                                causal=causal, interpret=True), np.float32)
    assert ops.route(q, k, v) == "sm90"
    got = flash_attention_torch(q, k, v, causal=causal, p_split=True,
                                block_k=SM90_BLOCK_K)
    assert got.shape == (B, S, Hq, Dv) and got.dtype == torch.bfloat16
    tol = 2.0 ** -7 * np.abs(want) + 2.0 ** -16 * np.abs(vn.astype(np.float32)).max()
    assert (np.abs(got.float().numpy() - want) <= tol).all()
    # on CPU tensors the wrapper runs the plain version of the route the
    # inputs take on the card, bit for bit
    assert torch.equal(ops.flash_attention(q, k, v, causal=causal), got)


def test_p_split_off_is_unchanged():
    """p_split=False keeps p in fp32 over tiles of 32, as before the sm90
    route; the split is not a no-op, and a single bf16 rounding of p would
    be far coarser than the split."""
    _, (q, k, v) = _inputs(1, 200, 4, 2, 64, 64, torch.bfloat16, 3)
    base = flash_attention_torch(q, k, v)
    assert torch.equal(base, flash_attention_torch(q, k, v, p_split=False, block_k=BLOCK_K))
    split = flash_attention_torch(q, k, v, p_split=True)
    assert not torch.equal(base, split)
    # in fp32 the split moves o by at most 2**-16 max|v|
    qf, kf, vf = q.float(), k.float(), v.float()
    exact = flash_attention_torch(qf, kf, vf)
    assert (flash_attention_torch(qf, kf, vf, p_split=True) - exact).abs().max() \
        <= 2.0 ** -16 * vf.abs().max()
    # the scalar route's plain version is still the default
    assert ops.route(qf, kf, vf) == "scalar"
    assert torch.equal(ops.flash_attention(qf, kf, vf), exact)


@pytest.mark.parametrize("dtype,D,Dv,want", [
    (torch.bfloat16, 64, 64, "sm90"),
    (torch.bfloat16, 128, 128, "sm90"),
    (torch.float32, 64, 64, "scalar"),
    (torch.float32, 128, 128, "scalar"),
    (torch.bfloat16, 32, 32, "scalar"),
    (torch.bfloat16, 256, 256, "scalar"),
    (torch.bfloat16, 192, 128, "sm90"),      # deepseek-v2's MLA prefill
    (torch.float32, 192, 128, "scalar"),
    (torch.bfloat16, 192, 192, "scalar"),    # only the pairs the kernel takes
    (torch.bfloat16, 128, 192, "scalar"),
    (torch.bfloat16, 192, 64, "scalar"),
    (torch.bfloat16, 128, 64, "scalar"),
])
def test_route_rule(dtype, D, Dv, want):
    q = torch.zeros(1, 8, 4, D, dtype=dtype)
    k = torch.zeros(1, 8, 2, D, dtype=dtype)
    v = torch.zeros(1, 8, 2, Dv, dtype=dtype)
    assert ops.route(q, k, v) == want
    assert ops.PLAIN_ARGS[want] == ({"p_split": True, "block_k": SM90_BLOCK_K}
                                    if want == "sm90" else {})


def test_tma_check():
    B, S, H, D = 2, 16, 4, 64
    q = torch.zeros(B, S, H, D, dtype=torch.bfloat16)
    ops.tma_check(q, q, q)
    # a dim of size 1 may carry any stride: it is never stepped
    one = torch.zeros(1, S, 1, D, dtype=torch.bfloat16)
    ops.tma_check(one, one.transpose(0, 2), one)
    # q sliced at an odd element offset: the base is 2 bytes off
    flat = torch.zeros(B * S * H * D + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        ops.tma_check(flat[1:].view(B, S, H, D), q, q)
    # heads 65 elements apart: 130 bytes, not a multiple of 16
    wide = torch.zeros(B, S, H, D + 1, dtype=torch.bfloat16)[..., :D]
    with pytest.raises(ValueError, match="stride"):
        ops.tma_check(q, wide, q)
    # the last dim strided
    with pytest.raises(ValueError, match="contiguous"):
        ops.tma_check(q, q, torch.zeros(B, S, H, 2 * D, dtype=torch.bfloat16)[..., ::2])


def test_sm90_launcher_takes_only_its_route_on_cuda():
    q = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="device"):
        ops.flash_attention_sm90(q, q, q)
    with pytest.raises(ValueError, match="device"):
        ops.flash_attention_scalar(q, q, q)


@pytest.mark.parametrize("n_heads,n_kv,head_dim", [(6, 2, 128), (4, 4, 64)])
def test_model_qkv_meet_tma_conditions(monkeypatch, n_heads, n_kv, head_dim):
    """The q, k and v that models.layers.gqa_forward hands to attention
    (einsum, then RoPE on q and k) take the sm90 route and meet its TMA
    conditions.  On the CPU gqa_forward calls attention_chunked where the
    card calls flash_attention, with the same tensors."""
    seen = []
    real = layers.attention_chunked
    monkeypatch.setattr(layers, "attention_chunked",
                        lambda q, k, v, **kw: seen.append((q, k, v)) or real(q, k, v, **kw))
    gen = torch.Generator().manual_seed(0)
    d_model, S = 96, 24
    p = layers.GQA(gen, d_model, n_heads, n_kv, head_dim)
    x = torch.randn(2, S, d_model, generator=gen).to(torch.bfloat16)
    cos, sin = layers.rope_angles(torch.arange(S), head_dim)
    layers.gqa_forward(p, x, cos, sin)
    (q, k, v), = seen
    assert ops.route(q, k, v) == "sm90"
    ops.tma_check(q, k, v)
