"""The port's Multi-head Latent Attention against the JAX package's, on the
CPU: the prefill path that expands the latent into full K/V, and the
absorbed decode, on the same fp32 numpy weights and inputs.  Tolerance
2e-5·(1 + max|ref|): fp32, another summation order.  Past the cache the two
differ by design: the reference clamps the write onto the last slot, the
port raises.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mla as REF
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import layers
from repro_torch.models import mla as MLA

B, D, H, QL, KVL, NOPE, ROPE, V = 2, 32, 4, 24, 16, 16, 8, 12


def _weights(seed):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) * shape[0] ** -0.5).astype(np.float32)
    return {"wdq": w(D, QL), "q_norm": {"w": 1 + 0.1 * w(QL)},
            "wuq": w(QL, H, NOPE + ROPE), "wdkv": w(D, KVL),
            "kv_norm": {"w": 1 + 0.1 * w(KVL)}, "wuk": w(KVL, H, NOPE),
            "wuv": w(KVL, H, V), "wkr": w(D, ROPE), "wo": w(H, V, D)}


def _pair(seed=0):
    w = _weights(seed)
    jw = {k: ({"w": jnp.asarray(v["w"])} if isinstance(v, dict) else jnp.asarray(v))
          for k, v in w.items()}
    p = MLA.MLA(torch.Generator().manual_seed(0), D, H, QL, KVL, NOPE, ROPE, V).float()
    p.load_state_dict({(f"{k}.w" if isinstance(v, dict) else k):
                       torch.from_numpy(v["w"] if isinstance(v, dict) else v)
                       for k, v in w.items()}, strict=True)
    return jw, p


def _close(got, want):
    want = np.asarray(want)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= 2e-5 * (1 + np.abs(want).max()), err


@pytest.mark.parametrize("S,chunk", [(16, 16), (24, 8)])
def test_mla_forward_matches_reference(S, chunk):
    jw, p = _pair()
    x = np.random.default_rng(S).standard_normal((B, S, D)).astype(np.float32)
    want, (ckv, kr) = REF.mla_forward(jw, jnp.asarray(x), jnp.arange(S), NOPE, ROPE,
                                      q_chunk=chunk, kv_chunk=chunk, return_cache=True)
    got, (tckv, tkr) = MLA.mla_forward(p, torch.from_numpy(x), torch.arange(S), NOPE, ROPE,
                                       q_chunk=chunk, kv_chunk=chunk)
    assert got.shape == (B, S, D) and tckv.shape == (B, S, KVL) and tkr.shape == (B, S, ROPE)
    _close(got, want)
    _close(tckv, ckv)
    _close(tkr, kr)


def _caches(seed, T, S):
    """A cache of length T holding the latent of S prompt positions."""
    rng = np.random.default_rng(seed)
    ckv = np.zeros((B, T, KVL), np.float32)
    kr = np.zeros((B, T, ROPE), np.float32)
    ckv[:, :S] = rng.standard_normal((B, S, KVL))
    kr[:, :S] = rng.standard_normal((B, S, ROPE))
    return ckv, kr


@pytest.mark.parametrize("T,pos", [(8, 0), (8, 5), (8, 7)])
def test_absorbed_decode_matches_reference(T, pos):
    jw, p = _pair(1)
    ckv, kr = _caches(2, T, pos)
    x = np.random.default_rng(3).standard_normal((B, 1, D)).astype(np.float32)
    want, jckv, jkr = REF.mla_decode(jw, jnp.asarray(x), jnp.asarray(ckv), jnp.asarray(kr),
                                     pos, NOPE, ROPE)
    tckv, tkr = torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy())
    got, nckv, nkr = MLA.mla_decode(p, torch.from_numpy(x), tckv, tkr, pos, NOPE, ROPE)
    assert nckv is tckv and nkr is tkr          # written in place
    _close(got, want)
    _close(tckv, jckv)
    _close(tkr, jkr)


def test_absorbed_decode_equals_the_expanded_forward():
    """Decode at position S-1 over the forward's own latent cache gives the
    forward's last output: absorbing W_uk and W_uv changes only the order of
    the products."""
    jw, p = _pair(4)
    S = 12
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((B, S, D)).astype(np.float32))
    full, (ckv, kr) = MLA.mla_forward(p, x, torch.arange(S), NOPE, ROPE)
    cache_ckv = torch.zeros(B, S, KVL)
    cache_kr = torch.zeros(B, S, ROPE)
    cache_ckv[:, :S - 1], cache_kr[:, :S - 1] = ckv[:, :S - 1], kr[:, :S - 1]
    got, _, _ = MLA.mla_decode(p, x[:, -1:], cache_ckv, cache_kr, S - 1, NOPE, ROPE)
    err = (got[:, 0] - full[:, -1]).abs().max().item()
    assert err <= 1e-5 * (1 + full[:, -1].abs().max().item()), err


def test_decode_past_the_cache_clamps_in_the_reference_and_raises_in_the_port():
    """At pos >= the cache length the reference's mla_decode writes the
    latent with dynamic_update_slice, which clamps the start: it overwrites
    the last slot and returns finite outputs without an error.  The port
    raises ValueError and leaves the cache as it was.  One slot earlier both
    write the last slot and agree."""
    T = 6
    jw, p = _pair(6)
    ckv, kr = _caches(7, T, T)
    x = np.random.default_rng(8).standard_normal((B, 1, D)).astype(np.float32)
    for pos in (T - 1, T, T + 3):
        want, jckv, jkr = REF.mla_decode(jw, jnp.asarray(x), jnp.asarray(ckv),
                                         jnp.asarray(kr), pos, NOPE, ROPE)
        assert np.isfinite(np.asarray(want)).all()
        np.testing.assert_array_equal(np.asarray(jckv)[:, :T - 1], ckv[:, :T - 1])
        assert not np.array_equal(np.asarray(jckv)[:, T - 1], ckv[:, T - 1])
        tckv, tkr = torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy())
        if pos < T:
            got, _, _ = MLA.mla_decode(p, torch.from_numpy(x), tckv, tkr, pos, NOPE, ROPE)
            _close(got, want)
            _close(tckv, jckv)
        else:
            with pytest.raises(ValueError, match="past the cache"):
                MLA.mla_decode(p, torch.from_numpy(x), tckv, tkr, pos, NOPE, ROPE)
            assert np.array_equal(tckv.numpy(), ckv) and np.array_equal(tkr.numpy(), kr)


def test_prefill_qkv_take_the_sm90_route(monkeypatch):
    """The q, k and v that mla_forward hands to attention at deepseek-v2's
    head dims (nope 128 + rope 64, v 128), in bf16, take K2's sm90 route and
    meet its TMA conditions: torch.cat gives contiguous [B,S,H,192] q and k.
    On the CPU attention calls attention_chunked where the card calls
    flash_attention, with the same tensors."""
    seen = []
    real = layers.attention_chunked
    monkeypatch.setattr(layers, "attention_chunked",
                        lambda q, k, v, **kw: seen.append((q, k, v)) or real(q, k, v, **kw))
    gen = torch.Generator().manual_seed(0)
    d_model, heads, S = 64, 2, 24
    p = MLA.MLA(gen, d_model, heads, q_lora=32, kv_lora=16)
    x = torch.randn(B, S, d_model, generator=gen).to(torch.bfloat16)
    out, _ = MLA.mla_forward(p, x, torch.arange(S))
    (q, k, v), = seen
    assert q.shape == k.shape == (B, S, heads, 192) and v.shape == (B, S, heads, 128)
    assert q.dtype == k.dtype == v.dtype == torch.bfloat16
    assert fa_ops.route(q, k, v) == "sm90"
    fa_ops.tma_check(q, k, v)
    assert out.shape == (B, S, d_model) and torch.isfinite(out.float()).all()
