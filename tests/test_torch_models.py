"""The port's dense model stack against the JAX package's, on the CPU.

Layers get the same numpy inputs in both packages (fp32, atol 2e-5: the
two sum in another order).  Each dense arch runs at its smoke config in fp32
with the reference's own weights (``params_from_jax``); forward, prefill
(logits and cache) and one decode step must agree within
1e-4·(1 + max|ref|), the summation-order slack of XLA-CPU against torch
over a few layers.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import layers as JL
from repro.models import unbox
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import Model
from repro_torch.models import layers as TL
from repro_torch.models.convert import params_from_jax

DENSE = [a for a in ARCHS if get_config(a).family == "dense"]


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, atol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    err = np.abs(got - np.asarray(want, np.float32)).max()
    assert err <= atol, err


# ---------------------------------------------------------------- layers ----
def test_rms_norm_and_rope_match_reference():
    x = _np(0, 2, 10, 4, 16)
    w = _np(1, 16)
    _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           JL.rms_norm({"w": jnp.asarray(w)}, jnp.asarray(x)), 2e-5)
    for pos in (np.arange(10), np.arange(20).reshape(2, 10) + 7):
        cos, sin = TL.rope_angles(torch.from_numpy(pos), 16, 500000.0)
        jcos, jsin = JL.rope_angles(jnp.asarray(pos), 16, 500000.0)
        _close(cos, jcos, 2e-5)
        _close(sin, jsin, 2e-5)
        _close(TL.apply_rope(torch.from_numpy(x), cos, sin),
               JL.apply_rope(jnp.asarray(x), jcos, jsin), 2e-5)


# the property sweep of tests/test_models.py: S, G, chunk, causal
@pytest.mark.parametrize("S,G,qc,causal", list(itertools.product(
    [16, 24, 64], [1, 2, 4], [8, 16], [True, False])))
def test_attention_chunked_matches_reference(S, G, qc, causal):
    B, Hkv, D = 2, 2, 8
    q, k, v = _np(S, B, S, Hkv * G, D), _np(G, B, S, Hkv, D), _np(qc, B, S, Hkv, D)
    want = JL.attention_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, q_chunk=qc, kv_chunk=qc)
    got = TL.attention_chunked(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal, q_chunk=qc,
                               kv_chunk=qc)
    _close(got, want, 2e-5)
    naive = TL.attention_naive(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal)
    _close(naive, JL.attention_naive(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=causal), 2e-5)


@pytest.mark.parametrize("pos", [5, [3, 17]])
def test_attention_decode_matches_reference(pos):
    B, T, Hkv, G, D = 2, 24, 2, 3, 8
    q, kc, vc = _np(1, B, 1, Hkv * G, D), _np(2, B, T, Hkv, D), _np(3, B, T, Hkv, D)
    jpos = jnp.asarray(pos, jnp.int32) if isinstance(pos, list) else pos
    tpos = torch.tensor(pos) if isinstance(pos, list) else pos
    want = JL.attention_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jpos)
    got = TL.attention_decode(torch.from_numpy(q), torch.from_numpy(kc),
                              torch.from_numpy(vc), tpos)
    _close(got, want, 2e-5)


def test_decode_past_the_cache_clamps_in_the_reference_and_raises_in_the_port():
    """At pos >= the cache length the reference's gqa_decode writes k and v
    with dynamic_update_slice, which clamps the start: it overwrites the
    last slot and returns finite outputs without an error.  The port's
    raises ValueError instead.  One slot earlier both write the last slot
    and agree."""
    B, T, d, Hq, Hkv, D = 2, 4, 16, 4, 2, 8
    w = {"wq": _np(1, d, Hq, D) * 0.25, "wk": _np(2, d, Hkv, D) * 0.25,
         "wv": _np(3, d, Hkv, D) * 0.25, "wo": _np(4, Hq, D, d) * 0.2}
    x, ck, cv = _np(5, B, 1, d), _np(6, B, T, Hkv, D), _np(7, B, T, Hkv, D)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    p = TL.GQA(torch.Generator().manual_seed(0), d, Hq, Hkv, D)
    for k, v in w.items():
        getattr(p, k).data = torch.from_numpy(v)
    for pos in (T - 1, T, T + 3):
        jcos, jsin = JL.rope_angles(jnp.asarray([pos]), D)
        out, jk, jv = JL.gqa_decode(jw, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
                                    pos, jcos, jsin)
        _, k_new, v_new = JL.gqa_qkv(jw, jnp.asarray(x))
        k_new = JL.apply_rope(k_new, jcos, jsin)
        assert np.isfinite(np.asarray(out)).all()
        np.testing.assert_array_equal(np.asarray(jk)[:, :T - 1], ck[:, :T - 1])
        np.testing.assert_allclose(np.asarray(jk)[:, T - 1], np.asarray(k_new)[:, 0])
        np.testing.assert_allclose(np.asarray(jv)[:, T - 1], np.asarray(v_new)[:, 0])
        cos, sin = TL.rope_angles(torch.tensor([pos]), D)
        args = (torch.from_numpy(x), torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()),
                pos, cos, sin)
        if pos < T:
            got, _, _ = TL.gqa_decode(p, *args)
            _close(got, out, 2e-5)
        else:
            with pytest.raises(ValueError, match="past the cache"):
                TL.gqa_decode(p, *args)


# ----------------------------------------------------------------- models ----
def _pair(arch):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32)
    jmodel = JaxModel(jcfg)
    params = unbox(jmodel.init(jax.random.PRNGKey(0)))
    tmodel = Model(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    return jmodel, params, tmodel


def _tol(want):
    return 1e-4 * (1 + float(np.abs(np.asarray(want)).max()))


@pytest.mark.parametrize("arch", DENSE)
def test_dense_model_matches_reference(arch):
    jmodel, params, tmodel = _pair(arch)
    cfg = tmodel.cfg
    B, S = 2, 24
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    ttoks = torch.from_numpy(toks).long()
    assert cfg.param_count() == jmodel.cfg.param_count()
    assert cfg.param_count() == sum(p.numel() for p in tmodel.parameters())

    want, _ = jmodel.forward(params, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, aux = tmodel.forward({"tokens": ttoks})
    assert got.shape == (B, S, cfg.vocab) and float(aux) == 0.0
    _close(got, want, _tol(want))

    # prefill on the prefix, then one decode step on the last token
    jl, jcache = jmodel.prefill(params, {"tokens": jnp.asarray(toks[:, :-1])},
                                max_len=S + 4)
    tl, tcache = tmodel.prefill({"tokens": ttoks[:, :-1]}, max_len=S + 4)
    _close(tl, jl, _tol(jl))
    assert tcache["pos"] == int(jcache["pos"]) == S - 1
    for key in ("k", "v"):
        assert tuple(tcache[key].shape) == jcache[key].shape
        _close(tcache[key], jcache[key], _tol(jcache[key]))

    jd, jcache = jmodel.decode(params, jcache, {"tokens": jnp.asarray(toks[:, -1:])})
    td, tcache = tmodel.decode(tcache, {"tokens": ttoks[:, -1:]})
    _close(td, jd, _tol(jd))
    assert tcache["pos"] == int(jcache["pos"]) == S
    _close(tcache["k"], jcache["k"], _tol(jcache["k"]))

    # tests/test_models.py's consistency check, on the port: decode at
    # position S-1 gives the full forward's last logits
    err = float((td - got[:, -1]).abs().max())
    assert err < 1e-2 * (1 + float(got[:, -1].abs().max())), err


def test_other_families_raise():
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        if cfg.family not in ("dense", "hybrid"):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                Model(cfg, device="cpu")
