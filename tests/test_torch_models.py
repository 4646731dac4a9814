"""The port's model stack against the JAX package's, on the CPU.

Layers get the same numpy inputs in both packages (fp32, atol 2e-5: the
two sum in another order).  Each dense arch, and each arch of the vlm,
audio, moe and mla_moe families, runs at its smoke config in fp32 with the
reference's own weights (``params_from_jax``); forward, prefill (logits and
cache) and one decode step must agree within 1e-4·(1 + max|ref|), the
summation-order slack of XLA-CPU against torch over a few layers.  The
routing families' experts and dropped token-slots must be equal exactly,
in prefill and in decode.
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
FAMILIES = ("vlm", "audio", "moe", "mla_moe")
OTHER_FAMILIES = [a for a in ARCHS if get_config(a).family in FAMILIES]
ROUTED = [a for a in ARCHS if get_config(a).family in ("moe", "mla_moe")]


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
def _pair(arch, **over):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32,
                               **{k: v for k, v in over.items()
                                  if k not in ("scan_layers", "remat")})
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


def _batch(cfg, B, S, seed=0):
    """Seeded numpy inputs for both packages: tokens [B,S] (audio: [B,K,S]);
    vlm: patch embeddings at positions [3, 3 + n_patches) and positions3,
    (t, h, w), a grid over the patches as Qwen2-VL lays an image out."""
    rng = np.random.default_rng(seed)
    shape = (B, cfg.codebooks, S) if cfg.family == "audio" else (B, S)
    batch = {"tokens": rng.integers(0, cfg.vocab, shape).astype(np.int32)}
    if cfg.family == "vlm":
        P = cfg.n_patches
        batch["patch_embeds"] = rng.standard_normal((B, P, cfg.d_model)).astype(np.float32)
        batch["patch_positions"] = np.tile(np.arange(3, 3 + P)[None], (B, 1)).astype(np.int32)
        pos3 = np.tile(np.arange(S)[None, :, None], (B, 1, 3))
        side = int(P ** 0.5)
        grid = np.arange(P)
        pos3[:, 3:3 + P] = 3 + np.stack([np.zeros(P), grid // side, grid % side], -1)
        pos3[:, 3 + P:] = 3 + side + np.arange(S - 3 - P)[:, None]
        batch["positions3"] = pos3.astype(np.int32)
    return batch


def _to(batch, pkg, S=None):
    """The batch for one package, its sequence axes cut to S."""
    out = {}
    for k, v in batch.items():
        if S is not None and k in ("tokens", "positions3"):
            v = v[..., :S] if k == "tokens" else v[:, :S]
        out[k] = jnp.asarray(v) if pkg == "jax" else (
            torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v))
    return out


@pytest.mark.parametrize("arch", OTHER_FAMILIES)
def test_family_matches_reference(arch):
    """tests/test_models.py:69-97 on the port, against the reference, at
    capacity_factor 8.0: forward (audio's logits [B,S,K,V]; vlm with patch
    embeddings, their positions and positions3), param_count, prefill on
    all but the last token (logits and cache), one decode step on it."""
    jmodel, params, tmodel = _pair(arch, capacity_factor=8.0)
    cfg = tmodel.cfg
    B, S = 2, 24
    batch = _batch(cfg, B, S)
    assert cfg.param_count() == jmodel.cfg.param_count()
    assert cfg.param_count() == sum(p.numel() for p in tmodel.parameters())

    want, want_aux = jmodel.forward(params, _to(batch, "jax"))
    with torch.no_grad():
        got, aux = tmodel.forward(_to(batch, "torch"))
    heads = (cfg.codebooks,) if cfg.family == "audio" else ()
    assert got.shape == (B, S, *heads, cfg.vocab)
    _close(got, want, _tol(want))
    _close(aux, want_aux, _tol(want_aux))
    assert (float(aux) > 0) == (cfg.family in ("moe", "mla_moe"))

    jl, jcache = jmodel.prefill(params, _to(batch, "jax", S - 1), max_len=S + 4)
    tl, tcache = tmodel.prefill(_to(batch, "torch", S - 1), max_len=S + 4)
    assert tl.shape == (B, *heads, cfg.vocab)
    _close(tl, jl, _tol(jl))
    assert tcache["pos"] == int(jcache["pos"]) == S - 1
    keys = ("ckv", "kr") if cfg.family == "mla_moe" else ("k", "v")
    assert set(tcache) == set(jcache) == {*keys, "pos"}
    for key in keys:
        assert tuple(tcache[key].shape) == jcache[key].shape
        _close(tcache[key], jcache[key], _tol(jcache[key]))

    last = {"tokens": batch["tokens"][..., -1:]}
    jd, jcache = jmodel.decode(params, jcache, _to(last, "jax"))
    td, tcache = tmodel.decode(tcache, _to(last, "torch"))
    assert td.shape == (B, *heads, cfg.vocab)
    _close(td, jd, _tol(jd))
    assert tcache["pos"] == int(jcache["pos"]) == S
    for key in keys:
        _close(tcache[key], jcache[key], _tol(jcache[key]))
    if "positions3" not in batch:
        # decode at position S-1 gives the full forward's last logits (the
        # reference's decode puts vlm tokens at (pos, pos, pos), which the
        # grid of positions3 does not)
        err = float((td - got[:, -1]).abs().max())
        assert err < 1e-2 * (1 + float(got[:, -1].abs().max())), err


@pytest.mark.parametrize("arch", ROUTED)
def test_routing_matches_reference_in_prefill_and_decode(arch, monkeypatch):
    """The experts every token-slot picks and the token-slots dropped, layer
    by layer, in prefill and in a decode step at batch 2, at the config's
    own capacity factor: exactly the reference's.  The reference runs its
    layers unstacked and without remat, so its moe_forward runs eagerly and
    tests/test_torch_moe.py's spy reads its routing.  Decode at batch 2
    routes T = 2 tokens, cap 1: phi3.5-moe's smoke config (4 experts, top-2)
    then drops slots in both packages."""
    from test_torch_moe import _Spy

    import repro.models.moe as REF_MOE
    from repro_torch.models import moe as MOE

    jmodel, params, tmodel = _pair(arch, scan_layers=False, remat=False)
    cfg = tmodel.cfg
    B, S = 2, 20
    batch = _batch(cfg, B, S, seed=1)

    def reference(fn):
        spy = _Spy(("argsort", "concatenate", "take"))
        with monkeypatch.context() as m:
            m.setattr(REF_MOE, "jnp", spy)
            out = fn()
        routes = []
        for (args, _), (_, offsets), (_, token_slot) in zip(
                spy.calls["argsort"], spy.calls["concatenate"], spy.calls["take"][::3]):
            flat_e = np.asarray(args[0])
            counts = np.diff(np.append(np.asarray(offsets), flat_e.size))
            token_slot = np.asarray(token_slot)
            kept = token_slot[np.arange(token_slot.shape[1])[None] < counts[:, None]]
            routes.append((flat_e.reshape(-1, cfg.top_k),
                           np.setdiff1d(np.arange(flat_e.size), kept)))
        return out, routes

    def port(fn):
        seen = []
        real = MOE.route

        def recorded(*args, **kw):
            r = real(*args, **kw)
            seen.append((r.top_e.numpy(), np.flatnonzero(~r.kept.numpy().reshape(-1))))
            return r
        with monkeypatch.context() as m:
            m.setattr(MOE, "route", recorded)
            out = fn()
        return out, seen

    (_, jcache), want = reference(
        lambda: jmodel.prefill(params, _to(batch, "jax", S - 1), max_len=S))
    (_, tcache), got = port(lambda: tmodel.prefill(_to(batch, "torch", S - 1), max_len=S))
    last = {"tokens": batch["tokens"][..., -1:]}
    _, want_dec = reference(lambda: jmodel.decode(params, jcache, _to(last, "jax")))
    _, got_dec = port(lambda: tmodel.decode(tcache, _to(last, "torch")))
    n_moe = cfg.n_layers - (cfg.family == "mla_moe")
    assert len(want) == len(got) == len(want_dec) == len(got_dec) == n_moe
    for (te, td), (we, wd) in zip(got + got_dec, want + want_dec):
        np.testing.assert_array_equal(te, we)
        np.testing.assert_array_equal(td, wd)
    if cfg.family == "moe":
        assert sum(d.size for _, d in got_dec) > 0     # decode drops, as in the reference


@pytest.mark.parametrize("arch", ["llama3.2-3b", "zamba2-1.2b", "deepseek-v2-236b"])
def test_model_decode_past_the_cache_raises(arch):
    """``Model.decode`` at ``pos == max_len`` (a dense, a hybrid and an
    mla_moe smoke model) raises ValueError before it writes anything:
    every tensor of the cache is left as it was.  One step earlier it
    decodes."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32)
    model = Model(cfg, device="cpu", seed=1)
    tokens = torch.randint(1, cfg.vocab, (2, 6), generator=torch.Generator().manual_seed(2))
    logits, cache = model.prefill({"tokens": tokens}, max_len=8)
    tok = logits.argmax(-1)[:, None]
    _, cache = model.decode({**cache, "pos": 7}, {"tokens": tok})
    kept = {k: v.clone() for k, v in cache.items() if k != "pos"}
    assert cache["pos"] == 8
    with pytest.raises(ValueError, match="decode position 8 is past the cache length 8"):
        model.decode(cache, {"tokens": tok})
    for k, v in kept.items():
        assert torch.equal(cache[k], v), k


def test_other_families_raise():
    """Every family of ARCHS is ported: each smoke config builds, with the
    parameters its param_count counts, and a family outside them raises."""
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        model = Model(cfg, device="cpu")
        assert cfg.param_count() == sum(p.numel() for p in model.parameters()), arch
    with pytest.raises(NotImplementedError, match="not one of"):
        Model(dataclasses.replace(get_config(ARCHS[0], smoke=True), family="rnn"),
              device="cpu")
