"""The port's xLSTM (``repro_torch.models.xlstm`` and the xlstm branches
of ``models.model``) against the JAX package's, on the CPU.

The blocks get the same numpy inputs and weights in both packages, in
fp32: the chunked mLSTM against its step recurrence and the sLSTM forward
against its decode, as ``tests/test_models.py:120-152`` check the
reference (atol 2e-4, the reference's own), and each function against the
reference's counterpart (atol 2e-5: the two sum in another order).  The
smoke model (3 layers, an sLSTM at layer 1) runs in fp32 with the
reference's own weights (``params_from_jax``): forward, prefill (logits and
every state of the cache) and one decode step within 1e-4·(1 + max|ref|),
as ``tests/test_torch_models.py`` holds the other families; then
prefill + decode equals the forward's last logits on both packages, at
``tests/test_models.py:70-97``'s 1e-2·(1 + max|logits|).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import unbox
from repro.models import xlstm as JX
from repro.models.common import KeyGen
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models import xlstm as TX
from repro_torch.models.convert import params_from_jax, params_to_jax

ARCH = "xlstm-1.3b"


def _np(seed, *shape, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, atol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    err = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max()
    assert err <= atol, err


def _load(module, tree):
    """The reference's block parameters (fp32 numpy) into a port block."""
    module.load_state_dict({k: v.float() for k, v in
                            params_from_jax(jax.device_get(tree)).items()})
    return module


def _mlstm(d=16, H=4, seed=5):
    tree = unbox(JX.mlstm_init(KeyGen(jax.random.PRNGKey(seed)), d, H, expand=2))
    tree = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), tree)
    return tree, _load(TX.MLSTM(None, d, H, 2), tree)


def _slstm(d=16, H=4, seed=7):
    tree = unbox(JX.slstm_init(KeyGen(jax.random.PRNGKey(seed)), d, H))
    tree = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), tree)
    return tree, _load(TX.SLSTM(None, d, H), tree)


@pytest.mark.parametrize("S,chunk", [(12, 4), (13, 4), (8, 16)])
def test_mlstm_chunked_equals_recurrent(S, chunk):
    """The chunked form (ragged last chunk included: S 13 pads 3 neutral
    steps) against the step recurrence on the port, and both against the
    reference's."""
    d, H = 16, 4
    tree, p = _mlstm(d, H)
    x = _np(6, 2, S, d)
    with torch.no_grad():
        y, (C, n) = TX.mlstm_forward(p, torch.from_numpy(x), H, chunk=chunk,
                                     return_state=True)
        Dh = 2 * d // H
        Cs, ns = torch.zeros(2, H, Dh, Dh), torch.zeros(2, H, Dh)
        outs = []
        for t in range(S):
            o, (Cs, ns) = TX.mlstm_decode(p, torch.from_numpy(x[:, t:t + 1]), (Cs, ns), H)
            outs.append(o)
    _close(y, torch.cat(outs, 1), 2e-4)
    _close(C, Cs, 2e-4)
    _close(n, ns, 2e-4)
    jy, (jC, jn) = JX.mlstm_forward(tree, jnp.asarray(x), H, chunk=chunk, return_state=True)
    _close(y, jy, 2e-5)
    _close(C, jC, 2e-5)
    _close(n, jn, 2e-5)
    jo, _ = JX.mlstm_decode(tree, jnp.asarray(x[:, :1]),
                                   (jnp.zeros((2, H, Dh, Dh)), jnp.zeros((2, H, Dh))), H)
    _close(outs[0], jo, 2e-5)


def test_mlstm_cell_step_matches_reference():
    B, H, D = 2, 3, 8
    q, k, v, C = _np(1, B, H, D), _np(2, B, H, D), _np(3, B, H, D), _np(4, B, H, D, D)
    lf, ig, n = -np.abs(_np(5, B, H)), np.abs(_np(6, B, H)), _np(7, B, H, D)
    want = JX.mlstm_cell_step(*(jnp.asarray(a) for a in (q, k, v, lf, ig, C, n)))
    got = TX.mlstm_cell_step(*(torch.from_numpy(a) for a in (q, k, v, lf, ig, C, n)))
    for g, w in zip(got, want):
        _close(g, w, 2e-5)


def test_slstm_forward_equals_decode():
    d, H = 16, 4
    tree, p = _slstm(d, H)
    x = _np(8, 2, 10, d)
    with torch.no_grad():
        y, state = TX.slstm_forward(p, torch.from_numpy(x), H, return_state=True)
        st = tuple(torch.zeros(2, H, d // H) for _ in range(3))
        outs = []
        for t in range(10):
            o, st = TX.slstm_decode(p, torch.from_numpy(x[:, t:t + 1]), st, H)
            outs.append(o)
    _close(y, torch.cat(outs, 1), 2e-4)
    for a, b in zip(state, st):
        _close(a, b, 2e-4)
    jy, jstate = JX.slstm_forward(tree, jnp.asarray(x), H, return_state=True)
    _close(y, jy, 2e-5)
    for a, b in zip(state, jstate):
        _close(a, b, 2e-5)


def _pair(**over):
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=torch.float32, **over)
    jmodel = JaxModel(jcfg)
    params = unbox(jmodel.init(jax.random.PRNGKey(0)))
    tmodel = Model(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    return jmodel, params, tmodel


def _tol(want):
    return 1e-4 * (1 + float(np.abs(np.asarray(want)).max()))


def test_param_count_matches_reference():
    for smoke in (True, False):
        cfg = get_config(ARCH, smoke=smoke)
        assert cfg.param_count() == jax_get_config(ARCH, smoke=smoke).param_count()
    cfg = get_config(ARCH, smoke=True)
    assert cfg.param_count() == sum(p.numel() for p in Model(cfg, device="cpu").parameters())
    full = get_config(ARCH)
    assert [i for i in range(full.n_layers) if full.is_slstm(i)] == [1, 9, 17, 25, 33, 41]


def test_xlstm_model_matches_reference():
    """Forward, prefill on all but the last token (its cache: C, n, s_h and
    pos, whatever max_len asks), one decode step on it, and prefill +
    decode against the forward's last logits on both packages."""
    jmodel, params, tmodel = _pair()
    cfg = tmodel.cfg
    B, S = 2, 24
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    ttoks = torch.from_numpy(toks).long()
    want, _ = jmodel.forward(params, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, aux = tmodel.forward({"tokens": ttoks})
    assert got.shape == (B, S, cfg.vocab) and float(aux) == 0.0
    _close(got, want, _tol(want))

    jl, jcache = jmodel.prefill(params, {"tokens": jnp.asarray(toks[:, :-1])}, max_len=S + 4)
    tl, tcache = tmodel.prefill({"tokens": ttoks[:, :-1]}, max_len=S + 4)
    _close(tl, jl, _tol(jl))
    assert set(tcache) == set(jcache) == {"C", "n", "s_h", "pos"}
    assert tcache["pos"] == int(jcache["pos"]) == S - 1
    for key in ("C", "n", "s_h"):
        assert tuple(tcache[key].shape) == jcache[key].shape
        _close(tcache[key], jcache[key], _tol(jcache[key]))

    jd, jcache = jmodel.decode(params, jcache, {"tokens": jnp.asarray(toks[:, -1:])})
    td, tcache2 = tmodel.decode(tcache, {"tokens": ttoks[:, -1:]})
    _close(td, jd, _tol(jd))
    assert tcache2["pos"] == int(jcache["pos"]) == S
    for key in ("C", "n", "s_h"):
        _close(tcache2[key], jcache[key], _tol(jcache[key]))
    # decode returns new states: the prefill cache decodes again to the same
    td_again, _ = tmodel.decode(tcache, {"tokens": ttoks[:, -1:]})
    assert torch.equal(td, td_again)
    for logits in (td, np.asarray(jd)):
        logits = np.asarray(logits)
        last = np.asarray(want)[:, -1]
        assert np.abs(logits - last).max() < 1e-2 * (1 + np.abs(last).max())


def test_decode_in_place_writes_the_states_decode_returns():
    """xlstm's one step writes into the cache it is given what ``decode``
    returns: after a prefill, ``decode_in_place`` on a clone of the cache
    gives ``decode``'s logits and its new C, n and s_h bit for bit, in the
    clone's own tensors, and leaves the prefill's cache as it was."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=torch.float32)
    model = Model(cfg, device="cpu", seed=1)
    tokens = torch.randint(1, cfg.vocab, (2, 9), generator=torch.Generator().manual_seed(3))
    _, cache = model.prefill({"tokens": tokens[:, :-1]})
    kept = {k: v.clone() for k, v in cache.items() if k != "pos"}
    nxt = {"tokens": tokens[:, -1:]}
    want, new = model.decode(cache, nxt)
    assert new["pos"] == cache["pos"] + 1
    work = {k: v.clone() for k, v in kept.items()}
    tensors = dict(work)
    got = model.decode_in_place(work, nxt, cache["pos"])
    assert torch.equal(got, want)
    for k, v in work.items():
        assert v is tensors[k] and torch.equal(v, new[k]), k
        assert not torch.equal(v, kept[k]) and torch.equal(cache[k], kept[k]), k


def test_xlstm_params_round_trip_through_the_reference_layout():
    """params_to_jax gives the reference's tree (unstacked l{i}, the same
    shapes), and params_from_jax takes it back to the same state."""
    jmodel, params, tmodel = _pair()
    tree = params_to_jax(tmodel.state_dict(), tmodel.cfg)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jax.device_get(params))
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), tree) == shapes
    back = params_from_jax(_numpy(tree))
    state = tmodel.state_dict()
    assert set(back) == set(state)
    for k, v in back.items():
        assert torch.equal(v, state[k]), k


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.float().numpy()
            for k, v in tree.items()}


def test_port_serves_same_tokens_as_reference():
    """xlstm-1.3b's smoke config through both serving engines, in fp32 with
    the same weights: six requests, three to a batch, identical greedy
    tokens per request id.  Prefill ignores max_len (the state is O(1))."""
    from repro.core import Triggerflow as RefTriggerflow
    from repro.serving.engine import ServingEngine as RefServingEngine
    from repro_torch.core import Triggerflow
    from repro_torch.serving.engine import ServingEngine

    ref = RefServingEngine(
        dataclasses.replace(jax_get_config(ARCH, smoke=True), dtype=jnp.float32),
        RefTriggerflow(inline_functions=True), "srv-x", max_batch=3, max_new_tokens=3,
        max_len=48)
    port = ServingEngine(
        dataclasses.replace(get_config(ARCH, smoke=True), dtype=torch.float32),
        Triggerflow(inline_functions=True, device="cpu"), "srv-x", max_batch=3,
        max_new_tokens=3, max_len=48)
    port.model.load_state_dict(params_from_jax(jax.device_get(ref.params)), strict=True)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 256, int(rng.integers(5, 41))).tolist() for _ in range(6)]
    served = []
    for eng in (ref, port):
        eng.deploy()
        for i, p in enumerate(prompts):
            eng.submit(f"r{i}", p)
        w = eng.tf.worker(eng.workflow)
        for _ in range(30):
            w.run_once()
        served.append({e.data["result"]["id"]: e.data["result"]["tokens"]
                       for e in w.event_log if e.subject.startswith("serve|done|")})
    assert ref.batches == port.batches == 2
    assert len(served[1]) == 6 and served[1] == served[0]


def test_chunk_where_the_reference_overflows():
    """A chunk of 128 steps whose forget gates sum to about -128 in log
    space: the reference's exp(L_i - L_j) overflows above the diagonal and
    its mask turns inf into NaN; the port masks the exponent before the
    exp, stays finite and equals its step recurrence.  At S 64 (the
    chunk's sum about -64) both are finite and agree."""
    B, H, D = 1, 2, 8
    for S, finite_ref in ((128, False), (64, True)):
        q, k, v = _np(1, B, S, H, D), _np(2, B, S, H, D), _np(3, B, S, H, D)
        log_f = np.full((B, S, H), -1.0, np.float32)
        ig = np.full((B, S, H), 0.5, np.float32)
        jy, _ = JX._mlstm_chunked(*(jnp.asarray(a) for a in (q, k, v, log_f, ig)), 128)
        ty, (C, n) = TX._mlstm_chunked(*(torch.from_numpy(a) for a in (q, k, v, log_f, ig)), 128)
        assert bool(np.isfinite(np.asarray(jy)).all()) == finite_ref
        assert torch.isfinite(ty).all()
        if finite_ref:
            _close(ty, jy, 2e-5)
        Cs, ns = torch.zeros(B, H, D, D), torch.zeros(B, H, D)
        outs = []
        for t in range(S):
            o, Cs, ns = TX.mlstm_cell_step(*(torch.from_numpy(a[:, t]) for a in
                                             (q, k, v, log_f, ig)), Cs, ns)
            outs.append(o)
        _close(ty, torch.stack(outs, 1), 2e-4)
        _close(C, Cs, 2e-4)
