"""The port's hybrid family (Mamba2 + zamba2's shared attention) against
the JAX package's, on the CPU.

The Mamba2 block gets the reference's own weights (``params_from_jax``) and
the same numpy inputs in fp32: forward, its state and conv cache, and the
single-step decode agree within atol 2e-5 (the two packages sum in another
order), and the port's chunked path equals its recurrence within
tests/test_models.py's 2e-4.  The zamba2 smoke model in fp32 agrees with the
JAX model within 1e-4·(1 + max|ref|), as tests/test_torch_models.py holds
the dense models.
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
from repro.models.common import KeyGen
from repro.models.ssm import mamba2_decode as jax_decode
from repro.models.ssm import mamba2_forward as jax_forward
from repro.models.ssm import mamba2_init
from repro_torch.configs import get_config
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax
from repro_torch.models.ssm import Mamba2, mamba2_decode, mamba2_forward


def _close(got, want, atol):
    err = np.abs(got.detach().float().numpy() - np.asarray(want, np.float32)).max()
    assert err <= atol, err


def _tol(want):
    return 1e-4 * (1 + float(np.abs(np.asarray(want)).max()))


# ----------------------------------------------------------------- Mamba2 ----
def _mamba(d=16, di=32, N=8, hd=8, seed=3):
    params = unbox(mamba2_init(KeyGen(jax.random.PRNGKey(seed)), d, di, N, hd))
    block = Mamba2(None, d, di, N, hd, device="cpu")
    block.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    x = np.random.default_rng(seed).standard_normal((2, 16, d)).astype(np.float32) * 0.5
    return params, block, x


@pytest.mark.parametrize("chunk", [4, 16])
def test_mamba2_forward_matches_reference(chunk):
    params, block, x = _mamba()
    want, (jstate, jconv) = jax_forward(params, jnp.asarray(x), chunk=chunk,
                                        return_state=True)
    got, (state, conv) = mamba2_forward(block, torch.from_numpy(x), chunk=chunk,
                                        return_state=True)
    _close(got, want, 2e-5)
    _close(state, jstate, 2e-5)
    _close(conv, jconv, 2e-5)
    _close(mamba2_forward(block, torch.from_numpy(x), chunk=chunk), want, 2e-5)


def test_mamba2_decode_matches_reference():
    """The step writes the reference's new state and conv cache into the
    tensors it is given and returns those tensors."""
    params, block, x = _mamba()
    rng = np.random.default_rng(7)
    state = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    conv = rng.standard_normal((2, 3, 32)).astype(np.float32)
    want, jstate, jconv = jax_decode(params, jnp.asarray(x[:, :1]), jnp.asarray(state),
                                     jnp.asarray(conv))
    tstate, tconv = torch.from_numpy(state).clone(), torch.from_numpy(conv).clone()
    got, new_state, new_conv = mamba2_decode(block, torch.from_numpy(x[:, :1]),
                                             tstate, tconv)
    assert new_state is tstate and new_conv is tconv
    _close(got, want, 2e-5)
    _close(tstate, jstate, 2e-5)
    _close(tconv, jconv, 2e-5)


def test_mamba2_decode_keeps_its_fp32_state_under_bf16():
    """With bf16 activations (the served dtype) the state stays the fp32
    tensor it was given, as ``Model.cache_layout`` holds it, and the step
    matches the reference's on the same bf16 weights and inputs within a
    few bf16 roundings (2**-8 relative)."""
    params, block, x = _mamba()
    bf16 = jnp.bfloat16
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, bf16), params)
    block = block.to(torch.bfloat16)
    rng = np.random.default_rng(11)
    state = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    conv = rng.standard_normal((2, 3, 32)).astype(np.float32)
    xt = torch.from_numpy(x[:, :1]).to(torch.bfloat16)
    tstate, tconv = torch.from_numpy(state).clone(), torch.from_numpy(conv).to(torch.bfloat16)
    want, jstate, jconv = jax_decode(jparams, jnp.asarray(xt.float().numpy(), bf16),
                                     jnp.asarray(state), jnp.asarray(tconv.float().numpy(), bf16))
    got, new_state, new_conv = mamba2_decode(block, xt, tstate, tconv)
    assert new_state is tstate and tstate.dtype == torch.float32
    assert new_conv is tconv and got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), 4 * 2 ** -8 * (1 + float(np.abs(want).max())))
    _close(tstate, jstate, 4 * 2 ** -8 * (1 + float(np.abs(jstate).max())))
    _close(tconv, np.asarray(jconv, np.float32), 0)


def test_mamba2_chunked_equals_recurrent():
    """tests/test_models.py's property, on the port: the chunked forward
    equals stepping the recurrence token by token."""
    params, block, x = _mamba()
    xt = torch.from_numpy(x)
    y_chunked, (state, _) = mamba2_forward(block, xt, chunk=4, return_state=True)
    st = torch.zeros(2, 4, 8, 8)
    cc = torch.zeros(2, 3, 32)
    outs = [mamba2_decode(block, xt[:, t:t + 1], st, cc)[0] for t in range(16)]
    _close(torch.cat(outs, dim=1), y_chunked.numpy(), 2e-4)
    _close(st, state.numpy(), 2e-4)


def _step_inputs(B, H, N, P, dtype, seed=5):
    gen = torch.Generator().manual_seed(seed)
    state = torch.randn(B, H, N, P, generator=gen)
    # x as mamba2_decode passes it: the conv output [B, Di] viewed [B, H, P]
    x = torch.randn(B, H * P, generator=gen).to(dtype).view(B, H, P)
    dt = torch.nn.functional.softplus(torch.randn(B, H, generator=gen))
    a = -torch.exp(torch.randn(H, generator=gen) * 0.3)
    Bm, Cm = (torch.randn(B, N, generator=gen) * 0.5 for _ in range(2))
    d_skip = torch.randn(H, generator=gen).to(torch.bfloat16)
    return state, x, dt, a, Bm, Cm, d_skip


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_step_on_the_cpu_is_its_plain_version(dtype):
    """On CPU tensors ``ssd_step`` runs ``ssd_step_plain``: the same y and
    the same new state bit for bit, the state written into the tensor it is
    given, and no kernel launch counted."""
    state, *rest = _step_inputs(3, 4, 8, 12, dtype)
    want_state = state.clone()
    want = ssd_ops.ssd_step_plain(want_state, *rest)
    before = ssd_ops.step_launches
    got = ssd_ops.ssd_step(state, *rest)
    assert got.dtype == dtype and got.shape == (3, 4, 12)
    assert torch.equal(got, want) and torch.equal(state, want_state)
    assert not torch.equal(state, _step_inputs(3, 4, 8, 12, dtype)[0])
    assert ssd_ops.step_launches == before


def test_ssd_step_refuses_what_the_kernel_does_not_take():
    """A shape the kernel cannot tile (P not a multiple of its 4-column
    loads, or past 4 columns × 256 threads), an x dtype it has no instance
    for, a state that is not fp32, or shapes that disagree raise
    ``ValueError`` on the CPU as on the card, before the state is
    touched."""
    for shape, match in (((2, 2, 4, 6), "multiple of 4"), ((1, 1, 2, 1028), "at most")):
        state, *rest = _step_inputs(*shape, torch.float32)
        kept = state.clone()
        with pytest.raises(ValueError, match=match):
            ssd_ops.ssd_step(state, *rest)
        assert torch.equal(state, kept)
    state, x, dt, a, Bm, Cm, d_skip = _step_inputs(2, 2, 4, 8, torch.float32)
    with pytest.raises(ValueError, match="x must be"):
        ssd_ops.ssd_step(state, x.half(), dt, a, Bm, Cm, d_skip)
    with pytest.raises(ValueError, match="float32"):
        ssd_ops.ssd_step(state.bfloat16(), x, dt, a, Bm, Cm, d_skip)
    with pytest.raises(ValueError, match="do not agree"):
        ssd_ops.ssd_step(state, x, dt, a, Bm[:, :3], Cm, d_skip)


@pytest.mark.parametrize("B,H,N,P", [(64, 64, 64, 64), (8, 64, 64, 64), (4, 8, 16, 16),
                                     (1, 1, 8, 8), (2, 3, 5, 1024), (1, 2, 300, 4)])
def test_ssd_step_tile_fits_the_kernel(B, H, N, P):
    """The wrapper's tile for a [B,H,N,P] state on 132 SMs: P splits into
    slices of whole 4-column loads, a block has at most 256 threads, each
    holding at most ``STEP_ROWS`` rows unless the block is full; chat's B 64
    takes one block a (b, h), longprompt's B 8 halves P to fill the card."""
    split, tn = ssd_ops.step_tile(B, H, N, P, 132)
    tp = P // split // 4
    assert P % (4 * split) == 0 and 1 <= tp * tn <= ssd_ops.STEP_THREADS
    assert tn * ssd_ops.STEP_ROWS >= N or tp * tn * 2 > ssd_ops.STEP_THREADS
    assert B * H * split >= 4 * 132 or P // split % 8
    if (B, P) == (64, 64):
        assert (split, tn) == (1, 16)
    if (B, P) == (8, 64):
        assert (split, tn) == (2, 16)


# ------------------------------------------------------------------ zamba2 ----
def _pair(arch="zamba2-1.2b"):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32)
    jmodel = JaxModel(jcfg)
    params = unbox(jmodel.init(jax.random.PRNGKey(0)))
    tmodel = Model(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    return jmodel, params, tmodel


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "llama3.2-3b"])
def test_weights_load_strict(arch):
    """The unstacked tree (zamba2: layers/l{i}, shared_proj/s{i}) and the
    stacked one (llama3.2-3b: layers/…[i]) both load with strict=True, and
    every leaf of the reference lands in the port unchanged."""
    jmodel, params, tmodel = _pair(arch)
    state = tmodel.state_dict()
    leaves = jax.tree_util.tree_leaves(params)
    assert sum(int(np.prod(leaf.shape)) for leaf in leaves) == \
        sum(t.numel() for t in state.values())
    if arch == "zamba2-1.2b":
        _close(state["layers.3.mamba.wx"], params["layers"]["l3"]["mamba"]["wx"], 0)
        _close(state["shared_proj.1"], params["shared_proj"]["s1"], 0)
    else:
        _close(state["layers.1.attn.wq"], params["layers"]["attn"]["wq"][1], 0)


def test_zamba2_matches_reference():
    jmodel, params, tmodel = _pair()
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
    for key in ("ssm", "conv", "k", "v"):
        assert tuple(tcache[key].shape) == jcache[key].shape
        _close(tcache[key], jcache[key], _tol(jcache[key]))

    jd, jcache = jmodel.decode(params, jcache, {"tokens": jnp.asarray(toks[:, -1:])})
    td, tcache2 = tmodel.decode(tcache, {"tokens": ttoks[:, -1:]})
    _close(td, jd, _tol(jd))
    assert tcache2["pos"] == int(jcache["pos"]) == S
    for key in ("ssm", "conv", "k", "v"):
        _close(tcache2[key], jcache[key], _tol(jcache[key]))

    # decode at position S-1 gives the full forward's last logits
    err = float((td - got[:, -1]).abs().max())
    assert err < 1e-2 * (1 + float(got[:, -1].abs().max())), err

    # the SSM and conv states come back new: a second decode from the same
    # prefill cache gives the same logits
    td_again, _ = tmodel.decode(tcache, {"tokens": ttoks[:, -1:]})
    assert torch.equal(td_again, td)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "llama3.2-3b"])
def test_decode_at_a_device_position_matches_decode(arch):
    """The step at a tensor ``pos`` (``Model.decode_in_place`` with a 0-d
    int64 ``pos``, as the decode graph captures it) on its own cache, for 8
    steps after a prefill, the last at ``max_len - 1``, against
    ``Model.decode`` (an int ``pos``): the same greedy tokens, logits and
    cache bit for bit; for the hybrid also against the reference's decode
    within the tolerance above."""
    jmodel, params, tmodel = _pair(arch)
    cfg = tmodel.cfg
    B, S, steps = 2, 12, 8
    max_len = S + steps
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    logits, cache = tmodel.prefill({"tokens": torch.from_numpy(toks).long()}, max_len=max_len)
    jl, jcache = jmodel.prefill(params, {"tokens": jnp.asarray(toks)}, max_len=max_len)
    static = {k: v.clone() for k, v in cache.items() if k != "pos"}
    pos = torch.zeros((), dtype=torch.int64)
    tok = logits.argmax(-1)[:, None]
    for k in range(steps):
        pos.fill_(S + k)
        got = tmodel.decode_in_place(static, {"tokens": tok}, pos)
        want, cache = tmodel.decode(cache, {"tokens": tok})
        assert torch.equal(got, want)
        assert set(static) | {"pos"} == set(cache)
        for key, v in static.items():
            assert torch.equal(v, cache[key]), key
        if cfg.family == "hybrid":
            jd, jcache = jmodel.decode(params, jcache,
                                       {"tokens": jnp.asarray(tok.numpy().astype(np.int32))})
            _close(got, jd, _tol(jd))
            for key, v in static.items():
                _close(v, jcache[key], _tol(jcache[key]))
        tok = want.argmax(-1)[:, None]
    assert int(pos) == max_len - 1 and cache["pos"] == max_len
