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
    params, block, x = _mamba()
    rng = np.random.default_rng(7)
    state = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    conv = rng.standard_normal((2, 3, 32)).astype(np.float32)
    want, jstate, jconv = jax_decode(params, jnp.asarray(x[:, :1]), jnp.asarray(state),
                                     jnp.asarray(conv))
    tstate, tconv = torch.from_numpy(state), torch.from_numpy(conv)
    got, new_state, new_conv = mamba2_decode(block, torch.from_numpy(x[:, :1]),
                                             tstate, tconv)
    _close(got, want, 2e-5)
    _close(new_state, jstate, 2e-5)
    _close(new_conv, jconv, 2e-5)
    # the inputs are left as they were
    assert np.array_equal(tstate.numpy(), state) and np.array_equal(tconv.numpy(), conv)


def test_mamba2_chunked_equals_recurrent():
    """tests/test_models.py's property, on the port: the chunked forward
    equals stepping the recurrence token by token."""
    params, block, x = _mamba()
    xt = torch.from_numpy(x)
    y_chunked, (state, _) = mamba2_forward(block, xt, chunk=4, return_state=True)
    st = torch.zeros(2, 4, 8, 8)
    cc = torch.zeros(2, 3, 32)
    outs = []
    for t in range(16):
        o, st, cc = mamba2_decode(block, xt[:, t:t + 1], st, cc)
        outs.append(o)
    _close(torch.cat(outs, dim=1), y_chunked.numpy(), 2e-4)
    _close(st, state.numpy(), 2e-4)


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
