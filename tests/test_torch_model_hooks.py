"""The model-side hooks of the distributed layer against the reference, on
the CPU.

- ``_attention_unrolled`` (the reference's straight-line attention with its
  causal block skip) against the reference's, causal or not, with ragged
  sequences (padded to whole chunks) and G = 1 and 3; fp32, atol 2e-5 (the
  two packages sum in another order).
- ``unroll_attention=True`` logits of a dense and an MLA smoke model against
  the reference's with the same flag, on the reference's weights, within
  1e-4·(1 + max|logit|), as ``test_torch_models.py`` holds the models.
- ``_remat``: ``full`` and ``dots`` give ``none``'s loss and gradients
  exactly in fp32 (a recompute runs the same ops on the same inputs), and
  really recompute: the block's forward runs twice a layer under
  ``backward``, once with ``none``; under ``no_grad`` every policy runs it
  once.
- ``lsc`` is the identity without a resolver, and ``param_axes`` names every
  parameter.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import layers as JL
from repro.models import unbox
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS
from repro_torch.models.convert import params_from_jax


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("S,chunk", [(24, 16), (40, 16), (16, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_unrolled_matches_reference(causal, S, chunk, G):
    B, Hkv, D = 2, 2, 8
    q, k, v = _np(S, B, S, Hkv * G, D), _np(G, B, S, Hkv, D), _np(chunk, B, S, Hkv, D)
    want = JL._attention_unrolled(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                                  None, 0, chunk, chunk)
    got = TL.attention_chunked(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               causal=causal, q_chunk=chunk, kv_chunk=chunk, unroll=True)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 2e-5


def _pair(arch, **over):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32, **over)
    jmodel = JaxModel(jcfg)
    params = unbox(jmodel.init(jax.random.PRNGKey(0)))
    tmodel = Model(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    return jmodel, params, tmodel


@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-v2-236b"])
def test_unrolled_model_logits_match_reference(arch):
    jmodel, params, tmodel = _pair(arch, unroll_attention=True, q_chunk=8, kv_chunk=8)
    toks = np.random.default_rng(1).integers(0, tmodel.cfg.vocab, (2, 20)).astype(np.int32)
    want, _ = jmodel.forward(params, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, _ = tmodel.forward({"tokens": torch.from_numpy(toks).long()})
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * (1 + np.abs(want).max())


# the function whose calls count the block forwards of each family
COUNTED = {"llama3.2-3b": (TL, "mlp_forward"), "zamba2-1.2b": (TS, "mamba2_forward")}


def _loss_and_grads(arch, policy, monkeypatch):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32,
                              remat_policy=policy)
    model = Model(cfg, device="cpu", seed=0).float().requires_grad_(True)
    mod, name = COUNTED[arch]
    real, calls = getattr(mod, name), []

    def counted(*args, **kw):
        calls.append(torch.is_grad_enabled())
        return real(*args, **kw)

    monkeypatch.setattr(mod, name, counted)
    toks = torch.randint(0, cfg.vocab, (2, 24), generator=torch.Generator().manual_seed(2))
    loss, _ = model.loss({"tokens": toks, "targets": toks})
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    with torch.no_grad():
        model.loss({"tokens": toks, "targets": toks})
    return loss.detach(), grads, len(calls), cfg.n_layers


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", sorted(COUNTED))
def test_remat_recomputes_and_changes_nothing(arch, policy, monkeypatch):
    loss0, grads0, calls0, L = _loss_and_grads(arch, "none", monkeypatch)
    loss, grads, calls, _ = _loss_and_grads(arch, policy, monkeypatch)
    assert torch.equal(loss, loss0)
    for k, g in grads0.items():
        assert torch.equal(grads[k], g), k
    # none: a forward with grad and one without; a recompute adds one a layer
    assert calls0 == 2 * L
    assert calls == 3 * L


def test_lsc_is_the_identity_without_a_resolver():
    x = torch.randn(2, 3, 4)
    assert TL.lsc(x, "batch", "act_seq", None) is x


def test_param_axes_name_every_parameter():
    from repro_torch.models.common import param_axes

    model = Model(get_config("zamba2-1.2b", smoke=True), device="cpu")
    axes = param_axes(model)
    assert set(axes) == {k for k, _ in model.named_parameters()}
    assert axes["layers.0.mamba.wx"] == ("embed", "ffn")
    assert axes["shared_proj.0"] == ("embed", "embed2")
    assert axes["final_norm.w"] == ("embed",)
    with pytest.raises(ValueError, match="do not name"):
        from repro_torch.models.common import make_param

        make_param(None, (2, 3), ("embed",))
