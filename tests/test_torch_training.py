"""The port's training substrate (``repro_torch.training``) against the JAX
package's, on the CPU.

Mirrors ``tests/test_training.py``: AdamW minimises a quadratic, the
warmup-cosine schedule, clipping, the checkpoint round trip and gc, data
determinism (``training/data.py`` is a copy under the drift guard), loss
decreasing under the trigger-orchestrated ``run_training`` and its resume
from a checkpoint.  Then, against the reference on the same inputs:

- AdamW's update over several steps with clipping, on bf16 parameters with
  fp32 moments: moments within 1e-6 relative, parameters within one bf16
  ulp (the update is computed in fp32 in both and cast back);
- checkpoints in both directions: the reference's ``checkpoint.save`` read
  by the port's ``TorchCluster`` and the port's read by the reference's
  ``checkpoint.restore``, every leaf bit for bit, for a model with stacked
  layers (llama) and one without (xlstm);
- ``accum_steps=2`` against the reference's and against 1;
- K2's and K3's autograd Functions with their plain forward passed in: the
  gradients equal autograd through the plain function that their backward
  recomputes, exactly, and ``jax.grad`` of the reference's
  ``attention_chunked`` / chunked SSD within 2e-5 (fp32, another summation
  order).

One train step of every smoke arch against the reference is in
``tests/test_torch_train_step*.py``.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import layers as JL
from repro.models import ssm as JSSM
from repro.models import unbox
from repro.training import checkpoint as jckpt
from repro.training.optimizer import AdamW as JaxAdamW
from repro.training.optimizer import warmup_cosine as jax_warmup_cosine
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_scan_torch
from repro_torch.models import Model
from repro_torch.models import layers as TL
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import SyntheticData
from repro_torch.training.optimizer import AdamW, warmup_cosine
from repro_torch.training.train_step import make_train_step
from repro_torch.training.trainer import TorchCluster, run_training


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _bf16_ulp(x):
    """One bf16 ulp of each |x| (8 significant bits), with the ulp of the
    smallest normal for zeros."""
    x = np.maximum(np.abs(np.asarray(x, np.float32)), np.float32(2.0 ** -126))
    return 2.0 ** (np.floor(np.log2(x)) - 7)


# ------------------------------------------------ tests/test_training.py ----
def test_adamw_minimizes_quadratic():
    opt = AdamW(lr=lambda step: 0.1, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(150):
        w = params["w"].clone().requires_grad_(True)
        (w ** 2).sum().backward()
        params, state, _ = opt.update({"w": w.grad}, state, params)
    assert float((params["w"] ** 2).sum()) < 1e-3


def test_warmup_cosine_shape():
    sched = warmup_cosine(1.0, warmup=10, total=100)
    assert float(sched(0)) == 0.0
    assert float(sched(10)) == pytest.approx(1.0)
    assert float(sched(100)) == pytest.approx(0.1, abs=1e-3)
    jsched = jax_warmup_cosine(1.0, warmup=10, total=100)
    for step in (0, 3, 10, 37, 99, 100, 150):
        assert float(sched(step)) == pytest.approx(float(jsched(jnp.asarray(step))),
                                                   rel=1e-6, abs=1e-7)


def test_grad_clipping():
    opt = AdamW(lr=lambda s: 0.0, clip_norm=1.0)
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    _, state, gnorm = opt.update({"w": torch.tensor([100.0, 0.0, 0.0])}, state, params)
    assert float(gnorm) == pytest.approx(100.0)
    assert float(state["m"]["w"].abs().max()) <= 0.11  # clipped to unit norm


def test_checkpoint_roundtrip(tmp_path):
    params = {"a": torch.arange(6).reshape(2, 3).to(torch.bfloat16),
              "b": {"c": torch.ones(4)}}
    opt_state = {"m": {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4)}}, "count": 7}
    ckpt.save(str(tmp_path), 7, params, opt_state, extra={"loss": 1.5})
    step, p2, o2, meta = ckpt.restore(str(tmp_path), params, opt_state)
    assert step == 7 and meta["loss"] == 1.5
    assert p2["a"].dtype == torch.bfloat16 and torch.equal(p2["a"], params["a"])
    assert torch.equal(p2["b"]["c"], params["b"]["c"])
    assert o2["count"] == 7


def test_checkpoint_gc_keeps_last(tmp_path):
    params = {"a": torch.ones(2)}
    for s in range(5):
        ckpt.save(str(tmp_path), s, params, keep=2)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(steps) == 2
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]


def test_data_determinism_and_copy_structure():
    ds = SyntheticData(64, 16, 4, kind="copy_task", seed=3)
    b1, b2 = ds.batch_at(5), ds.batch_at(5)
    assert (b1["tokens"] == b2["tokens"]).all()
    toks = b1["tokens"]
    assert (toks[:, :8] == toks[:, 8:16]).all()  # copy structure
    assert (b1["targets"][:, :7] == -1).all()    # first half unscored


def test_trigger_orchestrated_training_loss_decreases(tmp_path):
    cfg = get_config("llama3.2-3b", smoke=True)
    out = run_training(cfg, str(tmp_path), total_steps=30, chunk_steps=10,
                       batch=8, seq=32, peak_lr=3e-3, device="cpu")
    assert out["workflow_result"]["status"] == "succeeded"
    hist = out["history"]
    assert [h["step"] for h in hist] == [10, 20, 30]
    assert hist[-1]["loss_mean"] < hist[0]["loss_mean"]  # copy task learned


def test_training_resumes_from_checkpoint(tmp_path):
    cfg = get_config("yi-9b", smoke=True)
    run_training(cfg, str(tmp_path), total_steps=4, chunk_steps=2, batch=4, seq=16,
                 device="cpu")
    assert ckpt.latest_step(str(tmp_path)) == 4
    # "node failure": a new Triggerflow and executor, the same workdir
    out = run_training(cfg, str(tmp_path), total_steps=8, chunk_steps=2, batch=4, seq=16,
                       device="cpu")
    assert out["history"][0]["step"] == 6  # started from 4, not 0
    assert out["history"][-1]["step"] == 8
    assert out["cluster"].opt_state["count"] == 8


# ------------------------------------------------- against the reference ----
def test_adamw_update_matches_reference():
    """Five steps on bf16 parameters, the gradients large enough to be
    clipped, a warmup-cosine schedule: the same fp32 moments and bf16
    parameters as the reference's."""
    shapes = {"w": (7, 5), "b": (5,)}
    params = {k: _np(i, *s, scale=0.3) for i, (k, s) in enumerate(shapes.items())}
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in params.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in params.items()}
    jopt = JaxAdamW(lr=jax_warmup_cosine(1e-2, warmup=2, total=10))
    topt = AdamW(lr=warmup_cosine(1e-2, warmup=2, total=10))
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(5):
        grads = {k: _np(10 + step * 2 + i, *s) for i, (k, s) in enumerate(shapes.items())}
        jp, js, jn = jopt.update({k: jnp.asarray(g).astype(jnp.bfloat16)
                                  for k, g in grads.items()}, js, jp)
        tp, ts, tn = topt.update({k: torch.from_numpy(g).to(torch.bfloat16)
                                  for k, g in grads.items()}, ts, tp)
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
        assert ts["count"] == int(js["count"]) == step + 1
        for k in shapes:
            for mom in ("m", "v"):
                want = np.asarray(js[mom][k])
                got = ts[mom][k].numpy()
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
            want = np.asarray(jp[k].astype(jnp.float32))
            got = tp[k].float().numpy()
            assert (np.abs(got - want) <= _bf16_ulp(want)).all(), k


def _stored(tree):
    return {k: _stored(v) if isinstance(v, dict) else np.asarray(v, np.float32)
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["llama3.2-3b", "xlstm-1.3b"])
def test_reference_checkpoint_restores_in_the_port(arch, tmp_path):
    """The reference writes params and AdamW state (after one update, so
    the moments are not zero) at step 3; the port's executor restores them
    into its model and optimizer exactly."""
    jcfg = jax_get_config(arch, smoke=True)
    params = unbox(JaxModel(jcfg).init(jax.random.PRNGKey(0)))
    jopt = JaxAdamW()
    grads = jax.tree_util.tree_map(lambda p: jnp.ones_like(p) * 0.01, params)
    params, state, _ = jax.jit(jopt.update)(grads, jopt.init(params), params)
    jckpt.save(str(tmp_path), 3, params, state, extra={"loss": 2.0})

    cluster = TorchCluster(get_config(arch, smoke=True), str(tmp_path), batch=2, seq=8,
                           device="cpu")
    cluster.ensure_state()
    assert cluster.step == 3 and cluster.opt_state["count"] == 1
    want = params_from_jax(jax.device_get(params))
    got = dict(cluster.model.named_parameters())
    assert set(got) == set(want)
    for k, t in want.items():
        assert torch.equal(got[k].detach(), t), k
    for mom in ("m", "v"):
        want = params_from_jax(jax.device_get(state[mom]))
        for k, t in want.items():
            assert torch.equal(cluster.opt_state[mom][k], t), (mom, k)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "xlstm-1.3b"])
def test_port_checkpoint_restores_in_the_reference(arch, tmp_path):
    """The port trains one step and checkpoints; the reference's restore,
    given its own model's tree and AdamW state as templates, reads every
    leaf of the port's parameters and moments bit for bit."""
    cluster = TorchCluster(get_config(arch, smoke=True), str(tmp_path), batch=2, seq=8,
                           device="cpu")
    rec = cluster.train_chunk({"steps": 1})
    assert rec["step"] == 1 and ckpt.latest_step(str(tmp_path)) == 1

    jcfg = jax_get_config(arch, smoke=True)
    like = unbox(JaxModel(jcfg).init(jax.random.PRNGKey(1)))
    step, params, state, meta = jckpt.restore(str(tmp_path), like, JaxAdamW().init(like))
    assert step == 1 and meta["loss"] == rec["loss"] and int(state["count"]) == 1
    trees = {"params": params_to_jax(dict(cluster.model.named_parameters()), cluster.cfg),
             **{mom: params_to_jax(cluster.opt_state[mom], cluster.cfg) for mom in "mv"}}
    for name, restored in (("params", params), ("m", state["m"]), ("v", state["v"])):
        want = jax.tree_util.tree_leaves(_stored({k: t.detach().float().numpy()
                                                  for k, t in _flat(trees[name]).items()}))
        got = [np.asarray(v, np.float32) for v in
               jax.tree_util.tree_leaves(_stored(_flat(jax.device_get(restored))))]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert jax.tree_util.tree_map(jnp.shape, restored) == \
            jax.tree_util.tree_map(jnp.shape, like)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _copy_batch(cfg, B=4, S=16, seed=0):
    b = SyntheticData(cfg.vocab, S, B, seed=seed).batch_at(0)
    return b, {k: torch.from_numpy(v).long() for k, v in b.items()}


def test_grad_accumulation_matches_reference_and_one_step():
    """accum_steps=2 (fp32 sums of the two microbatches' gradients, / 2)
    against the reference's on the same weights and batch, and against
    accum_steps=1: the copy task scores as many targets in each row, so
    the loss is the same mean and the moments agree within the bf16
    rounding of a microbatch's gradients."""
    arch = "llama3.2-3b"
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32)
    jmodel = JaxModel(jcfg)
    params = unbox(jmodel.init(jax.random.PRNGKey(0)))
    jbatch, tbatch = _copy_batch(tcfg)
    jopt = JaxAdamW(lr=jax_warmup_cosine(1e-2, warmup=0, total=10))
    _, jstate, jm = jax_make_train_step(jmodel, jopt, accum_steps=2)(
        params, jopt.init(params), {k: jnp.asarray(v) for k, v in jbatch.items()})

    states = {}
    for accum in (2, 1):
        model = Model(tcfg, device="cpu")
        model.load_state_dict(params_from_jax(jax.device_get(params)))
        opt = AdamW(lr=warmup_cosine(1e-2, warmup=0, total=10))
        step = make_train_step(model, opt, accum_steps=accum)
        states[accum], metrics = step(opt.init(dict(model.named_parameters())), tbatch)
        assert float(metrics["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    want_m = params_from_jax(jax.device_get(jstate["m"]))
    for k, w in want_m.items():
        w = w.numpy()
        for accum, tol in ((2, 2.0 ** -10), (1, 2.0 ** -7)):
            got = states[accum]["m"][k].numpy()
            err = np.linalg.norm(got - w) / max(np.linalg.norm(w), 1e-30)
            assert err <= tol, (accum, k, err)


# ----------------------------------------------- the autograd Functions ----
def _attn(seed, B=2, S=24, Hq=4, Hkv=2, D=8):
    return _np(seed, B, S, Hq, D), _np(seed + 1, B, S, Hkv, D), _np(seed + 2, B, S, Hkv, D)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_function_gradients(causal):
    """FlashAttentionFn with the plain forward passed in: its gradients are
    those of autograd through attention_chunked (its backward recomputes
    it) exactly, and jax.grad of the reference's attention_chunked within
    2e-5; each backward counts once."""
    q, k, v = _attn(3)
    g = _np(9, *q.shape)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    calls = fa_ops.backward_calls
    out = fa_ops.FlashAttentionFn.apply(*leaves, causal, fa_ops.flash_attention_plain)
    out.backward(torch.from_numpy(g))
    assert fa_ops.backward_calls == calls + 1
    got = [t.grad for t in leaves]

    plain = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    TL.attention_chunked(*plain, causal=causal).backward(torch.from_numpy(g))
    for a, b in zip(got, plain):
        assert torch.equal(a, b.grad)

    def ref(q, k, v):
        return jnp.sum(JL.attention_chunked(q, k, v, causal=causal) * g)

    want = jax.grad(ref, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-5)


def _ssd_inputs(seed, B=2, S=20, H=3, P=4, N=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32) * 0.5 for _ in range(2))
    a = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    return x, dt, Bm, Cm, a


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_function_gradients(with_state):
    """SSDFn with the plain forward passed in, through y alone (the state's
    gradient stays None) and through y and the final state: its gradients
    are those of autograd through ssd_scan_torch exactly, and jax.grad of
    the reference's chunked SSD within 2e-5 (chunk 8, a ragged last chunk)."""
    inputs = _ssd_inputs(5)
    gy = _np(11, *inputs[0].shape)
    gs = _np(12, 2, 3, 5, 4)

    def loss(y, state):
        out = (y * torch.from_numpy(gy)).sum()
        return out + (state * torch.from_numpy(gs)).sum() if with_state else out

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    calls = ssd_ops.backward_calls
    loss(*ssd_ops.SSDFn.apply(*leaves, 8, torch.float32, ssd_ops.ssd_plain)).backward()
    assert ssd_ops.backward_calls == calls + 1
    plain = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    loss(*ssd_scan_torch(*plain, 8)).backward()
    for a, b in zip(leaves, plain):
        assert torch.equal(a.grad, b.grad)

    def ref(x, dt, Bm, Cm, a):
        y, state = JSSM._ssd_chunked(x, Bm, Cm, dt, a, 8)
        out = jnp.sum(y * gy)
        return out + jnp.sum(state * gs) if with_state else out

    want = jax.grad(ref, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in inputs))
    for a, w in zip(leaves, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), atol=2e-5)
