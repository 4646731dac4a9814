"""One train step of a smoke arch in both packages, on the same weights and
batch, with fp32 activations (as ``tests/test_models.py:70-97`` run the
reference): the port's ``make_train_step`` against the reference's (jitted,
which runs the same arithmetic as its eager call in a fraction of the
time).

Held: the loss within 1e-5 relative (fp32, another summation order); the
global gradient norm within 2**-10; every leaf's gradient and first moment
m after the step within 2**-7 in relative L2, and v (their square) within
2**-6: the gradients of bf16 parameters are bf16 in both packages, so an
element may differ by a rounding flip, and a weight used at several places
(zamba2's shared block, the sLSTM's recurrent matrix at every step) sums
its uses in bf16 in another order.  The schedule is flat at 1e-2, so that
the step moves the parameters by much more than an ulp.  Then the updated
parameters, two ways:

- the port's AdamW applied to the reference's gradients gives every
  parameter within one bf16 ulp of the reference's, plus the fp32 rounding
  of p − lr·step, 2**-20·(|p| + lr): the update's arithmetic is the
  reference's;
- the port's whole step gives 99.9% of the parameters within that, and
  every one within two steps, 2·lr·(1 + wd·|p|) plus two ulps.  Adam's
  first step is lr·g/(|g| + ε): where a gradient is at the level of
  rounding noise (a logit's weight that nearly cancels, the sLSTM's summed
  uses), the two packages' noise gives steps of other sizes and may give
  one of the other sign.

The reference's gradients are read off its first moment after the step
(see ``check_train_step``), so one jitted call of its step gives both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import unbox
from repro.training.optimizer import AdamW as JaxAdamW
from repro.training.optimizer import warmup_cosine as jax_warmup_cosine
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax
from repro_torch.training.optimizer import AdamW, warmup_cosine
from repro_torch.training.train_step import make_train_step


def batch_for(cfg, B=2, S=16, seed=0):
    """Seeded numpy tokens and next-token targets (the last -1, unscored);
    vlm: patch embeddings at positions [1, 1 + n_patches)."""
    rng = np.random.default_rng(seed)
    shape = (B, cfg.codebooks, S) if cfg.family == "audio" else (B, S)
    toks = rng.integers(0, cfg.vocab, shape).astype(np.int32)
    targets = np.concatenate([toks[..., 1:], np.full(shape[:-1] + (1,), -1, np.int32)], -1)
    batch = {"tokens": toks, "targets": targets}
    if cfg.family == "vlm":
        P = cfg.n_patches
        batch["patch_embeds"] = rng.standard_normal((B, P, cfg.d_model)).astype(np.float32)
        batch["patch_positions"] = np.tile(np.arange(1, 1 + P)[None], (B, 1)).astype(np.int32)
    return batch


def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _bf16_ulp(x):
    x = np.maximum(np.abs(np.asarray(x, np.float32)), np.float32(2.0 ** -126))
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def check_train_step(arch):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32)
    jmodel = JaxModel(jcfg)
    params = unbox(jmodel.init(jax.random.PRNGKey(0)))
    batch = batch_for(tcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
              for k, v in batch.items()}

    jopt = JaxAdamW(lr=jax_warmup_cosine(1e-2, warmup=0, total=10 ** 6))
    jparams, jstate, jmetrics = jax.jit(jax_make_train_step(jmodel, jopt))(
        params, jopt.init(params), jbatch)
    jloss = jmetrics["loss"]
    # the first step's m is (1 - b1)·scale·g, scale = min(1, clip/|g|): it
    # gives each bf16 gradient back exactly
    gnorm = float(jmetrics["grad_norm"])
    scale = np.float32(min(1.0, jopt.clip_norm / max(gnorm, 1e-9)))
    jgrads = jax.tree_util.tree_map(
        lambda m: (np.asarray(m) / np.float32(1 - jopt.b1) / scale).astype(jnp.bfloat16),
        jax.device_get(jstate["m"]))

    def port_model():
        model = Model(tcfg, device="cpu")
        model.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
        return model

    model = port_model()
    opt = AdamW(lr=warmup_cosine(1e-2, warmup=0, total=10 ** 6))
    step = make_train_step(model, opt)
    loss, _ = model.loss(tbatch)
    loss.backward()
    grads = {k: p.grad.float().numpy() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    state, metrics = step(opt.init(dict(model.named_parameters())), tbatch)

    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert abs(float(metrics["loss"]) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert abs(float(metrics["grad_norm"]) - float(jmetrics["grad_norm"])) <= \
        2.0 ** -10 * float(jmetrics["grad_norm"])
    assert state["count"] == int(jmetrics["step"]) == 1
    want = {"grad": params_from_jax(jax.device_get(jgrads)),
            "m": params_from_jax(jax.device_get(jstate["m"])),
            "v": params_from_jax(jax.device_get(jstate["v"]))}
    got = {"grad": grads, "m": state["m"], "v": state["v"]}
    names = [k for k, _ in model.named_parameters()]
    assert set(names) == set(want["grad"])
    for k in names:
        for what, tol in (("grad", 2.0 ** -7), ("m", 2.0 ** -7), ("v", 2.0 ** -6)):
            g = got[what][k]
            g = g.numpy() if isinstance(g, torch.Tensor) else g
            err = _rel(g, want[what][k].float().numpy())
            assert err <= tol, (arch, what, k, err)

    # the port's AdamW on the reference's gradients
    ref_grads = {k: t.to(torch.bfloat16) for k, t in want["grad"].items()}
    ref_model = port_model()
    opt.update(ref_grads, opt.init(dict(ref_model.named_parameters())),
               dict(ref_model.named_parameters()))
    old = params_from_jax(jax.device_get(params))
    new = params_from_jax(jax.device_get(jparams))
    lr, wd = 1e-2, opt.weight_decay
    n_off = n_all = 0
    for (k, p), (_, q) in zip(model.named_parameters(), ref_model.named_parameters()):
        w = new[k].float().numpy()
        p_old = np.abs(old[k].float().numpy())
        tol = _bf16_ulp(w) + 2.0 ** -20 * (p_old + lr)
        bad = np.abs(q.detach().float().numpy() - w) > tol
        assert not bad.any(), (arch, "update of the reference's gradients", k, int(bad.sum()))
        diff = np.abs(p.detach().float().numpy() - w)
        assert (diff <= 2 * lr * (1 + wd * p_old) + 2 * _bf16_ulp(w)).all(), (arch, k)
        n_off += int((diff > tol).sum())
        n_all += diff.size
    assert n_off <= 1e-3 * n_all, (arch, n_off, n_all)
