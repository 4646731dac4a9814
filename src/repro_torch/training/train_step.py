"""Training and serving step factories: the JAX package's, for a torch
``Model`` whose parameters live in the module.

``make_train_step(model, opt, accum_steps)`` turns the model's gradients on
(serving leaves them off) and returns ``train_step(opt_state, batch) →
(opt_state, metrics)``, which differentiates ``Model.loss`` by autograd and
updates the model's parameters in place.  On the card the attention and SSD
of the forward are the hand-written kernels, inside autograd Functions
whose backward is plain torch (``kernels.flash_attention.ops``,
``kernels.ssd.ops``).  With ``accum_steps`` > 1 the batch splits on its
first axis into that many microbatches, whose gradients are summed in fp32
and divided by ``accum_steps``, as the reference's scan over microbatches
does; with 1 the gradients keep the parameters' dtype, as ``jax.grad``'s
do.  On a mesh (``distributed.sharding.distribute_model``) the parameters,
gradients, moments and accumulation buffers are DTensors at the
parameters' placements.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models import Model
from .optimizer import AdamW


def _grads(params: Dict[str, torch.Tensor], dtype=None) -> Dict[str, torch.Tensor]:
    """Take each parameter's gradient (zeros where autograd left none) and
    clear it."""
    out = {}
    for k, p in params.items():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        out[k] = g if dtype is None else g.to(dtype)
        p.grad = None
    return out


def make_train_step(model: Model, opt: AdamW, accum_steps: int = 1):
    model.requires_grad_(True)
    params = dict(model.named_parameters())

    def train_step(opt_state, batch: Dict[str, torch.Tensor]):
        if accum_steps == 1:
            loss, _ = model.loss(batch)
            loss.backward()
            grads = _grads(params)
        else:
            micro = [{k: v.chunk(accum_steps, dim=0)[i] for k, v in batch.items()}
                     for i in range(accum_steps)]
            grads = {k: torch.zeros_like(p, dtype=torch.float32, requires_grad=False)
                     for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=next(iter(params.values())).device)
            for mb in micro:
                l, _ = model.loss(mb)
                l.backward()
                for k, g in _grads(params, torch.float32).items():
                    grads[k] += g
                loss = loss + l.detach()
            grads = {k: g / accum_steps for k, g in grads.items()}
            loss = loss / accum_steps
        _, opt_state, gnorm = opt.update(grads, opt_state, params)
        return opt_state, {"loss": loss.detach().float(), "grad_norm": gnorm,
                           "step": opt_state["count"]}

    return train_step


def make_prefill_step(model: Model, max_len: Optional[int] = None):
    def prefill_step(batch):
        return model.prefill(batch, max_len=max_len)

    return prefill_step


def make_decode_step(model: Model):
    def decode_step(cache, batch):
        return model.decode(cache, batch)

    return decode_step
