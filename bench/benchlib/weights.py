"""The weights the benchmark draws for a configuration, and the port's
``Model`` that serves them.

The weights are the benchmark's, not the program's: drawn from ``--seed``
on the device by a ``torch.Generator``, in bf16 (the type they are served
in), every normal draw in one call over one flat buffer, each parameter a
view of it scaled in place.  They are loaded into a ``Model`` built on the
``meta`` device (which draws nothing) with ``assign=True``, so the port
serves these very tensors and the plain reference reads the same ones.

The configuration's family (``bench/families/<family>.py``) maps the file
to the port's ``ModelConfig`` and gives, by a parameter's name and shape,
the kind of draw and its scale: ``normal`` (N(0, scale²)), ``ones``,
``zeros``, or the published Mamba2 initialisations ``a_log`` (A uniform in
[1, 16]) and ``dt_bias`` (dt log-uniform in [0.001, 0.1], floored at 1e-4).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

from .spec import family
from .traffic import seed_key


def draw(shapes: Dict[str, Tuple[int, ...]], seed: int, device,
         rule: Callable) -> Dict[str, torch.Tensor]:
    """Every parameter of ``shapes`` in bf16 on ``device``, from ``seed``,
    each drawn as ``rule(name, shape)`` says."""
    gen = torch.Generator(device=device).manual_seed(seed_key(seed))
    bf16 = torch.bfloat16
    rules = {n: rule(n, s) for n, s in shapes.items()}
    normal = [n for n, (kind, _) in rules.items() if kind == "normal"]
    # one draw for every normal weight; views start on 128-element bounds
    offsets, total = {}, 0
    for n in normal:
        offsets[n] = total
        total += -(-math.prod(shapes[n]) // 128) * 128
    flat = torch.empty(total, dtype=bf16, device=device)
    flat.normal_(generator=gen)
    out = {}
    for n in normal:
        w = flat[offsets[n]:offsets[n] + math.prod(shapes[n])].view(shapes[n])
        out[n] = w.mul_(rules[n][1])
    for n, (kind, _) in rules.items():
        shape = shapes[n]
        if kind == "ones":
            out[n] = torch.ones(shape, dtype=bf16, device=device)
        elif kind == "zeros":
            out[n] = torch.zeros(shape, dtype=bf16, device=device)
        elif kind == "a_log":
            a = torch.empty(shape, device=device).uniform_(1.0, 16.0, generator=gen)
            out[n] = a.log().to(bf16)
        elif kind == "dt_bias":
            u = torch.empty(shape, device=device).uniform_(0.0, 1.0, generator=gen)
            dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
            dt = dt.clamp(min=1e-4)
            out[n] = (dt + torch.log(-torch.expm1(-dt))).to(bf16)    # softplus⁻¹(dt)
    return out


def build(conf: dict, seed: int, device):
    """(the port's ``Model`` serving the benchmark's weights, the weights
    by parameter name)."""
    from repro_torch.models import Model

    fam = family(conf)
    model = Model(fam.model_config(conf), device="meta")
    axes = {n: p.axes for n, p in model.named_parameters()}
    weights = draw({n: tuple(p.shape) for n, p in model.named_parameters()}, seed, device,
                   fam.rule)
    model.load_state_dict(weights, strict=True, assign=True)
    for n, p in model.named_parameters():
        p.axes = axes[n]
    return model, weights


def fingerprint(weights: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Each weight's fp32 sum: the program must leave the weights as drawn."""
    return torch.stack([torch.sum(w, dtype=torch.float32) for w in weights.values()])
