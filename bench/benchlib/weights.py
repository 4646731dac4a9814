"""A configuration file → the port's ``ModelConfig``, and the weights the
benchmark draws for it.

The weights are the benchmark's, not the program's: drawn from ``--seed``
on the device by a ``torch.Generator``, in bf16 (the type they are served
in), every normal draw in one call over one flat buffer, each parameter a
view of it scaled in place.  They are loaded into a ``Model`` built on the
``meta`` device (which draws nothing) with ``assign=True``, so the port
serves these very tensors and the plain reference reads the same ones.

How each parameter is drawn is the benchmark's rule, by its name:
RMSNorm weights and Mamba2's skip are 1, the conv bias 0; Mamba2's
``a_log`` and ``dt_bias`` follow the published Mamba2 initialisation
(A uniform in [1, 16], dt log-uniform in [0.001, 0.1], floored at 1e-4);
the embedding is N(0, 0.02²); every other weight is N(0, 1/fan_in), its
fan-in being the dims it is summed over.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from .traffic import seed_key


def model_config(conf: dict):
    """The port's ``ModelConfig`` for a configuration file.  Raises where
    the file asks for something the port cannot run as stated."""
    from repro_torch.models import ModelConfig

    fam = conf["family"]
    eps = conf.get("rms_norm_eps", 1e-5)
    if abs(eps - 1e-5) > 1e-12:
        raise ValueError(f"{conf['name']}: the port's RMSNorm takes eps 1e-5, not {eps}")
    if fam == "hybrid":
        return ModelConfig(
            arch=conf["name"], family="hybrid", n_layers=conf["num_hidden_layers"],
            d_model=conf["hidden_size"], n_heads=conf["num_attention_heads"],
            n_kv_heads=conf["num_key_value_heads"], d_ff=conf["intermediate_size"],
            vocab=conf["vocab_size"], head_dim=conf["shared_block_head_dim"],
            rope_theta=float(conf["rope_theta"]), ssm_state=conf["mamba_d_state"],
            ssm_headdim=conf["mamba_headdim"], ssm_expand=conf["mamba_expand"],
            ssm_chunk=conf["ssd_chunk"], attn_every=conf["shared_block_every"],
            scan_layers=False)
    raise ValueError(f"{conf['name']}: no mapping for family {fam!r}")


def _rule(name: str, shape: Tuple[int, ...]):
    """(kind, scale) of the parameter ``name``: kind is normal, ones,
    zeros, a_log or dt_bias."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "w" or leaf == "d_skip":
        return "ones", None
    if leaf == "conv_b":
        return "zeros", None
    if leaf in ("a_log", "dt_bias"):
        return leaf, None
    if name == "embed":
        return "normal", 0.02
    if leaf == "conv_w":
        return "normal", shape[0] ** -0.5
    if leaf == "wo" and len(shape) == 3:           # attention out [H, hd, d]
        return "normal", (shape[0] * shape[1]) ** -0.5
    return "normal", shape[0] ** -0.5


def draw(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter of ``shapes`` in bf16 on ``device``, from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed_key(seed))
    bf16 = torch.bfloat16
    rules = {n: _rule(n, s) for n, s in shapes.items()}
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

    cfg = model_config(conf)
    model = Model(cfg, device="meta")
    axes = {n: p.axes for n, p in model.named_parameters()}
    weights = draw({n: tuple(p.shape) for n, p in model.named_parameters()}, seed, device)
    model.load_state_dict(weights, strict=True, assign=True)
    for n, p in model.named_parameters():
        p.axes = axes[n]
    return model, weights


def fingerprint(weights: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Each weight's fp32 sum: the program must leave the weights as drawn."""
    return torch.stack([torch.sum(w, dtype=torch.float32) for w in weights.values()])
