"""AdamW with a warmup + cosine schedule and global-norm clipping: the JAX
package's update, in place on the port's parameters.

The moments are fp32 whatever the parameters' dtype (bf16 here), and the
update is computed in fp32 and cast back: p ← p − lr·(m̂/(√v̂ + ε) + wd·p).
``torch.optim.AdamW`` keeps its moments in the parameter's dtype, which
would be another update.  Parameters, gradients and moments are mappings
from the port's parameter names to tensors; ``update`` writes the new
parameters into the given tensors and the new moments into the state's, so
no second copy of either is made.  The moments are made ``zeros_like``
their parameters, so on a mesh (DTensor parameters) they shard as their
parameters do, the reference's ``opt_sh``; the step's scalars stay 0-dim
tensors, which DTensor arithmetic takes as they are.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional

import torch


def warmup_cosine(peak_lr: float, warmup: int = 100, total: int = 10_000,
                  floor: float = 0.1) -> Callable:
    """step → lr: linear warmup to ``peak_lr``, then a cosine down to
    ``floor``·peak_lr at ``total``, in fp32 as the reference computes it."""
    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)   # keeps a tensor's device
        warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, peak_lr * cos)

    return schedule


@dataclasses.dataclass
class AdamW:
    lr: Callable = warmup_cosine(3e-4)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict:
        def zeros():
            return {k: torch.zeros_like(p, dtype=torch.float32, requires_grad=False)
                    for k, p in params.items()}

        return {"m": zeros(), "v": zeros(), "count": 0}

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: Dict,
               params: Mapping[str, torch.Tensor]):
        """One step → (params, state, the gradients' global norm before
        clipping).  ``params`` and the state's moments are updated in
        place; the state's ``count`` is a new int."""
        count = state["count"] + 1
        gnorm = global_norm(grads)
        f32 = dict(dtype=torch.float32, device=gnorm.device)
        cf = torch.tensor(count, **f32)
        scale = (torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
                 if self.clip_norm is not None else None)
        bc1 = 1 - torch.tensor(self.b1, **f32) ** cf
        bc2 = 1 - torch.tensor(self.b2, **f32) ** cf
        lr = self.lr(cf)
        for k, p in params.items():
            g = grads[k].float()
            if scale is not None:
                g = g * scale
            m, v = state["m"][k], state["v"][k]
            m.copy_(self.b1 * m + (1 - self.b1) * g)
            v.copy_(self.b2 * v + (1 - self.b2) * g * g)
            mh = m / bc1
            vh = v / bc2
            p32 = p.float()
            step = mh / (torch.sqrt(vh) + self.eps) + self.weight_decay * p32
            p.copy_((p32 - lr * step).to(p.dtype))
        return params, {**state, "count": count}, gnorm


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """√(Σ g²) over every tensor, in fp32 (a 0-dim tensor on the first
    tensor's device)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tree.values()))
