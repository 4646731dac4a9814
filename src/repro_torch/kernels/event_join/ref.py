"""Plain torch version of the event-join kernel."""
from __future__ import annotations

import torch


def join_counts_torch(events: torch.Tensor, counts: torch.Tensor,
                      expected: torch.Tensor):
    """events [N] int32 (−1 padding), counts/expected [T] int32 →
    (new_counts, fired) [T] int32.  Ids outside [0, T) are dropped, as the
    TPU kernel's one-hot compare and ``join_counts_ref`` drop them."""
    T = counts.shape[0]
    valid = (events >= 0) & (events < T)
    idx = torch.where(valid, events, torch.zeros_like(events)).long()
    add = torch.zeros(T, dtype=torch.int32, device=counts.device)
    add.scatter_add_(0, idx, valid.to(torch.int32))
    new_counts = counts + add
    return new_counts, (new_counts >= expected).to(torch.int32)
