"""Deterministic synthetic data pipelines (no external datasets offline).

* ``zipf_lm``  — Zipf-distributed token stream (realistic vocab statistics).
* ``copy_task`` — second half of each sequence repeats the first half; a real
  learnable task, so the end-to-end example's loss visibly drops toward the
  copy-entropy floor instead of staying at ln(V).

Batches are seeded per-step, so a restarted run (fault-tolerance benchmark)
regenerates the identical stream — the data-pipeline analogue of event replay.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class SyntheticData:
    def __init__(self, vocab: int, seq: int, batch: int, kind: str = "copy_task",
                 seed: int = 0, codebooks: int = 0):
        assert kind in ("zipf_lm", "copy_task")
        self.vocab = vocab
        self.seq = seq
        self.batch = batch
        self.kind = kind
        self.seed = seed
        self.codebooks = codebooks

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        shape = ((self.batch, self.codebooks, self.seq) if self.codebooks
                 else (self.batch, self.seq))
        if self.kind == "zipf_lm":
            ranks = rng.zipf(1.3, size=shape).astype(np.int64)
            tokens = np.minimum(ranks, self.vocab - 1).astype(np.int32)
        else:
            half = self.seq // 2
            first = rng.integers(0, self.vocab, size=shape[:-1] + (half,),
                                 dtype=np.int32)
            tokens = np.concatenate([first, first], axis=-1)
            if tokens.shape[-1] < self.seq:
                pad = rng.integers(0, self.vocab,
                                   size=shape[:-1] + (self.seq - tokens.shape[-1],),
                                   dtype=np.int32)
                tokens = np.concatenate([tokens, pad], axis=-1)
        targets = np.concatenate(
            [tokens[..., 1:], np.full(shape[:-1] + (1,), -1, np.int32)], axis=-1)
        if self.kind == "copy_task":
            # only score the learnable (copied) second half
            half = self.seq // 2
            masked = targets.copy()
            masked[..., : half - 1] = -1
            targets = masked
        return {"tokens": tokens, "targets": targets}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
