"""The one traffic generator.  A mix is a file of parameters
(``bench/mixes/<name>.json``) and nothing else:

- ``loop``: ``"open"`` (independent users, Poisson arrivals at
  ``rate_per_s``) or ``"closed"`` (``callers``, each sending its next
  request when its reply arrives);
- ``prompt``: the prompt-length distribution, ``lognormal`` (``median``,
  ``sigma``) or ``loguniform``, clipped to [``min``, ``max``];
- ``max_new_tokens``, ``max_batch``, ``max_len``: the engine's settings;
- ``autoscaler``: ``KedaAutoscaler``'s ``poll_interval`` and
  ``grace_period``;
- ``check_tokens``: how many served tokens the correctness check samples,
  and ``check_whole_batches``: whether it samples whole batches (see
  ``benchlib/check.py``);
- ``trace_batches``: how many consecutive batches the traced run profiles.

Every length and every gap between arrivals is an independent draw from
the seed: request i's length and gap are the i-th values of their own
stream, drawn in chunks of ``CHUNK`` by ``numpy``'s generator keyed by
(seed, stream, chunk).  Prompt tokens are uniform over [1, vocab) (0 is the
engine's pad), drawn per request from (seed, index).  So a request's
length, arrival and prompt do not depend on when it is sent.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

CHUNK = 1024
LENGTHS, GAPS, TOKENS = 1, 2, 3


def seed_key(seed: int) -> int:
    """Any whole number as a non-negative 63-bit key for numpy and torch."""
    return int(seed) % (1 << 63)


def draw_lengths(dist: dict, rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` independent prompt lengths from ``dist``, rounded and clipped."""
    kind = dist["dist"]
    if kind == "lognormal":
        x = dist["median"] * np.exp(dist["sigma"] * rng.standard_normal(n))
    elif kind == "loguniform":
        x = dist["min"] * (dist["max"] / dist["min"]) ** rng.random(n)
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


class Traffic:
    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix = mix
        self.key = seed_key(seed)
        self.vocab = vocab
        if mix["loop"] not in ("open", "closed"):
            raise ValueError(f"mix {mix.get('name')}: loop must be open or closed")
        self._chunks: Dict[tuple, np.ndarray] = {}

    def _value(self, stream: int, i: int):
        k = i // CHUNK
        values = self._chunks.get((stream, k))
        if values is None:
            rng = np.random.default_rng([self.key, stream, k])
            if stream == LENGTHS:
                values = draw_lengths(self.mix["prompt"], rng, CHUNK)
            else:
                values = rng.exponential(1.0 / self.mix["rate_per_s"], CHUNK)
            self._chunks[(stream, k)] = values
        return values[i % CHUNK]

    def prompt_len(self, i: int) -> int:
        """The i-th request's prompt length (i counts from 0 in send order)."""
        return int(self._value(LENGTHS, i))

    def gap(self, i: int) -> float:
        """Seconds from request i - 1's due time (the window's start for
        i = 0) to request i's, in the open loop."""
        return float(self._value(GAPS, i))

    def prompt(self, i: int) -> List[int]:
        rng = np.random.default_rng([self.key, TOKENS, i])
        return rng.integers(1, self.vocab, self.prompt_len(i)).tolist()
