"""Small configurations and mixes, in the files' own schema, for runs of
the harness on the CPU (the tests).  The cells' files hold the real ones;
each family's module holds its small configuration."""
from __future__ import annotations

import copy
import json

from .spec import BENCH, load


def mix(name: str, **over) -> dict:
    """The cell's mix ``name`` cut to CPU sizes: short prompts, few new
    tokens, small batches, a fast rate."""
    m = json.loads((BENCH / "mixes" / f"{name}.json").read_text())
    m.update(check_tokens=8, trace_batches=1, max_batch=4, max_new_tokens=3)
    m["prompt"] = dict(m["prompt"], min=4, max=24)
    if m["prompt"]["dist"] == "lognormal":
        m["prompt"]["median"] = 10
    m["max_len"] = m["prompt"]["max"] + m["max_new_tokens"]
    if m["loop"] == "open":
        m["rate_per_s"] = 40.0
    else:
        m["callers"] = 8
    m.update(over)
    return m


def config(family: str = "hybrid") -> dict:
    """The family's CPU-size configuration (``SMOKE`` of
    ``bench/families/<family>.py``)."""
    return copy.deepcopy(load(BENCH, "families", family).SMOKE)


def settings(limit: float, commit_policy: str = "every_batch") -> dict:
    """A cell's settings (``bench/cells/<cell>.json``) with one limit, on
    the widest served-logit gap."""
    return {"commit_policy": commit_policy, "limits": {"served_logit_gap_max": limit}}
