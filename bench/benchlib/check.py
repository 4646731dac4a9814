"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed: every request
due inside the window must have been answered (``unfinished_requests``),
with ``max_new_tokens`` tokens inside the vocabulary
(``malformed_answers``), and the program must have left the benchmark's
weights as drawn (``weights_changed``).  Then a sample drawn from the seed
of the batches the window formed, the longest always in it, at least the
mix's ``check_tokens`` served tokens: the plain fp32 reference
(``bench/reference/<family>.py``) runs once over each sampled row's padded
prompt and the tokens it was served, and ``served_logit_gap_max`` is the
widest gap by which a served token's reference logit lies below the
reference's best at that position, and ``served_logit_gap_mean`` the mean
of those gaps.  Greedy decoding serves the argmax, so the gap is 0 wherever
the program and the reference agree on the best token, and rounding moves
it only where two logits nearly tie.  A cell's ``limits`` (its file under
``bench/cells/``) name the readings it compares, each with its limit.

The sample takes requests.  Where the family's rows are independent
(``ROWS_INDEPENDENT`` of ``bench/families/<family>.py``) the reference
computes a batch's sampled rows together and nothing more.  Where they are
not (an MoE whose routing has a capacity drops slots by rank across the
whole batch), it computes every row of each sampled batch together: the
padded prompts and served tokens of all its requests, each of which is done
before a batch is sampled; only the sampled rows, all of them counted, are
compared.  With the mix's ``check_whole_batches`` it takes every counted
row of a few whole batches instead: the batch with the longest prompt
first, then batches in an order drawn from the seed.  Where a batch holds
few long rows, as in ``longprompt``, rows computed together cost the
reference far less time than as many rows of as many batches.

With ``control`` the reference is also computed in fp8 (``"fp8"`` in
``reference/common.py``) over the same rows, and ``control_gap_max`` is
the widest gap, in the fp32 reference's logits, of the token the fp8 one
puts first: the reading that sets the limit's upper end.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import spec


def sample(run, mix: dict, conf: dict, key: int):
    """[(batch, [rows])] to compare, drawn from ``key``."""
    rng = np.random.default_rng([key, 5])
    counted = {r.id for r in run.counted()}
    reqs = run.requests
    batches = [b for b in run.batches
               if b.t1 and all(i in reqs and reqs[i].done is not None for i in b.ids)
               and any(i in counted for i in b.ids)]
    if not batches:
        return []
    T = mix["max_new_tokens"]
    want = mix["check_tokens"]
    where = {i: (b, row) for b in batches for row, i in enumerate(b.ids) if i in counted}
    ids = sorted(where)
    longest = max(ids, key=lambda i: reqs[i].prompt_len)
    if mix.get("check_whole_batches"):
        first = where[longest][0]
        order = [first] + [batches[k] for k in rng.permutation(len(batches))
                           if batches[k] is not first]
        picked, n = [], 0
        for b in order:
            if n >= want:
                break
            rows = [row for row, i in enumerate(b.ids) if i in counted]
            picked.append((b, rows))
            n += T * len(rows)
        return picked
    order = [longest] + [ids[k] for k in rng.permutation(len(ids)) if ids[k] != longest]
    rows = {}
    for i in order[:max(1, -(-want // T))]:
        b, row = where[i]
        rows.setdefault(b.index, (b, []))[1].append(row)
    return [(b, sorted(r)) for b, r in rows.values()]


def gaps(run, weights, conf, groups, traffic, control: bool, device):
    """Per sampled token: the fp32 reference's gap of the served token and,
    with ``control``, of the fp8 reference's first token."""
    from reference.common import fp32_only

    fp32_only()
    ref = spec.reference(conf)
    independent = spec.family(conf).ROWS_INDEPENDENT
    out, out8, agree = [], [], []
    for b, rows in groups:
        S = b.S
        computed = rows if independent else range(len(b.ids))
        pick = [computed.index(row) for row in rows]
        seqs, served = [], []
        for row in computed:
            r = run.requests[b.ids[row]]
            prompt = traffic.prompt(r.index)
            seqs.append([0] * (S - len(prompt)) + prompt + r.tokens[:-1])
            served.append(r.tokens)
        tokens = torch.tensor(seqs, dtype=torch.long, device=device)
        got = torch.tensor(served, dtype=torch.long, device=device)
        T = got.shape[1]
        positions = list(range(S - 1, S - 1 + T))
        lg = ref.logits(weights, conf, tokens, S, positions, "fp32")
        best = lg.max(-1).values
        out.append((best - lg.gather(-1, got[..., None])[..., 0])[pick].flatten().cpu())
        agree.append((lg.argmax(-1) == got)[pick].flatten().cpu())
        if control:
            first = ref.logits(weights, conf, tokens, S, positions, "fp8").argmax(-1)
            out8.append((best - lg.gather(-1, first[..., None])[..., 0])[pick].flatten().cpu())
        del lg, tokens
    return (torch.cat(out) if out else torch.zeros(0),
            torch.cat(out8) if out8 else None,
            torch.cat(agree) if agree else torch.zeros(0, dtype=torch.bool))


def judge(run, weights, conf, mix, traffic, limits, changed: int, control: bool,
          device) -> dict:
    counted = run.counted()
    V, T = conf["vocab_size"], mix["max_new_tokens"]
    unfinished = sum(r.done is None for r in counted)
    malformed = sum(r.done is not None and (len(r.tokens) != T
                                            or not all(0 <= t < V for t in r.tokens))
                    for r in counted)
    groups = sample(run, mix, conf, traffic.key) if not malformed else []
    t0 = time.perf_counter()
    g, g8, agree = gaps(run, weights, conf, groups, traffic, control, device)
    ref_s = time.perf_counter() - t0
    readings = {"served_logit_gap_max": float(g.max()) if g.numel() else None,
                "served_logit_gap_mean": float(g.mean()) if g.numel() else None}
    compared = {
        "unfinished_requests": {"value": unfinished, "limit": 0},
        "malformed_answers": {"value": malformed, "limit": 0},
        "weights_changed": {"value": changed, "limit": 0},
    }
    # the cell's limits name the readings it compares
    for name, limit in limits.items():
        compared[name] = {"value": readings[name], "limit": limit}
    correct = all(c["value"] is not None and c["limit"] is not None
                  and c["value"] <= c["limit"] for c in compared.values())
    info = {"compared_tokens": int(g.numel()), **readings,
            "argmax_agree_share": float(agree.float().mean()) if agree.numel() else None}
    if g8 is not None:
        info["control_gap_max"] = float(g8.max()) if g8.numel() else None
        info["control_gap_mean"] = float(g8.mean()) if g8.numel() else None
    return {"correct": correct, "failed": unfinished + malformed, "compared": compared,
            "reference_s": ref_s, "info": info}
