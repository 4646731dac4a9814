"""The control at a size a test run holds: the plain reference computed in
fp8 (the precision below the configurations' bf16), read where the
program's served tokens are read, fails a limit that the program passes.

The batches go straight through the engine's ``generate_batch`` (the
timed path's entry for a batch) at fixed shapes, so the readings do not
depend on how a timed run happened to form its batches.  ``bench/control.py``
takes the same readings on the card at the cells' own sizes, which set the
cells' limits; the readings at this size and the limits set from them are
in ``READINGS`` (torch 2.13 on the CPU, one thread)."""
import pytest
import torch

from benchlib import check, harness, smoke, weights
from benchlib.traffic import Traffic

# mix: (the reading compared, as the cell compares it; the program's
# largest over the seeds; the control's smallest; the limit set between)
READINGS = {"chat": ("max", 0.0610, 0.677, 0.2),
            "longprompt": ("max", 0.0614, 0.731, 0.2)}


def readings(family: str, mixname: str, seed: int, n_batches: int):
    from repro_torch.core import Triggerflow

    conf = smoke.config(family)
    mix = smoke.mix(mixname)
    model, w = weights.build(conf, seed, "cpu")
    eng = harness.make_engine(model, Triggerflow(device="cpu"), mix)
    traffic = Traffic(mix, seed, conf["vocab_size"])
    run = harness.Run(conf, mix, 1.0)
    run.t_open, run.t_close = 0.0, 1.0
    groups = []
    for k in range(n_batches):
        reqs = []
        for j in range(mix["max_batch"]):
            i = k * mix["max_batch"] + j
            r = harness.Request(f"r{i}", i, traffic.prompt_len(i), None, 0.5)
            run.requests[r.id] = r
            reqs.append({"id": r.id, "prompt": traffic.prompt(i)})
        for out in eng.generate_batch(reqs):
            run.requests[out["id"]].tokens = out["tokens"]
        b = harness.Batch(k, [r["id"] for r in reqs], max(len(r["prompt"]) for r in reqs), 0.5)
        groups.append((b, list(range(len(reqs)))))
    g, g8, _ = check.gaps(run, w, conf, groups, traffic, True, torch.device("cpu"))
    return ({"max": float(g.max()), "mean": float(g.mean())},
            {"max": float(g8.max()), "mean": float(g8.mean())})


@pytest.mark.parametrize("family,mixname", [("hybrid", "chat"), ("hybrid", "longprompt")])
def test_the_fp8_control_fails_where_the_program_passes(family, mixname):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        reads = [readings(family, mixname, seed, 6) for seed in (1, 2, 3)]
    finally:
        torch.set_num_threads(threads)
    stat, _, _, limit = READINGS[mixname]
    program = [p[stat] for p, _ in reads]
    control = [c[stat] for _, c in reads]
    assert max(program) <= limit < min(control), (program, control)
