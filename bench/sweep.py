"""Find an open-loop cell's knee once, by a sweep of fixed rates on the card.

    python3 bench/sweep.py --workload zamba2-1.2b.chat-every-batch --rates 16,18,20,22,24

One run of the cell for each rate (the mix's other parameters as its file
has them), in one process.  For each rate it prints the rate offered and
completed inside the window, the requests sent but not done at the close
(the backlog), the median service time of a batch, and the 95th
percentile of the first and the second half of the window's requests: a
rate the system sustains completes what it is offered and its second
half's tail is no longer than its first's.  The cell's rate is then set in
its mix file, at four fifths of the highest rate sustained.
"""
import time

import argparse
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seed", type=int, default=77)
    args = ap.parse_args()
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(ROOT / "build" / "bench-cache" / sub)
    sys.path[:0] = [str(ROOT / "src"), str(BENCH)]
    import numpy as np
    import torch

    from benchlib import harness
    from benchlib.spec import Spec

    if not torch.cuda.is_available():
        print("sweep: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _cuda

    _cuda.build()
    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    for rate in [float(r) for r in args.rates.split(",")]:
        mix = dict(spec.mix(cell["traffic"]), rate_per_s=rate)
        keep = {}
        res = harness.run_cell(spec, args.workload, args.seed, args.seconds, False, "cuda:0",
                               time.perf_counter(), mix=mix, keep=keep)
        run = keep["run"]
        counted = sorted(run.counted(), key=lambda r: r.due)
        half = len(counted) // 2
        lat = [(r.done - r.due) * 1e3 for r in counted if r.done is not None]
        sent = [r for r in run.requests.values() if r.sent <= run.t_close]
        done = [r for r in run.requests.values() if r.done is not None and r.done <= run.t_close]
        print(json.dumps({
            "rate": rate, "offered_per_s": len(sent) / args.seconds,
            "done_per_s": len(done) / args.seconds, "backlog_at_close": len(sent) - len(done),
            "p95_first_half_ms": float(np.percentile(lat[:half], 95)),
            "p95_second_half_ms": float(np.percentile(lat[half:], 95)),
            "request_p95_ms": res["metrics"]["request_p95_ms"]["value"],
            "batch_s_median": res["info"]["batch_s_median"], "batches": res["info"]["batches"],
            "lateness_ms_p99": res["info"]["lateness_ms_p99"],
            "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
