"""The readings that set a cell's limit, on the card, in one process.

    python3 bench/control.py --workload <cell> --seconds 8 \
        --seeds 11,12,...  --control-seeds 11,12,13

For each seed: a run of the cell at its own load for ``--seconds`` (with
the drain, long enough to finish the mix's longest requests), then the
comparison on the run's own sample: the program's ``served_logit_gap_max``
and ``served_logit_gap_mean`` (a lower reading is the largest over sound
seeds) and, on the control seeds, ``control_gap_max`` and
``control_gap_mean``: the same gaps for the tokens the reference computed
in fp8 puts first (an upper reading is the smallest).
Prints one JSON line a seed and a summary; the benchmark's own runs never
run this.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args()
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(ROOT / "build" / "bench-cache" / sub)
    sys.path[:0] = [str(ROOT / "src"), str(BENCH)]
    import torch

    from benchlib import harness
    from benchlib.spec import Spec

    if not torch.cuda.is_available():
        print("control: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _cuda

    _cuda.build()
    spec = Spec(ROOT)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    program, fp8 = [], []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        res = harness.run_cell(spec, args.workload, seed, args.seconds, False, "cuda:0",
                               time.perf_counter(), control=seed in control)
        line = {"seed": seed, "failed": res["failed"], "attempted": res["attempted"],
                "s": time.perf_counter() - t0, **res["info"]}
        print(json.dumps(line), flush=True)
        program.append(line)
        if seed in control:
            fp8.append(line)
    summary = {"workload": args.workload, "card": torch.cuda.get_device_name(0)}
    for stat in ("max", "mean"):
        summary[f"lower_reading_{stat}"] = max(p[f"served_logit_gap_{stat}"] for p in program)
        if fp8:
            summary[f"upper_reading_{stat}"] = min(c[f"control_gap_{stat}"] for c in fp8)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
