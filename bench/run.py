"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, then ``info`` and, last, ``compared``: each number the
correctness check compared, beside its limit.  Those numbers are also the
last lines of standard error.  Without CUDA, with fewer cards than the
cell asks for, or with JAX or the JAX package loaded once the window has
closed, it prints no result and exits non-zero.
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
CACHE = ROOT / "build" / "bench-cache"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    # every cache a run may write stays at a fixed path inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT / "src"), str(BENCH)]

    import torch

    from benchlib import harness, imports
    from benchlib.spec import Spec

    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("bench: CUDA is not available; no result", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"bench: {args.workload} needs {cell['chips']} cards, this machine has "
              f"{torch.cuda.device_count()}; no result", file=sys.stderr)
        return 2
    from repro_torch.kernels import _cuda

    _cuda.build()                      # every kernel, in parallel; a no-op once built
    torch.cuda.set_device(0)
    result = harness.run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda:0", T_PROCESS)
    bad = imports.forbidden()
    if bad:
        print(f"bench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    keys = ("correct", "attempted", "failed", "metrics", "device", "breakdown", "info",
            "compared")
    print(json.dumps({k: result[k] for k in keys if k in result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
