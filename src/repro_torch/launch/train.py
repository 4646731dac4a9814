"""Training launcher: a trigger-orchestrated training run.

    python -m repro_torch.launch.train --arch llama3.2-3b --steps 100 \\
        [--smoke] [--workdir DIR] [--batch 8 --seq 256] [--device cuda]
    python -m repro_torch.launch.train --arch llama3.2-3b --smoke --device cpu

The training loop is a Triggerflow state-machine workflow (a checkpoint
per chunk, resumed by event replay plus the latest checkpoint): kill and
relaunch on the same workdir to resume.  It runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from ..configs import ARCHS, get_config
from ..training.trainer import run_training


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--chunk-steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=args.smoke)
    workdir = args.workdir or os.path.join(tempfile.gettempdir(), f"tf-train-{cfg.arch}")
    print(f"arch={cfg.arch} params={cfg.param_count() / 1e6:.1f}M "
          f"workdir={workdir} device={args.device}")
    out = run_training(cfg, workdir, total_steps=args.steps,
                       chunk_steps=args.chunk_steps, batch=args.batch,
                       seq=args.seq, peak_lr=args.lr, device=args.device)
    print("status:", out["workflow_result"]["status"])
    for rec in out["history"]:
        print(f"  step {rec['step']:5d} loss {rec['loss_mean']:.4f} "
              f"({rec['wall_s']}s)")


if __name__ == "__main__":
    main()
