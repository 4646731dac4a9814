#!/usr/bin/env python3
"""Time a process shard's start on the card under each start method that
gives it a fresh CUDA context: ``spawn``, and ``forkserver`` with ``torch``
and the shard runtime preloaded in the server.

    python3 scripts/shard_start.py [--device cuda] [--shards 4] [--rounds 2]

For each method, in turns (spawn, forkserver, forkserver, spawn for two
rounds), a fresh ProcessShardPool on a temporary root under ``build/``
starts ``--shards`` shards (``start_s``: spawn or fork, imports, the ready
handshake and the first rebalance), then drains a small join (``join_s``:
each shard's first join call creates its CUDA context and loads K1).  The
first forkserver start includes starting the server.  Prints one JSON line
per start and, last, the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def one_start(method: str, device: str, shards: int, root: Path) -> dict:
    from repro_torch.bus import ProcessShardPool
    from repro_torch.core import make_trigger, termination_event

    pool = ProcessShardPool(str(root), num_partitions=8, device=device,
                            start_method=method)
    try:
        pool.create_workflow("w")
        for t in range(32):
            pool.add_trigger("w", make_trigger(
                f"j{t}", condition={"name": "counter", "expected": 64, "aggregate": False},
                action={"name": "noop"}, trigger_id=f"jt{t}", transient=False))
        pool.publish_batch("w", [termination_event(f"j{i % 32}", i) for i in range(32 * 64)])
        t0 = time.perf_counter()
        pool.start_shards("w", shards)
        t1 = time.perf_counter()
        pool.wait_drained("w", timeout=120)
        t2 = time.perf_counter()
        fires = pool.total_fires("w")
    finally:
        pool.stop_all()
    if fires != 32:
        raise AssertionError(f"{method}: {fires} fires, want 32")
    return {"method": method, "device": str(pool.device), "shards": shards,
            "start_s": t1 - t0, "join_s": t2 - t1}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    mp.get_context("forkserver").set_forkserver_preload(["torch", "repro_torch.bus.proc"])
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="shard_start_", dir=ROOT / "build") as tmp:
        i = 0
        for _ in range(args.rounds):
            for method in ("spawn", "forkserver", "forkserver", "spawn"):
                print(json.dumps(one_start(method, args.device, args.shards,
                                           Path(tmp) / f"pool{i}")), flush=True)
                i += 1
    if args.device.startswith("cuda"):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
