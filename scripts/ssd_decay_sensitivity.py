#!/usr/bin/env python3
"""How far two SSD forms that differ only in the order of their fp32 sums
move zamba2-1.2b's bf16 loss, with the fp32 decay and with the bf16 decay
(``ssd_decay_dtype``): the floor that a kernel's loss is held to against
its plain version's.

    python3 scripts/ssd_decay_sensitivity.py [--layers 8] [--device cpu]

The model is zamba2-1.2b at full width, ``--layers`` deep, bf16, seed 0,
on 2 seeded sequences of 512 tokens.  For each decay type, the loss with
``ssd_scan_torch(split=True)`` (the sm90 route's plain version) and with
``split=False``: with a bf16 decay the two compute the same products and
differ in their fp32 summation order alone.  Prints one JSON line per
decay type.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def main() -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd.ref import ssd_scan_torch
    from repro_torch.models import Model, ssm

    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    cfg = dataclasses.replace(get_config("zamba2-1.2b"), n_layers=args.layers)
    model = Model(cfg, device=args.device, seed=0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 512)))
    tokens = tokens.long().to(args.device)
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}

    def loss(decay, split):
        model.cfg = dataclasses.replace(cfg, ssd_decay_dtype=decay)
        ssm.ssd = lambda x, dt, Bm, Cm, a, chunk, decay_dtype: ssd_scan_torch(
            x, dt, Bm, Cm, a, chunk, decay_dtype=decay_dtype, split=split)
        with torch.no_grad():
            return float(model.loss(batch)[0])

    for decay in (torch.float32, torch.bfloat16):
        split, unsplit = loss(decay, True), loss(decay, False)
        print(json.dumps({"decay": str(decay)[6:], "layers": args.layers,
                          "loss_split": split, "loss_unsplit": unsplit,
                          "rel_gap": abs(split - unsplit) / abs(unsplit)}), flush=True)


if __name__ == "__main__":
    main()
