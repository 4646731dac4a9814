"""Perf hill-climbing: hypothesis → change → re-trace → re-analyse,
on the port's dry-run (``launch.dryrun``), with the reference's cells,
variants, overrides and patches.

Each cell gets an ordered list of named variants (sharding-rule overrides /
model-config patches / step knobs).  Every variant re-runs the full affine
probe analysis and is logged to
``results/torch/hillclimb/<cell>__<variant>.json``.  The hypotheses are the
reference's, without the figures it reckoned on its own hardware; the
port's terms come from the H100 datasheet constants of
``distributed.hlo_analysis``.  Like the dry-run, this allocates no device
memory at all, and its fake process group must own the interpreter.

    python -m repro_torch.launch.hillclimb --cell C            # one cell
    python -m repro_torch.launch.hillclimb --all
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.launch.dryrun import RESULTS_DIR, analyze_cell, init_fake_world

HILL_DIR = os.path.join(os.path.dirname(RESULTS_DIR), "hillclimb")


# (variant_name, hypothesis, overrides, config_patch, probe_patch, accum)
Variant = Tuple[str, str, Optional[Dict], Optional[Dict], Optional[Dict], int]

CELLS: Dict[str, Dict[str, Any]] = {
    "A": {
        "arch": "zamba2-1.2b", "shape": "train_4k",
        "why": "the reference's worst non-decode roofline fraction, memory-dominated",
        "variants": [
            ("remat_dots",
             "memory term is recompute-dominated: saving matmul outputs "
             "(dots policy) removes most backward recompute reads/writes; "
             "expect t_memory and t_compute down",
             None, {"remat_policy": "dots"}, None, 1),
            ("ssd_chunk_256",
             "larger SSD chunks quarter the number of inter-chunk state "
             "round-trips ([B,H,N,P] states written/read per chunk) but double "
             "the decay-matrix bytes (Q² per chunk); net t_memory down "
             "for N·P=4096 >> Q=128",
             None, {"ssm_chunk": 256}, None, 1),
            ("no_fsdp",
             "d_model=2048 is small: FSDP all-gathers of every weight 3×/step "
             "cost more than replicating 1.2B params; expect "
             "t_collective down sharply, memory about unchanged",
             {"embed": ()}, None, None, 1),
            ("ssd_chunk_64",
             "iteration 2 (the reference refuted ssd_chunk_256): the memory hog "
             "is the fp32 intra-chunk decay tensor B·nc·Q²·H·4B — QUADRATIC "
             "in Q, so SMALLER chunks win: Q=64 halves decay bytes "
             "(nc doubles, Q² quarters); predict t_memory down",
             None, {"ssm_chunk": 64}, None, 1),
            ("decay_bf16",
             "iteration 3 (chunk-size levers refuted: Q**2 tensor is not the "
             "bottleneck alone — the whole fp32 ELEMENTWISE CHAIN over "
             "[B,nc,Q,Q,H] is: broadcast-sub, exp, mask-mul, gate-mul each "
             "count full operands). Computing the decay chain in bf16 halves "
             "every operand in that chain; predict t_memory down",
             None, {"ssd_decay_dtype": "bf16"}, None, 1),
            ("combined_best",
             "stack the confirmed wins: dots remat + bf16 decay chain",
             None, {"remat_policy": "dots", "ssd_decay_dtype": "bf16"}, None, 1),
        ],
    },
    "B": {
        "arch": "deepseek-v2-236b", "shape": "train_4k",
        "why": "the reference's most collective-bound cell",
        "variants": [
            ("capacity_1_0",
             "MoE dispatch traffic and expert FLOPs scale with the capacity "
             "factor; cf 1.25→1.0 cuts expert-side all-to-all/gather volume "
             "and padded expert compute by 20%",
             None, {"capacity_factor": 1.0}, None, 1),
            ("no_seq_shard",
             "activation seq-sharding between blocks forces two all-to-alls "
             "per layer (seq↔heads reshard); dropping it trades those for "
             "replicated-activation memory; expect t_collective down, "
             "t_memory up",
             {"act_seq": ()}, None, None, 1),
            ("experts_data",
             "routing experts over the data axis instead of model: token "
             "gather/scatter then crosses the axis tokens are already "
             "sharded on, halving cross-axis exchange volume",
             {"experts": ("data",), "embed": ()}, None, None, 1),
            ("combined_best",
             "stack the confirmed wins",
             {"act_seq": ()}, {"capacity_factor": 1.0}, None, 1),
        ],
    },
    "C": {
        "arch": "deepseek-67b", "shape": "decode_32k",
        "why": "decode/serving cell whose collectives dominate in the reference "
               "(KV-cache all-gathers every layer)",
        "variants": [
            ("cache_seq_sharded",
             "pin the KV cache to (batch→data, seq→model): attention becomes "
             "a partial softmax over seq shards (small stat reductions) "
             "instead of all-gathering the cache every layer; expect "
             "t_collective and t_memory down (cache reads sharded)",
             {"seq_kv": ("model",)}, None, None, 1),
            ("cache_seq_sharded_batch_model",
             "additionally let the 128-seq batch use leftover capacity — "
             "keep seq→model and verify logits path isn't regressed",
             {"seq_kv": ("model",), "vocab": ("model",)}, None, None, 1),
        ],
    },
}


def run_cell(cell_key: str, only: Optional[str] = None,
             reuse_baseline: bool = False) -> List[dict]:
    os.makedirs(HILL_DIR, exist_ok=True)
    spec = CELLS[cell_key]
    arch, shape = spec["arch"], spec["shape"]
    results = []
    base_path = os.path.join(HILL_DIR,
                             f"{cell_key}_{arch}_{shape}__baseline.json")
    if reuse_baseline and os.path.exists(base_path):
        with open(base_path) as f:
            base = json.load(f)
    else:
        base = analyze_cell(arch, shape)
    base["variant"] = "baseline"
    base["hypothesis"] = spec["why"]
    _save(cell_key, "baseline", base)
    results.append(base)
    _report(cell_key, base, base)
    for name, hypothesis, overrides, patch, probe_patch, accum in spec["variants"]:
        if only and name != only:
            continue
        res = analyze_cell(arch, shape, config_patch=patch, overrides=overrides,
                           probe_patch=probe_patch)
        res["variant"] = name
        res["hypothesis"] = hypothesis
        _save(cell_key, name, res)
        results.append(res)
        _report(cell_key, res, base)
    return results


def _save(cell_key: str, variant: str, res: dict) -> None:
    spec = CELLS[cell_key]
    path = os.path.join(
        HILL_DIR, f"{cell_key}_{spec['arch']}_{spec['shape']}__{variant}.json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1)


def _report(cell_key: str, res: dict, base: dict) -> None:
    if res.get("status") != "ok" or base.get("status") != "ok":
        print(f"[{cell_key}:{res.get('variant')}] FAILED: "
              f"{res.get('error') or base.get('error')}", flush=True)
        return
    t, tb = res["roofline"], base["roofline"]
    dom = base["dominant"]
    delta = (t[dom] - tb[dom]) / tb[dom] * 100 if tb[dom] else 0.0
    print(f"[{cell_key}:{res['variant']:28s}] compute={t['t_compute']:.3e} "
          f"memory={t['t_memory']:.3e} coll={t['t_collective']:.3e} "
          f"| baseline-dominant {dom} {delta:+.1f}%", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=list(CELLS), default=None)
    ap.add_argument("--variant", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--reuse-baseline", action="store_true")
    args = ap.parse_args()
    init_fake_world()
    cells = list(CELLS) if (args.all or not args.cell) else [args.cell]
    failed = 0
    for c in cells:
        failed += sum(r.get("status") != "ok"
                      for r in run_cell(c, only=args.variant,
                                        reuse_baseline=args.reuse_baseline))
    raise SystemExit(1 if failed else 0)


if __name__ == "__main__":
    main()
