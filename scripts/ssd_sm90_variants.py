#!/usr/bin/env python3
"""Time edited copies of the sm90 SSD scan kernel beside the kernel itself.

    python3 scripts/ssd_sm90_variants.py [--rounds 2]

Each variant is ``src/repro_torch/csrc/ssd_scan_sm90.cu`` with one edit
(``VARIANTS``), built by ``nvcc`` with the port's flags into
``build/variants/`` and loaded with ctypes like the kernel itself.  At
zamba2-1.2b's prefill shape (B 4, S 1024, H 64, P = N = 64, Q 128, bf16)
each is held against the sm90 route's plain version with chip_smoke.py's
``ssd_excess`` (the variants that drop work are wrong by design and only
timed), then timed in rounds, the variants in turn within a round: device
time per call from torch.profiler, each of the three kernels apart, and
CUDA events over back-to-back calls.  Prints one JSON line per variant
and round, then the card's name and power limit.  Needs a CUDA card and
nvcc; exits 2 without.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name: (text in the source, its replacement, whether the result is right)
VARIANTS = {
    "kernel": (None, None, True),
    "exact_exp": ("__expf(li - lj)", "expf(li - lj)", True),
    "heads4": ("constexpr int kHT = 8;", "constexpr int kHT = 4;", True),
    "heads2": ("constexpr int kHT = 8;", "constexpr int kHT = 2;", True),
    "unbalanced": ("const int ti = warp < 4 ? warp : 11 - warp;", "const int ti = warp;", True),
    "no_mma": ('asm volatile(\n      "mma.sync', 'if (0) asm volatile(\n      "mma.sync', False),
    "no_exp": ("gv * __expf(li - lj) * dtj", "gv * dtj", False),
}


def build(names):
    from repro_torch.kernels import _cuda

    src = (_cuda.CSRC / "ssd_scan_sm90.cu").read_text()
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        old, new, _ = VARIANTS[name]
        if old is not None and old not in src:
            raise SystemExit(f"variant {name}: {old!r} is not in the source")
        text = src if old is None else src.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
               str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"variant {name} did not build:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        for fn, restype, argtypes in _cuda._SIGNATURES["ssd_scan_sm90"]:
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
    return libs


def launcher(lib, x, dt, Bm, Cm, a, Q):
    """The wrapper's launch (ops.ssd_sm90) with another library."""
    import torch

    B, S, H, P = x.shape
    nc = -(-S // Q)
    y = torch.empty_like(x)
    state = torch.empty(B, H, 64, 64, device=x.device)
    scratch = torch.empty(B, nc, H, 64, 64, device=x.device)
    decay = torch.empty(B, nc, H, device=x.device)

    def run():
        err = lib.ssd_scan_sm90_launch(
            x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), a.data_ptr(),
            y.data_ptr(), state.data_ptr(), scratch.data_ptr(), decay.data_ptr(), B, S, H,
            64, 1, Q, x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1),
            dt.stride(2), Bm.stride(0), Bm.stride(1), 64, Cm.stride(0), Cm.stride(1), 64, 0,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return y, state
    return run


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--only", nargs="*", default=list(VARIANTS))
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ssd_sm90_variants: CUDA is not available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels.ssd import ops

    libs = build(args.only)
    B, S, H, Q = 4, 1024, 64, 128
    x, dt, Bm, Cm, a = cs._ssd_inputs(B, S, H, 64, 64, torch.bfloat16, 99)
    x = x.contiguous()
    want_y, want_state = ops.ssd_plain(x, dt, Bm, Cm, a, chunk=Q)
    runs = {name: launcher(lib, x, dt, Bm, Cm, a, Q) for name, lib in libs.items()}
    excess = {}
    for name, run in runs.items():
        y, state = run()
        torch.cuda.synchronize()
        excess[name] = max(cs.ssd_excess(y, want_y)[1], cs.ssd_excess(state, want_state)[1])
        if VARIANTS[name][2] and not excess[name] <= 0:
            raise SystemExit(f"variant {name} differs from the plain version: excess "
                             f"{excess[name]}")
    for rnd in range(args.rounds):
        for name, run in runs.items():
            prof = cs.device_profile(run, 20, top=3)
            print(json.dumps({"variant": name, "round": rnd, "excess": excess[name],
                              "right": VARIANTS[name][2], "ms": prof["device_ms"],
                              "kernels_ms": {n.split("::")[1].split("(")[0]: t
                                             for n, t in prof["top_ms"]},
                              "event_ms": cs.cuda_ms(run, 50)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
