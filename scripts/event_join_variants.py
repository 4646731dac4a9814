#!/usr/bin/env python3
"""Time edited copies of the event-join kernel (K1) beside the kernel itself.

    python3 scripts/event_join_variants.py [--rounds 2]

Each variant is ``src/repro_torch/csrc/event_join.cu`` with its edits
(``VARIANTS``), built by ``nvcc`` with the port's flags into
``build/variants/`` and loaded with ctypes like the kernel itself.  At each
shape of ``SHAPES`` every variant is held against the plain version,
exactly, with one zeroed scratch kept across all its calls, which must read
back as zero after them; then the variants are timed in rounds, in turn
within a round: device time per call from torch.profiler and CUDA events
over back-to-back calls.  Each round also times the join backend's call,
host to host (numpy in, numpy out), with the kernel and with the variant
that copies each way (``copies``), in turns, at ``HOST_SHAPES``.  Prints one
JSON line per variant, shape and round, then the card's name and power
limit.  Needs a CUDA card and nvcc; exits 2 without.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name: [(text in the source, its replacement), ...]
VARIANTS = {
    "kernel": [],
    # clusters of 8 blocks: each cluster's blocks add their bins into the
    # leader's through distributed shared memory, and the leaders alone add
    # into acc and take tickets
    "clusters_8": [
        ("#include <cuda_runtime.h>\n",
         "#include <cooperative_groups.h>\n#include <cuda_runtime.h>\n"
         "namespace cg = cooperative_groups;\n"),
        ("  if (kShared) {\n    __syncthreads();\n    int* acc = scratch + 1;\n",
         "  unsigned arrivals = gridDim.x;\n"
         "  if (kShared) {\n"
         "    cg::cluster_group cluster = cg::this_cluster();\n"
         "    cluster.sync();\n"
         "    if (cluster.block_rank() != 0) {\n"
         "      int* lead = cluster.map_shared_rank(bins, 0);\n"
         "      for (int i = tid; i < T; i += kThreads) {\n"
         "        const int c = bins[i];\n"
         "        if (c) atomicAdd(&lead[i], c);\n"
         "      }\n"
         "    }\n"
         "    cluster.sync();\n"
         "    if (cluster.block_rank() != 0) return;\n"
         "    arrivals /= cluster.num_blocks();\n"
         "    int* acc = scratch + 1;\n"),
        ("== gridDim.x - 1;", "== arrivals - 1;"),
        ("  join<true><<<blocks, kThreads, smem, s>>>(events, n, counts, expected, T, out, "
         "scratch);\n  return cudaGetLastError();\n}",
         "  if (blocks == 1) {\n"
         "    join<true><<<1, kThreads, smem, s>>>(events, n, counts, expected, T, out, scratch);\n"
         "    return cudaGetLastError();\n"
         "  }\n"
         "  cudaLaunchConfig_t cfg = {};\n"
         "  cfg.gridDim = dim3((blocks + 7) / 8 * 8);\n"
         "  cfg.blockDim = dim3(kThreads);\n"
         "  cfg.dynamicSmemBytes = smem;\n"
         "  cfg.stream = s;\n"
         "  cudaLaunchAttribute attr[1];\n"
         "  attr[0].id = cudaLaunchAttributeClusterDimension;\n"
         "  attr[0].val.clusterDim.x = 8;\n"
         "  attr[0].val.clusterDim.y = 1;\n"
         "  attr[0].val.clusterDim.z = 1;\n"
         "  cfg.attrs = attr;\n"
         "  cfg.numAttrs = 1;\n"
         "  const cudaError_t e = cudaLaunchKernelEx(&cfg, join<true>, events, n, counts, "
         "expected, T, out, scratch);\n"
         "  return e != cudaSuccess ? e : cudaGetLastError();\n}"),
    ],
    "one_block_2048": [("kOneBlockEvents = 4096;", "kOneBlockEvents = 2048;")],
    "one_block_8192": [("kOneBlockEvents = 4096;", "kOneBlockEvents = 8192;")],
    "block_events_1024": [("kBlockEvents = 2048;", "kBlockEvents = 1024;")],
    "block_events_4096": [("kBlockEvents = 2048;", "kBlockEvents = 4096;")],
    "block_events_8192": [("kBlockEvents = 2048;", "kBlockEvents = 8192;")],
    # the backend's call with one copy each way through device buffers (kept
    # after the scratch: its caller gives it 1 + T + n + 4T ints) in place of
    # the kernel reading and writing the pinned buffers itself
    "copies": [
        ("  const int* in = (const int*)host_in;\n"
         "  const cudaError_t e = launch(in, n, in + n, in + n + T, T, (int*)host_out, "
         "(int*)scratch,\n                               max_blocks, s);\n",
         "  int* in = (int*)scratch + 1 + T;\n"
         "  int* out = in + n + 2 * T;\n"
         "  cudaError_t e = cudaMemcpyAsync(in, host_in, (size_t)(n + 2LL * T) * sizeof(int),\n"
         "                                  cudaMemcpyHostToDevice, s);\n"
         "  if (e == cudaSuccess)\n"
         "    e = launch(in, n, in + n, in + n + T, T, out, (int*)scratch, max_blocks, s);\n"
         "  if (e == cudaSuccess)\n"
         "    e = cudaMemcpyAsync(host_out, out, 2 * (size_t)T * sizeof(int),\n"
         "                        cudaMemcpyDeviceToHost, s);\n"),
    ],
}
# (kind, n, T): the worker's batches (contiguous runs of one row id) at the
# one-block threshold and past it, then random ids in [-1, T + 3) at the
# main path's shape, around the threshold, at phase k1's multi-block shapes
# and past the shared-memory bins
SHAPES = [("runs", 4096, 100), ("runs", 8192, 100), ("random", 4096, 100),
          ("random", 8192, 100), ("random", 16384, 100), ("random", 65536, 100),
          ("random", 200_000, 100), ("random", 1_048_576, 4096), ("random", 100_000, 60_000)]
# the backend's call, host to host: the kernel beside the copying variant
HOST_SHAPES = [("runs", 4096, 100), ("random", 200_000, 100), ("random", 1_048_576, 4096)]


def build(names):
    from repro_torch.kernels import _cuda

    src = (_cuda.CSRC / "event_join.cu").read_text()
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} is not in the source once")
            text = text.replace(old, new)
        (out / f"ej_{name}.cu").write_text(text)
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(out / f"libej_{name}.so"),
               str(out / f"ej_{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"variant {name} did not build:\n{log}")
        lib = ctypes.CDLL(str(out / f"libej_{name}.so"))
        for fn, restype, argtypes in _cuda._SIGNATURES["event_join"]:
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
    return libs


def launcher(lib, events, counts, expected, scratch, blocks):
    """The wrapper's launch (ops.event_join) with another library and a
    scratch kept across calls."""
    import torch

    T = counts.shape[0]
    out = torch.empty(2 * T, dtype=torch.int32, device=events.device)

    def run():
        err = lib.event_join_launch(events.data_ptr(), events.shape[0], counts.data_ptr(),
                                    expected.data_ptr(), T, out.data_ptr(), scratch.data_ptr(),
                                    blocks, events.device.index,
                                    torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err} "
                               f"({lib.event_join_error_string(err).decode()})")
        return out
    return run


def _inputs(rng, kind, n, T):
    import numpy as np

    if kind == "runs":
        events = np.repeat(np.arange(T, dtype=np.int32), n // T + 1)[:n]
    else:
        events = rng.integers(-1, T + 3, n).astype(np.int32)
    return events, rng.integers(0, 5, T).astype(np.int32), \
        rng.integers(1, 3000, T).astype(np.int32)


def host_caller(lib, n, T, copies, blocks):
    """The join backend's call (dispatch.CudaJoin) with another library:
    pack into a pinned buffer, one C call, unpack."""
    import torch

    from repro_torch.kernels.event_join import dispatch

    host_in = torch.empty(n + 2 * T, dtype=torch.int32, pin_memory=True)
    host_out = torch.empty(2 * T, dtype=torch.int32, pin_memory=True)
    scratch = torch.zeros(1 + T + (n + 4 * T if copies else 0), dtype=torch.int32,
                          device="cuda")
    stream = torch.cuda.Stream()
    torch.cuda.synchronize()
    host_in_np, host_out_np = host_in.numpy(), host_out.numpy()

    def call(events, counts, expected):
        n, T = dispatch.pack_inputs(host_in_np, events, counts, expected)
        err = lib.event_join_roundtrip(host_in.data_ptr(), n, T, host_out.data_ptr(),
                                       scratch.data_ptr(), blocks, 0, stream.cuda_stream)
        if err:
            raise RuntimeError(f"roundtrip failed: CUDA error {err}")
        return dispatch.unpack_outputs(host_out_np, T)
    return call


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--only", nargs="*", default=list(VARIANTS))
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("event_join_variants: CUDA is not available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels.event_join import ops
    from repro_torch.kernels.event_join.ref import join_counts_torch

    libs = build(args.only)
    blocks = ops.max_blocks(0)
    rng = np.random.default_rng(0)
    runs = {}
    for kind, n, T in SHAPES:
        host = [torch.from_numpy(a) for a in _inputs(rng, kind, n, T)]
        want = torch.cat(join_counts_torch(*host))
        dev = [t.cuda() for t in host]
        for name, lib in libs.items():
            scratch = torch.zeros(1 + T, dtype=torch.int32, device="cuda")
            run = launcher(lib, *dev, scratch, blocks)
            for _ in range(3):
                got = run()
            torch.cuda.synchronize()
            if not torch.equal(got.cpu(), want) or scratch.count_nonzero().item():
                raise SystemExit(f"variant {name} at {kind} n {n}, T {T}: wrong outputs or "
                                 f"a scratch left nonzero")
            runs[(name, kind, n, T)] = (run, scratch)
    hosts = {}
    for kind, n, T in HOST_SHAPES:
        inputs = _inputs(rng, kind, n, T)
        want = [t.numpy() for t in join_counts_torch(*(torch.from_numpy(a) for a in inputs))]
        for name in ("kernel", "copies"):
            if name in libs:
                call = host_caller(libs[name], n, T, name == "copies", blocks)
                if not all(np.array_equal(g, w) for g, w in zip(call(*inputs), want)):
                    raise SystemExit(f"variant {name}: the host call at {kind} n {n}, T {T} "
                                     f"is wrong")
                hosts[(name, kind, n, T)] = (call, inputs)
    for rnd in range(args.rounds):
        for (name, kind, n, T), (run, scratch) in runs.items():
            prof = cs.device_profile(run, 50)
            print(json.dumps({"variant": name, "kind": kind, "n": n, "T": T, "round": rnd,
                              "ms": prof["device_ms"], "device_ops": prof["device_ops"],
                              "event_ms": cs.cuda_ms(run, 200)}), flush=True)
            if scratch.count_nonzero().item():
                raise SystemExit(f"variant {name} at n {n}, T {T} left its scratch nonzero")
        # host to host, in turns: kernel, copies, copies, kernel
        for kind, n, T in HOST_SHAPES:
            iters = 2000 if n <= 8192 else 200
            for name in ("kernel", "copies", "copies", "kernel"):
                if (name, kind, n, T) not in hosts:
                    continue
                call, inputs = hosts[(name, kind, n, T)]
                for _ in range(20):
                    call(*inputs)
                t0 = time.perf_counter()
                for _ in range(iters):
                    call(*inputs)
                print(json.dumps({"host_call": name, "kind": kind, "n": n, "T": T,
                                  "round": rnd, "host_ms": (time.perf_counter() - t0) * 1e3
                                  / iters}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
