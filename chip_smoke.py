#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero. Each
model of phases 12-15 prints its depth cut, peak GiB, seconds, prefill ms,
decode ms a token and the device's busy share:

1. build     compile the CUDA kernels from src/repro_torch/csrc (one nvcc
             per source, all at once);
2. K1        event_join against its plain torch version, exact, through the
             tensor API and through the join backend (CudaJoin, whose
             scratch must read back as zero after each call), on every path
             of the kernel; timed at the main path's shape through the
             backend (the main path's K1, on pinned host memory, bound by
             PCIe) beside the plain version of that call, torch.bincount
             (the yardstick, which the port never calls), the tensor API on
             device memory and one elementwise launch (the launch floor);
             one call of each wrapper profiled (one kernel, no memset, no
             copy); the backend's whole call, host to host, in turns with
             the CPU backend;
3. K2        flash_attention's two kernels, each against its own plain torch
             version: the scalar kernel (csrc/flash_attention.cu) on every
             case, the sm90 kernel (csrc/flash_attention_sm90.cu, wgmma and
             TMA) on every case that takes its route (bf16, (D, Dv) one of
             (64, 64), (128, 128), (192, 128)) and on more at the serving
             shapes, deepseek-v2's D 192 / Dv 128 included; a misaligned
             view must raise; both timed at the serving shapes of
             llama3.2-3b and zamba2-1.2b beside scaled_dot_product_attention
             (the yardstick only);
4. K3        ssd_scan's two kernels, each against its own plain torch
             version (y and the final state): the scalar kernel
             (csrc/ssd_scan.cu) over chunks of 16, 64 and 128, ragged and
             single-chunk sequences, bf16 and fp32, and zamba2-1.2b's prefill
             shape; the sm90 kernel (csrc/ssd_scan_sm90.cu, mma.sync tensor
             cores, three kernels split over chunks) on every case that
             takes its route (bf16, N = P = 64) and on two more at the
             serving shape; a misaligned view must raise; the plain version
             against the time recurrence; both timed at the prefill shape (no
             single PyTorch call computes the SSD scan, so there is no
             yardstick); the gradients of ssd under autograd (the sm90
             kernel forward, the plain backward) against those of the sm90
             route's plain version at a small shape;
5. join      the Table-1 join (100 triggers x 2000 events) through the port's
             Triggerflow, on the card and on the CPU in turns (card, CPU,
             CPU, card): 100 fires on each, through K1 on the worker's own
             card (one launch a triage call), the same final counts on
             each as on the CPU with the plain torch backend;
6. serving   llama3.2-3b at full width in bf16 with seeded random weights:
             8 requests through ServingEngine under KedaAutoscaler, K2's
             sm90 kernel on every prefill layer; then, on the first batch, K2
             against the sm90 route's plain version at every layer's own
             inputs, and the logits at every position with K2 against those
             with that plain attention swapped in (and against a deliberately
             wrong attention, which must fail the same tolerance);
7. hybrid    zamba2-1.2b at full width in bf16, the same 8 requests: K3's
             sm90 kernel on every Mamba2 prefill layer and K2's sm90 kernel
             at every shared-attention site; then, on the first batch, K3
             against the sm90 route's plain version at every layer's own
             inputs (bf16, as served), where the SSD without its state
             between chunks must fail the same check; and the logits at
             every position with K3, with the plain SSD swapped in, with the
             plain SSD at another chunk (equally right: the rounding floor)
             and with a deliberately wrong SSD (the plain version with the
             state between chunks dropped), with the activations in fp32:
             in bf16 rounding alone moves the logits of this 38-layer
             random-weight model by O(1).  These fp32 forwards take the
             scalar routes of K2 and K3.  The decode step's state update
             (csrc/ssd_step.cu): launched once a Mamba2 layer in the
             graph's warm-up and capture, and run in every layer of every
             profiled replayed step; then 16 decode steps of the first
             batch op by op, the kernel against its plain version at every
             layer-step's own inputs, where the step without its inflow
             B (dt x) must fail the same check; both timed at the chat and
             longprompt cells' shapes (B 64 and 8, H 64, N = P = 64);
8. shards    the Table-1 join through a ProcessShardPool of 4 shard
             processes over 8 partitions of a FilePartitionedEventStore
             (the pool's defaults: batches of 512, every_batch, fsync), on
             the card (shards from the forkserver) and on the CPU (forked
             shards), in turns twice (card, CPU, CPU, card): 100 fires and
             the CPU run's contexts on each; in the card's shards K1 on the
             pool's card, one launch per triage call, counted in the shard
             processes by ShardJoinCounts (a child_init) into shared memory;
             the shards' start time, events/s, seconds in join calls;
9. scale     tests/test_autoscale.py's Fig. 8 lifecycle on a ProcessShardPool
             under KedaAutoscaler, card, CPU, CPU, card: burst, scale up,
             drain to zero, a second burst scales from zero; the time from
             the second publish to its first fire (and to its first join
             call), the cold start a shard adds;
10. chaos    run_soak_proc on the card (seeded SIGKILLs, a torn segment
             tail; exactly-once results equal to the oracle), whose `true`
             triggers make no join call; then the Table-1 join's shape on
             the card under the same kind of chaos: no event lost or
             committed twice, every count at least its events (a plain
             counter is at-least-once), K1 launches equal to triage calls;
11. orchestrators  the DAG diamond and map-join chain, an ASL state machine
             with choice, parallel and map, workflow-as-code with
             suspend/replay and one federated-learning run with threshold
             and timeout, on Triggerflow(device="cuda"), equal to a
             device="cpu" run (they keep their event log: no K1);
12. vlm      qwen2-vl-72b at full width, 16 of its 80 layers (the depth that
             fits the card beside the checks), bf16, seeded random weights:
             8 requests through ServingEngine under KedaAutoscaler, K2's sm90
             kernel (64/8 heads, G = 8) on every prefill layer; then a
             model-level prefill of 4 prompts that each carry 1024 patch
             embeddings with positions3 a (t, h, w) grid over them, and 16
             decode steps; on that batch, K2 against the sm90 route's plain
             version at every layer's own inputs and the logits at every
             position with K2, with that plain version and with a wrong
             attention, as in phase 6;
13. audio    musicgen-large at full width, 16 of its 48 layers, at the model
             level (the engine takes [B, S] prompts; these are [B, 4, S]
             codebook grids): 8 seeded prompts of 128-1024 frames, 4 to a
             batch, prefill and 16 greedy decode steps, K2's sm90 kernel (32
             heads of 64) on every prefill layer; the checks of phase 12 on
             the first batch;
14. moe      phi3.5-moe at full width, 8 of its 32 layers: the 8 requests of
             phase 6, K2's sm90 kernel (32/8 heads) on every prefill layer;
             the token-slots the MoE drops past an expert's capacity in a
             prefill and in each decode step; K2 against its plain version
             at every layer's own inputs in bf16, as served; the logits at
             every position with the activations in fp32 (in bf16 one
             rounding flip in a router sends a token to another expert),
             with K2 (its scalar route), its plain version and a wrong
             attention, counting the token-slots whose expert differs
             between K2 and the plain version;
15. mla_moe  deepseek-v2 at full width, 4 of its 60 layers (layer 0 dense, 3
             MoE): the 8 requests, K2's sm90 kernel (128 heads, D 192, Dv
             128) on every bf16 prefill layer; the checks of phase 14, and
             the bf16 logits with K2 closer to those with the sm90 plain
             version than to those with a wrong attention; the sm90 route's
             share of the prefill's device time; both K2 kernels timed at
             deepseek-v2's prefill shape (B 4, S 1024) beside their plain
             versions and scaled_dot_product_attention;
16. xlstm    xlstm-1.3b at full width, 24 of its 48 layers (sLSTM at 1, 9,
             17; no kernel of K1-K3 behind it, and none may launch): the 8
             requests; the sLSTM scans' share of a prefill's device time and
             the cell steps they run; layer 0's chunked mLSTM against its
             step recurrence and layer 1's sLSTM forward against its step-by-
             step decode, on their own inputs in fp32;
17. train    llama3.2-3b at full width and depth (bf16 parameters, fp32
             moments, batch 8, seq 256, the copy task): the gradients with
             K2 (its autograd Function: the sm90 kernel forward, a plain
             backward) against those with the plain attention, a wrong one
             and the plain one at another tile (the rounding floor); 5
             steps of make_train_step, each profiled (loss, ms, tokens/s,
             busy share, K2's launches and share, the plain backward's
             share, peak memory; remat, the config's "full", recomputes each
             layer's forward, so K2 launches twice a layer a step); then the
             trigger-orchestrated run_training at full width, 2 of 28
             layers: 2 steps, then a new run on the same workdir resumes at
             step 2 with the saved parameters bit for bit; checkpoint save
             and restore timed;
18. distributed  the sharded path on the card's host mesh (1,) ("data",),
             over a one-rank NCCL group on a FileStore under build/:
             llama3.2-3b at full width and depth, 2 train steps without the
             mesh, then 2 with its parameters, gradients and moments
             DTensors and K2's sm90 kernel through local_map in every layer
             (and in remat's recompute): the loss and every leaf's gradient
             against the meshless steps (1e-3 relative L2 a leaf; the same
             local ops, so bit for bit is expected), ms, busy share and peak
             memory of each step; zamba2-1.2b at full size, one bf16 loss on
             the mesh (K3's and K2's sm90 kernels through local_map) and one
             fp32 loss on their scalar routes, against the meshless losses
             and the plain versions' fp32 loss (1e-3 relative), and one bf16
             loss with the bf16 decay (K3-sm90's bf16-decay form, held
             against its plain version on every layer's own inputs; the
             loss within 5e-3 of the plain versions'); then a loss forward
             and backward each, without the mesh and on it, of phi3.5-moe
             (2 of 32 layers, B 4, S 512), deepseek-v2 (2 of 60: layer 0
             dense, one MoE layer; K2-sm90 at D 192 / Dv 128), qwen2-vl-72b
             (4 of 80, B 2, 256 text tokens around 1024 patch embeddings)
             and xlstm-1.3b (4 of 48, layer 1 an sLSTM block; B 4, S 512),
             bf16 at full width: the loss and every leaf's gradient within
             1e-3, K2's launches and backward calls as the attention layers
             and remat predict, the MoE's dropped token-slots equal, each
             one's peak memory; then one dry-run cell (llama3.2-3b ×
             decode_32k, trace only) in a process of its own with no card
             visible; the group is destroyed before the phase returns;
19. moe_decode  the decode step's routed-expert products alone, one MoE
             layer at full width (Nemotron 3 Nano's 128 experts, all held;
             DeepSeek-V2's 160, 20 held) at decode batches 8 and 64, by both
             dropless routes: grouped over the slots (counts on the device)
             and C = T over every held expert; device ms, ms replayed as a
             CUDA graph (each route's replay equal to its op-by-op call bit
             for bit), the experts read, their bytes and the bound at 3.35
             TB/s: the numbers behind the route rule (T·k < E: grouped).

Each kernel's launch count is set to 0 just before the path that should
launch it (phases 5, 6 and 7, the fp32 forwards of 7 for the scalar
kernels of K2 and K3 and its op-by-op decode steps for ssd_step; in phases 8-10, K1's count in the shard processes;
each serving run, model-level run and fp32 check of phases 12-15; the
xlstm run of 16; the 5 train steps and the orchestrated runs of 17; the
mesh's train steps, each zamba2 loss and each family's forward and backward
of 18) and read just after.  Earlier lines print JSON
results, the card's name and power limit and a "kernels" line; the last line
is {"ok": true, "device": {...}}.  Those last lines come only once every
process the phases started has ended (``stop_children``: shards a failed
phase left, multiprocessing's forkserver and resource tracker); one that
will not end fails the script.  Without CUDA, or away from the repo, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_S = 3.35e12                 # H100 SXM HBM3
PEAK_PCIE_BYTES_S = 64e9               # PCIe Gen5 x16, each way (128 GB/s both)
PEAK_OPS_S = {"bfloat16": 989e12,      # dense bf16 tensor cores
              "tfloat32": 494.7e12,    # dense tf32 tensor cores: fp32 operands
              "float32": 67e12,        # fp32 outside the tensor cores
              "int32": 67e12}          # scalar integer ops, taken at the fp32 rate


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Device time per call of ``fn``: CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# the model's kernels by the names of their device functions
KERNEL_NAMES = {"k2_sm90": "flash_fwd_sm90", "k2_scalar": "flash_fwd<",
                "k3_sm90": "ssd_sm90_", "k3_scalar": "ssd_fwd<",
                "ssd_step": "ssd_step_kernel"}


def device_profile(fn, iters: int, top: int = 0, attempts: int = 3) -> dict:
    """Per call of ``fn``: host wall ms (ending in a synchronize), and from
    torch.profiler the summed time of its device activities (kernels,
    copies, fills) and their number, and the time of each of the model's
    kernels (``kernel_ms``).  A profiling session now and then records no
    device activity at all; such a session is run again, up to ``attempts``
    sessions in all (``sessions`` says how many it took).  ``device_ms`` is
    None where none of them saw device activity; wall_ms - device_ms is the
    device's idle time on one stream.  ``kernel_calls``: how many times each
    of the model's kernels ran a call, graph replays' included."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for session in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / iters
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if events:
            break
    dev_us = sum(e.device_time_total for e in events)
    out = {"wall_ms": wall, "device_ms": dev_us / 1e3 / iters if events else None,
           "device_ops": len(events) / iters, "sessions": session}
    by_name: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    out["kernel_ms"] = {k: sum(us for name, us in by_name.items() if pat in name) / 1e3 / iters
                        for k, pat in KERNEL_NAMES.items()}
    out["kernel_calls"] = {k: sum(pat in e.name for e in events) / iters
                           for k, pat in KERNEL_NAMES.items()}
    if top:
        out["top_ms"] = [[name[:80], us / 1e3 / iters] for name, us in
                         sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]
    return out


def kernel_times(iters: int, bound: float = 0.0, **fns) -> dict:
    """For each of ``ms`` (the kernel), ``plain_ms`` and ``library_ms``: the
    device time per call from the profiler, and beside it (``*event_ms``) the
    CUDA-event time per call of back-to-back calls, which is the host's time
    where the host cannot keep the card busy.  Where no profiling session saw
    device activity, or what it saw takes less than ``bound`` (the least time
    the card could take: the profiler missed some of the call's kernels),
    the value is the CUDA-event time; ``timers`` says which clock gave each
    value."""
    out, timers = {}, {}
    for key, fn in fns.items():
        prof = device_profile(fn, iters)
        event_ms = cuda_ms(fn, iters)
        if prof["device_ms"] is None:
            out[key], timers[key] = event_ms, "cuda_events"
        elif prof["device_ms"] < bound:
            out[key] = event_ms
            timers[key] = f"cuda_events: the profiler saw {prof['device_ms']} ms"
        else:
            out[key], timers[key] = prof["device_ms"], f"profiler/{prof['sessions']}"
        out[key.replace("ms", "event_ms")] = event_ms
    out["timers"] = timers
    return out


def attn_excess(got, want) -> tuple:
    """(max |got - want|, max of |got - want| less its tolerance) for a K2
    kernel against its own plain version.  Both compute in fp32 and differ
    only in the summation order (and, on the sm90 route, in the rounding of
    p's second bf16 term, within 2**-16 max|v|), so in bf16 the outputs
    differ by at most one rounding flip: |got - want| <= 2**-7 |want| +
    1e-3, one bf16 ulp of each output with a floor for outputs near 0.  In
    fp32: 1e-4 (summation order over up to 1024 keys).  The check passes
    while the excess is <= 0."""
    import torch

    d = (got.float() - want.float()).abs()
    if want.dtype == torch.bfloat16:
        tol = 2.0 ** -7 * want.float().abs() + 1e-3
    else:
        tol = torch.full_like(d, 1e-4)
    return d.max().item(), (d - tol).max().item()


def bound_ms(n_bytes: float, n_ops: float, dtype: str):
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_OPS_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- phases ----
def phase_build():
    from repro_torch.kernels import _cuda

    t0 = time.perf_counter()
    built = _cuda.build()
    for name in _cuda.SOURCES:
        _cuda.library(name)
    ptxas = [line.strip() for _, log in built.values() for line in log.splitlines()
             if "registers" in line or "spill" in line or "warning" in line.lower()]
    emit(phase="build", seconds=time.perf_counter() - t0,
         seconds_by_source={name: sec for name, (sec, _) in built.items()},
         dir=str(_cuda.build_dir()), ptxas=ptxas)


def phase_k1():
    import numpy as np
    import torch

    from repro_torch.kernels.event_join import dispatch, ops
    from repro_torch.kernels.event_join.ref import join_counts_torch

    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    cases = [("empty", np.zeros(0, np.int32), 100),
             ("padding", np.asarray([0, 1, -1, -1, 0], np.int32), 2),
             ("all padding", np.full(50_000, -1, np.int32), 100)]
    # the main path's shape, which is the one-block threshold (4096 events),
    # and one past it; many blocks; the largest shared histogram; and global
    # bins past it, in one block and in many
    for n, T in [(4096, 100), (200_000, 100), (1_048_576, 4096), (100_000, 60_000),
                 (50, 1), (100_000, 1), (4097, 100), (8192, 100), (300_000, 49_152),
                 (1000, 49_153)]:
        cases.append((f"{n}x{T}", rng.integers(-1, T + 5, n).astype(np.int32), T))
    # each case through the tensor API and through the join backend, whose
    # buffers grow and whose scratch must read back as zero after each call
    join = dispatch.CudaJoin(dev)
    max_err = 0
    for name, events, T in cases:
        counts = rng.integers(0, 5, T).astype(np.int32)
        expected = rng.integers(1, 3000, T).astype(np.int32)
        host = [torch.from_numpy(a) for a in (events, counts, expected)]
        want_nc, want_f = (t.numpy() for t in join_counts_torch(*host))
        nc, fired = ops.event_join(*(t.to(dev) for t in host))
        torch.cuda.synchronize()
        got = [nc.cpu().numpy(), fired.cpu().numpy(), *join(events, counts, expected)]
        err = max(int(np.abs(g.astype(np.int64) - w).max())
                  for g, w in zip(got, (want_nc, want_f) * 2))
        if err:
            raise AssertionError(f"event_join {name}: differs from its plain version by {err}")
        if join._scratch.count_nonzero().item():
            raise AssertionError(f"event_join {name}: the backend's scratch is not zero "
                                 f"after the call")
        max_err = max(max_err, err)
    # the main path's shape: one triage call of the Table-1 join,
    # run_once(4096) over 100 triggers, is 100 contiguous runs of row ids
    T, N = 100, 4096
    events = torch.repeat_interleave(torch.arange(T, dtype=torch.int32),
                                      torch.full((T,), N // T) + (torch.arange(T) < N % T))
    counts = torch.zeros(T, dtype=torch.int32)
    expected = torch.full((T,), 2000, dtype=torch.int32)
    d = [t.to(dev) for t in (events, counts, expected)]
    host = [t.numpy() for t in (events, counts, expected)]
    floor_out = torch.empty_like(d[1])
    # the plain version of the backend's call, on the same pinned input: one
    # copy up, the plain version, one copy of the [2, T] down, and the
    # stream synchronised, as the backend's call is
    pin_in = torch.from_numpy(np.concatenate(host)).pin_memory()
    pin_out = torch.empty(2 * T, dtype=torch.int32).pin_memory()
    dev_in = torch.empty(N + 2 * T, dtype=torch.int32, device=dev)

    def plain_call():
        dev_in.copy_(pin_in, non_blocking=True)
        out = torch.stack(join_counts_torch(dev_in[:N], dev_in[N:N + T], dev_in[N + T:]))
        pin_out.copy_(out.view(-1), non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()

    # device time of the main path's K1, the backend's call: its kernel reads
    # the packed pinned input and writes the pinned [2, T] output across
    # PCIe; beside it the plain version of that call, torch.bincount (the
    # yardstick, on device memory, which the port never calls), the kernel
    # through the tensor API on device memory (no runtime caller), and one
    # PyTorch elementwise launch on a [T] tensor, the least any single launch
    # takes
    times = kernel_times(200, ms=lambda: join(*host), plain_ms=plain_call,
                         library_ms=lambda: torch.bincount(d[0], minlength=T),
                         device_memory_ms=lambda: ops.event_join(*d),
                         launch_floor_ms=lambda: torch.add(d[1], 1, out=floor_out))
    # what one call of each runs on the card: K1's kernel and nothing else,
    # no memset and no copy (the backend's kernel reads and writes its
    # pinned buffers); a call whose sessions all saw no device activity
    # fails the phase
    activity = {}
    for key, fn in (("event_join", lambda: ops.event_join(*d)),
                    ("cuda_join", lambda: join(*host))):
        prof = device_profile(fn, 1, top=8, attempts=6)
        activity[key] = {"device_ops": prof["device_ops"], "names": prof["top_ms"],
                         "sessions": prof["sessions"]}
        if prof["device_ms"] is None:
            raise AssertionError(f"no profiling session of one {key} call saw the card "
                                 f"({prof['sessions']} sessions): its device activity "
                                 f"is unchecked")
        if prof["device_ops"] != 1 or "::join<" not in prof["top_ms"][0][0]:
            raise AssertionError(f"one {key} call ran {activity[key]} on the card: want "
                                 f"K1's kernel alone")
    # the join backend's whole call, host to host (numpy in, numpy out), in
    # turns with the CPU backend: card, CPU, CPU, card
    cpu_join = dispatch.resolve_join_backend("torch")[1]
    host_ms = {"cuda": [], "cpu_torch": []}
    for key in ("cuda", "cpu_torch", "cpu_torch", "cuda"):
        fn = {"cuda": join, "cpu_torch": cpu_join}[key]
        for _ in range(50):
            fn(*host)
        t0 = time.perf_counter()
        for _ in range(2000):
            fn(*host)
        host_ms[key].append((time.perf_counter() - t0) * 1e3 / 2000)
    # the bound of the main path's call: its input crosses PCIe to the card
    # and its [2, T] back (the two directions at once, so the larger), next
    # to the tensor API's bound on device memory
    device_memory_bound, _ = bound_ms(4 * (N + 4 * T), N, "int32")
    pcie_bound = 4 * max(N + 2 * T, 2 * T) / PEAK_PCIE_BYTES_S * 1e3
    b, by = max(pcie_bound, device_memory_bound), "bytes"
    emit(phase="k1", cases=[c[0] for c in cases], max_abs_err=max_err, shape=[N, T],
         bound_ms=b, device_memory_bound_ms=device_memory_bound,
         device_activity=activity, backend_host_ms=host_ms, **times)
    return {"max_abs_err": max_err, "bound_ms": b, "bound_by": by, **times}


def _attn_inputs(B, S, Hq, Hkv, D, Dv, dtype, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for shape in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, Dv))]


def _sdpa(q, k, v, causal):
    import torch.nn.functional as F

    G = q.shape[2] // k.shape[2]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if G > 1:
        kt, vt = kt.repeat_interleave(G, 1), vt.repeat_interleave(G, 1)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)


def phase_k2():
    import torch

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_torch

    bf16, f32 = torch.bfloat16, torch.float32
    cases = []  # the scalar kernel's cases, as before the sm90 route
    for S in (128, 1000, 1024):
        for dtype in (bf16, f32):
            cases.append((4, S, 24, 8, 128, 128, dtype, True))
    cases += [(2, 512, 16, 16, 128, 128, bf16, True),    # MHA
              (2, 512, 16, 1, 128, 128, bf16, True),     # MQA
              (2, 512, 24, 8, 128, 128, bf16, False),    # non-causal
              (2, 384, 16, 4, 192, 128, f32, True),      # Dv != D
              (4, 1024, 32, 32, 64, 64, bf16, True)]     # zamba2-1.2b
    # the sm90 kernel takes those of its route and these: S below one tile
    # and at it at both serving shapes, zamba2-1.2b's ragged S, causal and
    # not, and B 1 below one tile; at deepseek-v2's D 192 / Dv 128, S below,
    # at and past one tile with its 128 heads, ragged and not causal, GQA
    # and B 1 below one tile
    sm90_only = [(4, 64, 24, 8, 128, 128, bf16, True),
                 (4, 64, 32, 32, 64, 64, bf16, True),
                 (4, 128, 32, 32, 64, 64, bf16, True),
                 (4, 1000, 32, 32, 64, 64, bf16, True),
                 (2, 1000, 32, 32, 64, 64, bf16, False),
                 (1, 40, 4, 2, 64, 64, bf16, True),
                 (4, 64, 128, 128, 192, 128, bf16, True),
                 (4, 128, 128, 128, 192, 128, bf16, True),
                 (4, 1000, 128, 128, 192, 128, bf16, True),
                 (2, 1000, 16, 16, 192, 128, bf16, False),
                 (2, 512, 16, 4, 192, 128, bf16, True),
                 (1, 40, 4, 2, 192, 128, bf16, True)]
    runs = [("scalar", c) for c in cases] + [
        ("sm90", c) for c in cases + sm90_only
        if c[6] == bf16 and (c[4], c[5]) in ops.SM90_HEAD_DIM_PAIRS]
    results = []
    max_err = {"sm90": 0.0, "scalar": 0.0}
    for i, (route, (B, S, Hq, Hkv, D, Dv, dtype, causal)) in enumerate(runs):
        q, k, v = _attn_inputs(B, S, Hq, Hkv, D, Dv, dtype, i)
        name = f"{route} B{B} S{S} H{Hq}/{Hkv} D{D}/{Dv} {str(dtype)[6:]} causal={causal}"
        if route == "scalar":
            got = ops.flash_attention_scalar(q, k, v, causal=causal)
            want = flash_attention_torch(q, k, v, causal=causal)
        else:  # through the router, which must pick the sm90 kernel
            n_sm90, n_scalar = ops.launches_sm90, ops.launches_scalar
            got = ops.flash_attention(q, k, v, causal=causal)
            if (ops.launches_sm90, ops.launches_scalar) != (n_sm90 + 1, n_scalar):
                raise AssertionError(f"flash_attention {name}: did not take the sm90 route")
            want = ops.flash_attention_plain(q, k, v, causal=causal)
        err, excess = attn_excess(got, want)
        if not excess <= 0:
            raise AssertionError(f"flash_attention {name}: error {err} exceeds its "
                                 f"tolerance by {excess}")
        max_err[route] = max(max_err[route], err)
        results.append({"case": name, "max_abs_err": err, "excess": excess})
    # a q at an odd element offset cannot be a TMA source: the sm90 route raises
    flat = torch.randn(4 * 128 * 24 * 128 + 1, device="cuda").to(bf16)
    q, k, v = _attn_inputs(4, 128, 24, 8, 128, 128, bf16, 0)
    n = ops.launches
    try:
        ops.flash_attention(flat[1:].view(q.shape), k, v)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("flash_attention launched on a misaligned q")
    if ops.launches != n:
        raise AssertionError("flash_attention counted a launch for a refused q")
    emit(phase="k2", cases=results, misaligned_q=refused)
    # timing at the main paths' shapes: a serving prefill of 4 prompts padded
    # to 1024 tokens, bf16, causal, with llama3.2-3b's heads (the kernels
    # line) and with zamba2-1.2b's; each kernel beside its own plain version
    timed = {}
    for arch, (Hq, Hkv, D) in (("llama3.2-3b", (24, 8, 128)), ("zamba2-1.2b", (32, 32, 64))):
        B, S = 4, 1024
        q, k, v = _attn_inputs(B, S, Hq, Hkv, D, D, bf16, 99)
        sdpa = kernel_times(20, library_ms=_sdpa(q, k, v, True))
        sm90 = kernel_times(20, ms=lambda: ops.flash_attention_sm90(q, k, v),
                            plain_ms=lambda: ops.flash_attention_plain(q, k, v))
        scalar = kernel_times(10, ms=lambda: ops.flash_attention_scalar(q, k, v),
                              plain_ms=lambda: flash_attention_torch(q, k, v))
        flops = 2 * B * Hq * (D + D) * S * (S + 1) / 2     # the causal pairs only
        n_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        b, by = bound_ms(n_bytes, flops, "bfloat16")
        for route, times in (("sm90", sm90), ("scalar", scalar)):
            times = {**times, **sdpa, "timers": {**times["timers"], **sdpa["timers"]}}
            emit(phase="k2_timing", arch=arch, route=route, shape=[B, S, Hq, Hkv, D],
                 tflops=flops / times["ms"] / 1e9, bound_ms=b, **times)
            timed.setdefault(arch, {})[route] = {"max_abs_err": max_err[route], "bound_ms": b,
                                                 "bound_by": by, **times}
    return timed["llama3.2-3b"]


def ssd_excess(got, want, extra=0.0) -> tuple:
    """(max |got - want|, max of |got - want| less its tolerance) for K3's
    y or state against its plain version.  Both compute in fp32 in another
    order (the chunk's cumsum of a*dt included), which leaves fp32 results
    within 1e-4 (1 + max|want|); a bf16 y differs by one rounding flip more,
    2**-7 |want|; ``extra`` is added (``bf16_decay_tol``).  The check passes
    while the excess is <= 0."""
    import torch

    d = (got.float() - want.float()).abs()
    tol = 1e-4 * (1 + want.float().abs().max().item()) + extra
    if want.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * want.float().abs()
    return d.max().item(), (d - tol).max().item()


def bf16_decay_tol(x, dt, Bm, Cm, a, chunk):
    """The bf16-decay forms' tolerance on y beyond ``ssd_excess``'s: kernel
    and plain version round G = C·Bᵀ to bf16 after fp32 sums of another
    order, so a term of the intra-chunk sum may differ by one bf16 ulp,
    2**-7 of itself (L is summed in the same order, so its bf16 rounding,
    the differences' and the exp's agree); summed, 2**-7 of y_abs, the scan
    on |x|, |B| and |C|."""
    from repro_torch.kernels.ssd.ref import ssd_scan_torch

    y_abs, _ = ssd_scan_torch(x.float().abs(), dt, Bm.float().abs(), Cm.float().abs(), a,
                              chunk)
    return 2.0 ** -7 * y_abs


def _ssd_inputs(B, S, H, P, N, dtype, seed):
    """Model-like inputs: x a strided view (every other head of a wider
    tensor, as the kernel reads x through its strides), dt = softplus(N(0,1)),
    a = -exp(0.3 N(0,1))."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(B, S, 2 * H, P, generator=gen, device="cuda") * 0.5).to(dtype)[:, :, ::2]
    dt = F.softplus(torch.randn(B, S, H, generator=gen, device="cuda"))
    Bm, Cm = ((torch.randn(B, S, N, generator=gen, device="cuda") * 0.5).to(dtype)
              for _ in range(2))
    a = -torch.exp(torch.randn(H, generator=gen, device="cuda") * 0.3)
    return x, dt, Bm, Cm, a


def _ssd_grad_check():
    """ssd through its autograd Function (K3's sm90 kernel forward, the
    plain backward) against autograd through the sm90 route's plain
    version, at a small shape (B 2, S 300, H 4, P = N = 64, bf16, chunk 64,
    x a strided view), through y and the final state: each input's
    gradient within 2**-6 in relative L2 (bf16 gradients; the plain
    version splits its operands into two bf16 terms, the backward does
    not), one launch and one backward call; an SSD without its state
    between chunks must land farther."""
    import torch

    from repro_torch.kernels.ssd import ops

    x, dt, Bm, Cm, a = _ssd_inputs(2, 300, 4, 64, 64, torch.bfloat16, 31)
    gen = torch.Generator(device="cuda").manual_seed(32)
    gy = torch.randn(x.shape, generator=gen, device="cuda")
    gs = torch.randn(2, 4, 64, 64, generator=gen, device="cuda")
    wide = torch.zeros(2, 300, 8, 64, device="cuda", dtype=torch.bfloat16)
    wide[:, :, ::2] = x

    def grads(fn):
        w, *rest = (t.detach().clone().requires_grad_(True) for t in (wide, dt, Bm, Cm, a))
        y, state = fn(w[:, :, ::2], *rest, 64)
        ((y.float() * gy).sum() + (state * gs).sum()).backward()
        return [w.grad[:, :, ::2], *(t.grad for t in rest)]

    def rel(got, want):
        return ((got.float() - want.float()).norm() / want.float().norm()).item()

    launches, calls = ops.launches_sm90, ops.backward_calls
    got = grads(ops.ssd)
    if (ops.launches_sm90, ops.backward_calls) != (launches + 1, calls + 1):
        raise AssertionError("ssd under autograd did not launch K3's sm90 kernel and its "
                             "backward once each")
    want = grads(ops.ssd_plain)
    wrong = grads(lambda *args: _ssd_without_carry(*args, torch.float32))
    names = ("x", "dt", "Bm", "Cm", "a")
    errs = {n: rel(g, w) for n, g, w in zip(names, got, want)}
    wrong_errs = {n: rel(g, w) for n, g, w in zip(names, wrong, want)}
    if not max(errs.values()) <= 2.0 ** -6:
        raise AssertionError(f"K3's gradients differ from the plain version's: {errs}")
    if not max(wrong_errs.values()) > max(errs.values()):
        raise AssertionError(f"an SSD without its carried state gives gradients as close "
                             f"as K3's: {wrong_errs}")
    return {"rel_l2": errs, "tolerance": 2.0 ** -6, "no_carry_rel_l2": wrong_errs}


def phase_k3():
    import torch

    from repro_torch.kernels.ssd import ops
    from repro_torch.kernels.ssd.ref import ssd_scan_recurrence, ssd_scan_torch

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(2, 256, 4, 64, 64, 16, f32),       # S a multiple of the chunk
             (2, 300, 4, 64, 64, 64, bf16),      # ragged
             (3, 100, 5, 32, 16, 128, f32),      # one chunk, shorter than 128
             (2, 128, 4, 64, 64, 128, bf16),     # one full chunk
             (2, 512, 8, 64, 64, 128, f32),
             (2, 1000, 8, 64, 64, 128, bf16),    # ragged at 128
             (4, 1024, 64, 64, 64, 128, bf16)]   # zamba2-1.2b's prefill
    # the scalar kernel takes every case (by its own launcher), the sm90
    # kernel those of its route (through the router) and two more at the
    # serving shape with other seeds
    runs = [("scalar", i, c) for i, c in enumerate(cases)]
    runs += [("sm90", i, c) for i, c in enumerate(cases)
             if c[6] == bf16 and c[3] == c[4] == 64]
    runs += [("sm90", seed, (4, 1024, 64, 64, 64, 128, bf16)) for seed in (101, 102)]
    # both kernels' bf16-decay forms (the reference's ssd_decay_dtype=bf16)
    # at the cases of each route and zamba2-1.2b's prefill
    runs = [(route, seed, case, f32) for route, seed, case in runs]
    runs += [(route, seed, case, bf16) for route, seed, case, _ in runs
             if case[6] == bf16 and case[3] == case[4] == 64]
    results = []
    max_err = {"sm90": 0.0, "scalar": 0.0, "sm90 bf16 decay": 0.0, "scalar bf16 decay": 0.0}
    for route, seed, (B, S, H, P, N, chunk, dtype), decay in runs:
        inputs = _ssd_inputs(B, S, H, P, N, dtype, seed)
        name = f"{route} B{B} S{S} H{H} P{P} N{N} Q{chunk} {str(dtype)[6:]} seed {seed}"
        if route == "scalar":
            y, state = ops.ssd_scalar(*inputs, chunk=chunk, decay_dtype=decay)
            want_y, want_state = ssd_scan_torch(*inputs, chunk=chunk, decay_dtype=decay)
        else:
            n_sm90, n_scalar = ops.launches_sm90, ops.launches_scalar
            y, state = ops.ssd(*inputs, chunk=chunk, decay_dtype=decay)
            if (ops.launches_sm90, ops.launches_scalar) != (n_sm90 + 1, n_scalar):
                raise AssertionError(f"ssd_scan {name}: did not take the sm90 route")
            want_y, want_state = ops.ssd_plain(*inputs, chunk=chunk, decay_dtype=decay)
        extra = 0.0
        if decay == bf16:
            name, route = f"{name} bf16 decay", f"{route} bf16 decay"
            extra = bf16_decay_tol(*inputs, chunk)
        (ey, xy), (es, xs) = ssd_excess(y, want_y, extra), ssd_excess(state, want_state)
        if not (xy <= 0 and xs <= 0 and y.dtype == dtype):
            raise AssertionError(f"ssd_scan {name}: y error {ey} (excess {xy}), state "
                                 f"error {es} (excess {xs})")
        max_err[route] = max(max_err[route], ey, es)
        results.append({"case": name, "y_max_abs_err": ey, "state_max_abs_err": es,
                        "y_excess": xy, "state_excess": xs})
    # an x at an odd element offset cannot feed the 16-byte copies: the sm90
    # route raises
    x, dt, Bm, Cm, a = _ssd_inputs(2, 128, 4, 64, 64, bf16, 0)
    flat = torch.zeros(x.numel() + 1, device="cuda", dtype=bf16)
    n = ops.launches
    try:
        ops.ssd(flat[1:].view(x.shape), dt, Bm, Cm, a)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("ssd launched on a misaligned x")
    if ops.launches != n:
        raise AssertionError("ssd counted a launch for a refused x")
    # the plain version against the step-by-step recurrence
    inputs = _ssd_inputs(2, 256, 4, 32, 16, f32, 77)
    (y, state), (ry, rstate) = ssd_scan_torch(*inputs, chunk=64), ssd_scan_recurrence(*inputs)
    rec = max(ssd_excess(y, ry)[1], ssd_excess(state, rstate)[1])
    if not rec <= 0:
        raise AssertionError(f"ssd_scan_torch differs from the recurrence (excess {rec})")
    grad = _ssd_grad_check()
    emit(phase="k3", cases=results, misaligned_x=refused, plain_vs_recurrence_excess=rec,
         grad_check=grad)
    # timing at the main path's shape: zamba2-1.2b's prefill of 4 prompts
    # padded to 1024 tokens, 64 heads of P = 64, N = 64, chunk 128; each
    # kernel beside its own plain version
    B, S, H, P, N, Q = 4, 1024, 64, 64, 64, 128
    x, dt, Bm, Cm, a = _ssd_inputs(B, S, H, P, N, bf16, 99)
    x = x.contiguous()
    timed = {
        "sm90": kernel_times(20, ms=lambda: ops.ssd_sm90(x, dt, Bm, Cm, a, chunk=Q),
                             plain_ms=lambda: ops.ssd_plain(x, dt, Bm, Cm, a, chunk=Q)),
        "scalar": kernel_times(20, ms=lambda: ops.ssd_scalar(x, dt, Bm, Cm, a, chunk=Q),
                               plain_ms=lambda: ssd_scan_torch(x, dt, Bm, Cm, a, chunk=Q)),
        "sm90 bf16 decay": kernel_times(
            20, ms=lambda: ops.ssd_sm90(x, dt, Bm, Cm, a, chunk=Q, decay_dtype=bf16),
            plain_ms=lambda: ops.ssd_plain(x, dt, Bm, Cm, a, chunk=Q, decay_dtype=bf16)),
        "scalar bf16 decay": kernel_times(
            20, ms=lambda: ops.ssd_scalar(x, dt, Bm, Cm, a, chunk=Q, decay_dtype=bf16),
            plain_ms=lambda: ssd_scan_torch(x, dt, Bm, Cm, a, chunk=Q, decay_dtype=bf16)),
    }
    # the sm90 route's three kernels apart
    split = device_profile(lambda: ops.ssd_sm90(x, dt, Bm, Cm, a, chunk=Q), 20, top=3)
    # per (b, h) and chunk of q steps: C·Bᵀ and the mixing tile times x over
    # the causal pairs only (the kernels skip the rest), C·h and the state
    # update over all q steps
    chunks = [min(Q, S - s0) for s0 in range(0, S, Q)]
    flops = sum(2 * (q * (q + 1) // 2 * (N + P) + 2 * q * N * P) for q in chunks) * B * H
    n_bytes = (2 * 2 * x.numel() + 4 * dt.numel() + 2 * (Bm.numel() + Cm.numel())
               + 4 * B * H * N * P + 4 * H)
    b, by = bound_ms(n_bytes, flops, "tfloat32")
    out = {}
    for route, times in timed.items():
        extra = {"sm90_kernels_ms": split["top_ms"]} if route == "sm90" else {}
        emit(phase="k3_timing", route=route, shape=[B, S, H, P, N, Q], gflop=flops / 1e9,
             mbytes=n_bytes / 1e6, tflops=flops / times["ms"] / 1e9, bound_ms=b, bound_by=by,
             **extra, **times)
        out[route] = {"max_abs_err": max_err[route], "bound_ms": b, "bound_by": by,
                      "library_ms": None, **times}
    # each kernel's bf16-decay form, the same function's work, in its row
    for route in ("sm90", "scalar"):
        out[route]["bf16_decay"] = out.pop(f"{route} bf16 decay")
    return out


def _join_run(device, n_triggers=100, events_each=2000):
    """The Table-1 join through the facade's worker, whose join backend is
    ``auto``: the kernel on a CUDA device, the plain torch version on the CPU."""
    from repro_torch.core import Triggerflow, make_trigger, termination_event

    tf = Triggerflow(inline_functions=True, commit_policy="every_batch", device=device)
    tf.create_workflow("join")
    for t in range(n_triggers):
        tf.add_trigger("join", make_trigger(
            f"j{t}", condition={"name": "counter", "expected": events_each,
                                "aggregate": False},
            action={"name": "noop"}, trigger_id=f"jt{t}", transient=False))
    tf.event_store.publish_batch("join", [termination_event(f"j{i % n_triggers}", i)
                                          for i in range(n_triggers * events_each)])
    w = tf.worker("join")
    w.keep_event_log = False
    n = n_triggers * events_each
    t0 = time.perf_counter()
    done = 0
    while done < n:
        done += w.run_once(4096)
    seconds = time.perf_counter() - t0
    tf.shutdown()
    return w, n / seconds


def phase_join():
    """The Table-1 join on the card and on the CPU in turns (card, CPU, CPU,
    card); K1's launch count is set to 0 just before each run and read just
    after it."""
    from repro_torch.kernels.event_join import ops

    runs = []
    for device in ("cuda", "cpu", "cpu", "cuda"):
        ops.launches = 0
        w, rate = _join_run(device)
        runs.append((device, w, rate, ops.launches))
    ref = runs[1][1]
    for device, w, rate, launches in runs:
        plane = w._vector_plane
        if plane is None or plane.calls == 0 or w.device.type != device \
                or plane.backend != (f"cuda:{w.device.index}" if device == "cuda" else "torch"):
            raise AssertionError(f"the {device} join did not run its own backend: {plane}")
        if launches != (plane.calls if device == "cuda" else 0):
            raise AssertionError(f"{launches} K1 launches for {plane.calls} triage calls "
                                 f"on the {device}")
        if w.stats.fires != 100:
            raise AssertionError(f"fires on the {device}: {w.stats.fires}")
        for tid in ref.triggers:
            if dict(w.context_of(tid)) != dict(ref.context_of(tid)):
                raise AssertionError(f"context of {tid} on the {device} differs from the "
                                     f"CPU run")
    card = runs[0][1]._vector_plane
    emit(phase="join", triggers=100, events=200_000, fires=runs[0][1].stats.fires,
         backend=card.backend, triage_calls=card.calls,
         k1_launches=[r[3] for r in runs if r[0] == "cuda"],
         events_per_s_cuda=[r[2] for r in runs if r[0] == "cuda"],
         events_per_s_cpu_torch=[r[2] for r in runs if r[0] == "cpu"])
    return runs[0][3]


def _serve(cfg, counters, profile=True):
    """Serve 8 seeded prompts of 128-1024 tokens, 4 to a batch, 16 new tokens
    each, through ServingEngine under KedaAutoscaler on the card.  Every
    counter of ``counters`` (name: (module, attribute)) is set to 0 just
    before the run and read just after.  Then time the first batch's prefill
    and decode and, with ``profile``, profile both.  Returns the run's
    numbers and what the checks need."""
    import numpy as np
    import torch

    from repro_torch.core import KedaAutoscaler, Triggerflow
    from repro_torch.serving.engine import ServingEngine

    t0 = time.perf_counter()
    tf = Triggerflow(inline_functions=True, device="cuda")
    eng = ServingEngine(cfg, tf, "serve", max_batch=4, max_new_tokens=16, max_len=2048)
    eng.deploy()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, int(rng.integers(128, 1025))).tolist()
               for _ in range(8)]

    torch.cuda.reset_peak_memory_stats()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    scaler = KedaAutoscaler(tf, poll_interval=0.05, grace_period=0.5).start()
    t0 = time.perf_counter()
    try:
        for i, p in enumerate(prompts):
            eng.submit(f"req-{i}", p)
        while eng.served < len(prompts) and time.perf_counter() - t0 < 600:
            time.sleep(0.01)
        wall = time.perf_counter() - t0
        # the termination events of the last batch land in the worker's log
        # on its next pass
        log = tf.worker("serve").event_log
        done = {}
        while len(done) < len(prompts) and time.perf_counter() - t0 < 660:
            done = {e.data["result"]["id"]: e.data["result"]["tokens"]
                    for e in list(log) if e.subject.startswith("serve|done|")}
            time.sleep(0.01)
    finally:
        scaler.stop()
    launches = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    tf.shutdown()
    if eng.served != 8 or eng.batches != 2 or len(done) != 8:
        raise AssertionError(f"{cfg.arch}: served {eng.served} in {eng.batches} "
                             f"batches, {len(done)} results")
    for rid, toks in done.items():
        if len(toks) != 16 or not all(0 <= t < cfg.vocab for t in toks):
            raise AssertionError(f"{cfg.arch} {rid}: bad tokens {toks}")

    # the first batch again, timed with CUDA events
    model = eng.model
    tokens = eng.prompt_batch([{"prompt": p} for p in prompts[:4]])
    prefill_ms = cuda_ms(lambda: model.prefill({"tokens": tokens}, max_len=2048), 3, 1)
    logits, cache = model.prefill({"tokens": tokens}, max_len=2048)
    if not (torch.isfinite(logits).all() and logits.shape == (4, cfg.vocab)):
        raise AssertionError(f"{cfg.arch}: prefill logits are not finite [4, vocab]")
    tok = logits.argmax(-1)[:, None]

    def decode_steps():
        c = dict(cache)
        t = tok
        for _ in range(16):
            lg, c = model.decode(c, {"tokens": t})
            t = lg.argmax(-1)[:, None]

    decode_ms = cuda_ms(decode_steps, 3, 1) / 16
    profiles = {"prefill": device_profile(
                    lambda: model.prefill({"tokens": tokens}, max_len=2048), 2, top=8),
                "decode_16_steps": device_profile(decode_steps, 2, top=8)} if profile else {}
    run = dict(arch=cfg.arch, params=cfg.param_count(), init_s=init_s, requests=8,
               batches=eng.batches, new_tokens=16, prompt_lens=[len(p) for p in prompts],
               wall_s=wall, tokens_per_s=8 * 16 / wall, prefill_ms_batch0=prefill_ms,
               decode_ms_per_token=decode_ms, peak_gib=peak_gib, launches=launches,
               busy_share=busy_share(profiles), profile=profiles)
    return run, model, tokens


def busy_share(profiles) -> dict:
    """Device time over host wall time of each profiled step (None where no
    profiling session saw the device)."""
    return {k: (p["device_ms"] / p["wall_ms"] if p["device_ms"] is not None else None)
            for k, p in profiles.items()}


def _logits_by_variant(model, batch, module, name, variants):
    """The logits at every position of ``batch`` with ``module.<name>``
    swapped for each of ``variants`` in turn (monkeypatches of this
    script's, not switches in the package)."""
    real = getattr(module, name)
    full = {}
    try:
        for key, fn in variants.items():
            setattr(module, name, fn)
            full[key] = model.forward(batch)[0]
    finally:
        setattr(module, name, real)
    return full


def _logits_check(arch, full, what, rtol):
    """The gap the kernel leaves in the logits must be under the tolerance,
    rtol (1 + max|logits|), and the wrong version's gap over it, which shows
    that the tolerance can tell a wrong kernel from rounding.  The kernel and
    its plain version differ by rounding in some outputs of each layer (held
    at every layer before this), and that passes through every residual
    layer to the logits."""
    import torch

    if not torch.isfinite(full["kernel"]).all():
        raise AssertionError(f"{arch}: forward logits with {what} are not finite")
    err = (full["kernel"] - full["plain"]).abs().max().item()
    wrong_err = (full["wrong"] - full["plain"]).abs().max().item()
    scale = full["plain"].abs().max().item()
    tol = rtol * (1 + scale)
    argmax_agree = (full["kernel"].argmax(-1) == full["plain"].argmax(-1)).float().mean().item()
    out = dict(logits_kernel_vs_plain_max_abs=err, logits_wrong_vs_plain_max_abs=wrong_err,
               max_abs_logit=scale, tolerance=tol, argmax_agree=argmax_agree)
    if not err <= tol:
        raise AssertionError(f"{arch}: logits with {what} differ from those with its "
                             f"plain version by {err} > {tol}: {out}")
    if not wrong_err > tol:
        raise AssertionError(f"{arch}: a wrong version of {what} moves the logits by "
                             f"only {wrong_err} <= {tol}: the tolerance cannot tell it "
                             f"from rounding: {out}")
    return out


# K2's and K3's wrappers each count their launches under these names
COUNTERS = ("launches", "launches_sm90", "launches_scalar")


def phase_serving():
    import functools

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_torch
    from repro_torch.models import layers

    cfg = get_config("llama3.2-3b")
    if (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab) != (28, 3072, 24, 8, 128, 8192, 128256):
        raise AssertionError(f"llama3.2-3b is not at full width: {cfg}")
    run, model, tokens = _serve(cfg, {c: (fa_ops, c) for c in COUNTERS})
    launches = run["launches"]
    want = {"launches": 2 * cfg.n_layers, "launches_sm90": 2 * cfg.n_layers,
            "launches_scalar": 0}
    if launches != want:
        raise AssertionError(f"K2 launches {launches} in the llama3.2-3b run: every bf16 "
                             f"prefill layer must take the sm90 route, want {want}")

    # K2 against the sm90 route's plain version inside the full-width model:
    # first every layer's own q, k, v at the kernel's tolerance, then the
    # logits at every position of the first batch with K2, with that plain
    # version and with a deliberately wrong attention (the plain version
    # without its causal mask)
    real = layers.flash_attention
    plain = functools.partial(flash_attention_torch, **fa_ops.PLAIN_ARGS["sm90"])
    layer_excess = []

    def checked(q, k, v, causal=True):
        if fa_ops.route(q, k, v) != "sm90":
            raise AssertionError(f"a prefill layer's attention takes the "
                                 f"{fa_ops.route(q, k, v)} route")
        got = real(q, k, v, causal=causal)
        layer_excess.append(attn_excess(got, plain(q, k, v, causal=causal)))
        return got

    def wrong(q, k, v, causal=True):
        return plain(q, k, v, causal=False)

    full = _logits_by_variant(model, {"tokens": tokens}, layers, "flash_attention",
                              {"kernel": checked, "plain": plain, "wrong": wrong})
    if len(layer_excess) != cfg.n_layers or max(x for _, x in layer_excess) > 0:
        raise AssertionError(f"K2 differs from its plain version inside the model: "
                             f"(max |error|, excess) per layer {layer_excess}")
    # bf16: one rounding flip in some outputs of each of 28 layers
    gaps = _logits_check(cfg.arch, full, "K2", 5e-2)
    k2_launches = launches["launches_sm90"]
    emit(phase="serving", k2_sm90_launches=k2_launches,
         layer_max_abs_err=max(e for e, _ in layer_excess),
         layer_max_excess=max(x for _, x in layer_excess), **gaps, **run)
    return k2_launches


def _ssd_without_carry(x, dt, Bm, Cm, a, chunk, decay_dtype):
    """A deliberately wrong SSD: the plain version run on each chunk alone,
    so the state between chunks is dropped."""
    import torch

    from repro_torch.kernels.ssd.ref import ssd_scan_torch

    Q = min(chunk, x.shape[1])
    ys = []
    for s0 in range(0, x.shape[1], Q):
        y, state = ssd_scan_torch(x[:, s0:s0 + Q], dt[:, s0:s0 + Q], Bm[:, s0:s0 + Q],
                                  Cm[:, s0:s0 + Q], a, chunk, decay_dtype)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def step_excess(y, state, want_y, want_state) -> tuple:
    """(max |error| of the new state, of y, and the largest excess over the
    tolerance) for the decode step's kernel against its plain version, at
    the tolerance of tests/test_torch_cuda.py's ``test_ssd_step_matches_plain``:
    the kernel rounds each new state element as the plain ops do, so the
    state within 1e-6 (1 + max|want|) (``expf`` beside torch's exp); y, summed
    over N in another order, within one bf16 rounding flip, 2**-7 |want|,
    above a floor of 1e-4 (1 + max|want|).  Passes while the excess is <= 0."""
    d_state = (state - want_state).abs().max().item()
    state_tol = 1e-6 * (1 + want_state.abs().max().item())
    want = want_y.float()
    d_y = (y.float() - want).abs()
    y_tol = 1e-4 * (1 + want.abs().max().item()) + 2.0 ** -7 * want.abs()
    return d_state, d_y.max().item(), max(d_state - state_tol, (d_y - y_tol).max().item())


def _ssd_step_without_inflow(state, x, dt, a, Bm, Cm, d_skip):
    """A deliberately wrong decode step: the plain version with the inflow
    B ⊗ (dt·x) dropped, so the state only decays."""
    import torch

    from repro_torch.kernels.ssd import ops as ssd_ops

    return ssd_ops.ssd_step_plain(state, x, dt, a, torch.zeros_like(Bm), Cm, d_skip)


def _ssd_step_timed(B, H, N, P, layers, d_skip_dtype):
    """The decode step's kernel and its plain version at [B, H, N, P], bf16
    x in the layout the conv's einsum leaves (strides (1, B)): one fp32
    state a layer, ``layers`` of them taken in turn, as a decode step takes
    them (at B 8 one state fits in L2, 38 do not).  The bound: each state
    element read and written once, x, y, dt, B, C, a and d_skip moved once."""
    import torch

    from repro_torch.kernels.ssd import ops as ssd_ops

    g = torch.Generator(device="cuda").manual_seed(B)
    states = torch.randn(layers, B, H, N, P, generator=g, device="cuda")
    x = torch.randn(H * P, B, generator=g, device="cuda").bfloat16().t().view(B, H, P)
    dt = torch.nn.functional.softplus(torch.randn(B, H, generator=g, device="cuda"))
    a = -torch.exp(torch.randn(H, generator=g, device="cuda") * 0.3)
    Bm, Cm = (torch.randn(B, N, generator=g, device="cuda") * 0.5 for _ in "BC")
    d_skip = torch.randn(H, generator=g, device="cuda").to(d_skip_dtype)
    turn = [0]

    def call(fn):
        def go():
            fn(states[turn[0] % layers], x, dt, a, Bm, Cm, d_skip)
            turn[0] += 1
        return go

    n_bytes = (2 * B * H * N * P * 4 + 2 * B * H * P * 2 + B * H * 4 + 2 * B * N * 4
               + H * 4 + H * d_skip.element_size())
    b, by = bound_ms(n_bytes, 5 * B * H * N * P, "float32")
    times = kernel_times(2 * layers, b, ms=call(ssd_ops.ssd_step),
                         plain_ms=call(ssd_ops.ssd_step_plain))
    split, tn = ssd_ops.step_tile(B, H, N, P, ssd_ops._sm_count(states.device))
    del states
    torch.cuda.empty_cache()
    return {"shape": [B, H, N, P], "split": split, "tn": tn, "mbytes": n_bytes / 1e6,
            "bound_ms": b, "bound_by": by, "roofline": b / times["ms"], **times}


def phase_hybrid():
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_scan_torch
    from repro_torch.models import decode_graph, ssm

    cfg = get_config("zamba2-1.2b")
    H = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
    if (cfg.family, cfg.n_layers, cfg.d_model, cfg.ssm_expand * cfg.d_model, H,
            cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk, len(cfg.shared_sites()),
            cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.vocab) != \
            ("hybrid", 38, 2048, 4096, 64, 64, 64, 128, 7, 32, 32, 64, 32000):
        raise AssertionError(f"zamba2-1.2b is not at full width: {cfg}")
    counters = {"k3": (ssd_ops, "launches"), "k3_sm90": (ssd_ops, "launches_sm90"),
                "k3_scalar": (ssd_ops, "launches_scalar"),
                "ssd_step": (ssd_ops, "step_launches"),
                **{c: (fa_ops, c) for c in COUNTERS}}
    run, model, tokens = _serve(cfg, counters)
    launches = run["launches"]
    sites = len(cfg.shared_sites())
    # the served decode steps replay one graph: the host calls ssd_step only
    # in the warm-up steps and the capture, once a Mamba2 layer each
    captures = model.decode_graph_captures
    want = {"k3": 2 * cfg.n_layers, "k3_sm90": 2 * cfg.n_layers, "k3_scalar": 0,
            "launches": 2 * sites, "launches_sm90": 2 * sites, "launches_scalar": 0,
            "ssd_step": cfg.n_layers * (decode_graph.WARM_UP_STEPS + 1) * captures}
    if launches != want or captures != 1:
        raise AssertionError(f"launches {launches} in the hybrid run, want {want}, from "
                             f"{captures} graph captures, want 1: every bf16 Mamba2 layer "
                             f"takes K3's sm90 route and ssd_step's kernel, every bf16 "
                             f"shared-attention site K2's")
    # the profiled replays run the kernel in every layer of every step
    decode_prof = run["profile"]["decode_16_steps"]
    if decode_prof["device_ms"] is not None and \
            decode_prof["kernel_calls"]["ssd_step"] != 16 * cfg.n_layers:
        raise AssertionError(f"ssd_step's kernel ran {decode_prof['kernel_calls']['ssd_step']} "
                             f"times in 16 replayed decode steps, want {16 * cfg.n_layers}")

    # ssd_step's kernel against its plain version at each Mamba2 layer's own
    # inputs in 16 decode steps from the first batch's prefill, run op by op
    # (a graph cannot hold the check's host reads): every layer-step launches
    # the kernel, and the step without its inflow must fail the same check
    real_step = ssm.ssd_step
    step_checks, wrong_steps = [], []

    def step_checked(state, x, dt, a, Bm, Cm, d_skip):
        want_state, wrong_state = state.clone(), state.clone()
        want = ssd_ops.ssd_step_plain(want_state, x, dt, a, Bm, Cm, d_skip)
        wrong = _ssd_step_without_inflow(wrong_state, x, dt, a, Bm, Cm, d_skip)
        got = real_step(state, x, dt, a, Bm, Cm, d_skip)
        step_checks.append(step_excess(got, state, want, want_state))
        wrong_steps.append(step_excess(wrong, wrong_state, want, want_state))
        return got

    logits, cache = model.prefill({"tokens": tokens}, max_len=2048)
    tok, pos = logits.argmax(-1)[:, None], cache["pos"]
    ssd_ops.step_launches = 0
    ssm.ssd_step = step_checked
    try:
        for _ in range(16):
            tok = model.decode_in_place(cache, {"tokens": tok}, pos).argmax(-1)[:, None]
            pos += 1
    finally:
        ssm.ssd_step = real_step
    step_launches_op_by_op = ssd_ops.step_launches
    del cache
    if step_launches_op_by_op != 16 * cfg.n_layers or len(step_checks) != 16 * cfg.n_layers \
            or max(x for *_, x in step_checks) > 0:
        raise AssertionError(f"ssd_step's kernel in 16 op-by-op decode steps: "
                             f"{step_launches_op_by_op} launches, want {16 * cfg.n_layers}; "
                             f"(state, y max |error|, excess) per layer-step {step_checks}")
    if not min(x for *_, x in wrong_steps) > 0:
        raise AssertionError(f"the decode step without its inflow passes the ssd_step check "
                             f"at some layer-step: {wrong_steps}")
    d_skip_dtype = model.layers[0].mamba.d_skip.dtype
    step_timed = {f"b{B}": _ssd_step_timed(B, H, cfg.ssm_state, cfg.ssm_headdim, cfg.n_layers,
                                           d_skip_dtype) for B in (64, 8)}

    # K3 against the sm90 route's plain version at each of the 38 layers' own
    # inputs, in bf16 as served, in one forward over the first batch; the SSD
    # without its state between chunks must fail the same check at some
    # layer, which shows that the check can tell a wrong scan from rounding
    real = ssm.ssd
    layer_excess, wrong_excess = [], []

    def excess(got, want):
        (ey, xy), (es, xs) = ssd_excess(got[0], want[0]), ssd_excess(got[1], want[1])
        return max(ey, es), max(xy, xs)

    def checked(x, dt, Bm, Cm, a, chunk, decay_dtype):
        if ssd_ops.route(x, Bm) != "sm90":
            raise AssertionError(f"a Mamba2 layer's SSD takes the {ssd_ops.route(x, Bm)} "
                                 f"route")
        got = real(x, dt, Bm, Cm, a, chunk, decay_dtype)
        want = ssd_ops.ssd_plain(x, dt, Bm, Cm, a, chunk, decay_dtype)
        layer_excess.append(excess(got, want))
        wrong_excess.append(excess(_ssd_without_carry(x, dt, Bm, Cm, a, chunk, decay_dtype),
                                   want))
        return got

    bf16 = _logits_by_variant(model, {"tokens": tokens}, ssm, "ssd",
                              {"kernel": checked})["kernel"]
    if len(layer_excess) != cfg.n_layers or max(x for _, x in layer_excess) > 0:
        raise AssertionError(f"K3 differs from its plain version inside the model: "
                             f"(max |error|, excess) per layer {layer_excess}")
    if not max(x for _, x in wrong_excess) > 0:
        raise AssertionError(f"the SSD without its carried state passes the per-layer K3 "
                             f"check at every layer: {wrong_excess}")
    if not torch.isfinite(bf16).all():
        raise AssertionError("zamba2-1.2b: bf16 forward logits with K3 are not finite")
    del bf16

    # The logits four ways with the activations in fp32, where rounding noise
    # is 2**16 times smaller than in bf16: with K3, with the plain SSD, with
    # the plain SSD at chunk 64 (equally right, so its gap to the plain SSD
    # at chunk 128 is the floor that rounding reaches through 38 layers) and
    # with the SSD without its state between chunks.  Only the first of the
    # four calls the kernels of K3; all four call K2's.
    def plain_q64(x, dt, Bm, Cm, a, chunk, decay_dtype):
        return ssd_scan_torch(x, dt, Bm, Cm, a, 64, decay_dtype)

    variants = {"kernel": real, "plain": ssd_scan_torch, "plain_q64": plain_q64,
                "wrong": _ssd_without_carry}
    model.cfg = dataclasses.replace(cfg, dtype=torch.float32)
    for c in COUNTERS:
        setattr(fa_ops, c, 0)
        setattr(ssd_ops, c, 0)
    try:
        fp32 = _logits_by_variant(model, {"tokens": tokens}, ssm, "ssd", variants)
    finally:
        model.cfg = cfg
    fp32_launches = {c: getattr(fa_ops, c) for c in COUNTERS}
    fp32_k3 = {c: getattr(ssd_ops, c) for c in COUNTERS}
    # four fp32 forwards over 7 sites each, all on K2's scalar route; K3's
    # scalar route in each of the 38 layers of the one forward with K3
    want = {"launches": 4 * sites, "launches_sm90": 0, "launches_scalar": 4 * sites}
    want_k3 = {"launches": cfg.n_layers, "launches_sm90": 0, "launches_scalar": cfg.n_layers}
    if fp32_launches != want or fp32_k3 != want_k3:
        raise AssertionError(f"launches in the fp32 forwards: K2 {fp32_launches}, want "
                             f"{want}; K3 {fp32_k3}, want {want_k3}")
    floor = (fp32["plain_q64"] - fp32["plain"]).abs().max().item()
    # the floor is about 5e-4 of the largest logit (NVIDIA H100 80GB HBM3,
    # 700 W), so 1e-2 leaves a margin of 20; K3 must also stay within a few
    # times the floor, as a kernel that differs by rounding alone does
    gaps = _logits_check(cfg.arch, fp32, "K3 (fp32 activations)", 1e-2)
    if not gaps["logits_kernel_vs_plain_max_abs"] <= 4 * floor:
        raise AssertionError(f"zamba2-1.2b: logits with K3 differ from those with the "
                             f"plain SSD by more than 4 times the rounding floor {floor}: "
                             f"{gaps}")
    emit(phase="hybrid", k3_launches=launches["k3"], k3_sm90_launches=launches["k3_sm90"],
         k2_sm90_launches=launches["launches_sm90"], k2_launches_fp32_forwards=fp32_launches,
         k3_launches_fp32_forwards=fp32_k3,
         layer_max_abs_err=max(e for e, _ in layer_excess),
         layer_max_excess=max(x for _, x in layer_excess),
         no_carry_layer_max_excess=max(x for _, x in wrong_excess),
         no_carry_layers_failing=sum(x > 0 for _, x in wrong_excess),
         fp32_logits_plain_q64_vs_plain_max_abs=floor,
         ssd_step_launches=launches["ssd_step"],
         ssd_step_calls_in_16_replayed_steps=decode_prof["kernel_calls"]["ssd_step"],
         ssd_step_launches_op_by_op=step_launches_op_by_op,
         ssd_step_state_max_abs_err=max(e for e, _, _ in step_checks),
         ssd_step_y_max_abs_err=max(e for _, e, _ in step_checks),
         ssd_step_max_excess=max(x for *_, x in step_checks),
         no_inflow_min_excess=min(x for *_, x in wrong_steps),
         ssd_step_timed=step_timed, **gaps, **run)
    return {"k3_sm90": launches["k3_sm90"], "k3_scalar": fp32_k3["launches_scalar"],
            "k2_sm90": launches["launches_sm90"],
            "k2_scalar": fp32_launches["launches_scalar"],
            "ssd_step": launches["ssd_step"], "ssd_step_op_by_op": step_launches_op_by_op,
            "ssd_step_err": max(max(e, f) for e, f, _ in step_checks),
            "ssd_step_timed": step_timed}


# ------------------------------------------ the vlm, audio and MoE families ----
def _full_width(arch, widths, layers):
    """``arch``'s full config, held to its published ``widths``, with its
    depth cut to ``layers`` (the whole model does not fit the card)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    got = {k: getattr(cfg, k) for k in widths}
    if got != widths:
        raise AssertionError(f"{arch} is not at full width: {got}, want {widths}")
    return dataclasses.replace(cfg, n_layers=layers), cfg.n_layers


def _drop_models() -> None:
    """Forget every serving engine (the engine module's registry holds each
    one, and its model) and hand the card's cached blocks back, so that the
    next model has the card to itself."""
    import gc

    import torch

    from repro_torch.serving import engine

    engine._ENGINES.clear()
    gc.collect()
    torch.cuda.empty_cache()


def _zero(counters) -> None:
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def _read(counters) -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}


def _k2_counters():
    from repro_torch.kernels.flash_attention import ops as fa_ops

    return {c: (fa_ops, c) for c in COUNTERS}


def _want_k2(n, route):
    return {"launches": n, "launches_sm90": n if route == "sm90" else 0,
            "launches_scalar": n if route == "scalar" else 0}


def _k2_in_model(model, batch, route, logits_rtol=None, closer=False):
    """K2 against its route's plain version inside ``model`` on ``batch``,
    in bf16 as served: first every layer's own q, k, v at the kernel's
    tolerance, in the forward with K2; then, with ``logits_rtol``, the
    logits at every position with K2 against those with that plain version
    and with a deliberately wrong attention (the plain version without its
    causal mask), which must fail the same tolerance.  With ``closer`` (a
    routing family, where one bf16 rounding flip in a router moves a token
    to another expert, so no tolerance fits), the logits with K2 must lie
    closer to those with the plain version than to those with the wrong
    attention, by the mean of |difference| over every logit."""
    import functools

    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_torch
    from repro_torch.models import layers

    arch = model.cfg.arch
    real = layers.flash_attention
    plain = functools.partial(flash_attention_torch, **fa_ops.PLAIN_ARGS[route])
    layer_excess = []

    def checked(q, k, v, causal=True):
        if fa_ops.route(q, k, v) != route:
            raise AssertionError(f"{arch}: a prefill layer's attention takes the "
                                 f"{fa_ops.route(q, k, v)} route, not {route}")
        got = real(q, k, v, causal=causal)
        layer_excess.append(attn_excess(got, plain(q, k, v, causal=causal)))
        return got

    def wrong(q, k, v, causal=True):
        return plain(q, k, v, causal=False)

    variants = {"kernel": checked}
    if logits_rtol or closer:
        variants.update(plain=plain, wrong=wrong)
    full = _logits_by_variant(model, batch, layers, "flash_attention", variants)
    if len(layer_excess) != model.cfg.n_layers or max(x for _, x in layer_excess) > 0:
        raise AssertionError(f"{arch}: K2 differs from its plain version inside the model: "
                             f"(max |error|, excess) per layer {layer_excess}")
    out = {"layer_max_abs_err": max(e for e, _ in layer_excess),
           "layer_max_excess": max(x for _, x in layer_excess)}
    if not logits_rtol:
        if not torch.isfinite(full["kernel"]).all():
            raise AssertionError(f"{arch}: bf16 forward logits with K2 are not finite")
        if closer:
            gap = {key: (full["kernel"].float() - full[key].float()).abs()
                   for key in ("plain", "wrong")}
            out.update({f"bf16_logits_kernel_vs_{key}_{stat}": getattr(d, stat)().item()
                        for key, d in gap.items() for stat in ("mean", "max")})
            if not gap["plain"].mean() < gap["wrong"].mean():
                raise AssertionError(f"{arch}: bf16 logits with K2 are no closer to those "
                                     f"with its plain version than to those with a wrong "
                                     f"attention: {out}")
        return out
    return {**out, **_logits_check(arch, full, "K2", logits_rtol)}


def _routed_logits_fp32(model, batch):
    """The logits at every position with the activations in fp32, three
    ways: with K2 (its scalar route: fp32), with that route's plain version
    and with the plain version without its causal mask.  In bf16 one
    rounding flip in a router can send a token to another expert, which no
    attention tolerance can absorb; in fp32 rounding is 2**16 times smaller.
    Every MoE layer's routing is recorded in each forward: the token-slots
    whose expert differs between the forward with K2 and the plain one are
    counted.  Only the forward with K2 launches it, once a layer."""
    import dataclasses

    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_torch
    from repro_torch.models import layers, moe

    cfg = model.cfg
    real_route, real_attn = moe.route, layers.flash_attention
    picks = {}

    def wrong(q, k, v, causal=True):
        return flash_attention_torch(q, k, v, causal=False)

    variants = {"kernel": real_attn, "plain": flash_attention_torch, "wrong": wrong}
    full, seen = {}, []

    def recorded(*args, **kw):
        r = real_route(*args, **kw)
        seen.append(r.top_e)
        return r

    counters = _k2_counters()
    _zero(counters)
    model.cfg = dataclasses.replace(cfg, dtype=torch.float32)
    moe.route = recorded
    try:
        for key, fn in variants.items():
            layers.flash_attention = fn
            seen = picks[key] = []
            full[key] = model.forward(batch)[0]
    finally:
        moe.route, layers.flash_attention, model.cfg = real_route, real_attn, cfg
    launches = _read(counters)
    if launches != _want_k2(cfg.n_layers, "scalar"):
        raise AssertionError(f"{cfg.arch}: K2 launches {launches} in the fp32 forwards, "
                             f"want {_want_k2(cfg.n_layers, 'scalar')}")
    flips = sum(int((a != b).sum()) for a, b in zip(picks["kernel"], picks["plain"]))
    slots = sum(a.numel() for a in picks["kernel"])
    # fp32 attention differs from its plain version by summation order, about
    # 1e-6 of each output, and that reaches the logits through every layer
    gaps = _logits_check(cfg.arch, full, "K2 (fp32 activations)", 1e-3)
    return {"fp32_k2_launches": launches, "fp32_expert_flips": flips,
            "fp32_token_slots": slots, **gaps}


def _drops(model, tokens, steps=16):
    """Token-slots dropped past an expert's capacity, summed over the MoE
    layers: in a prefill of ``tokens`` and in each of ``steps`` greedy
    decode steps after it, beside the token-slots routed."""
    from repro_torch.models import moe

    real = moe.route
    seen = []

    def recorded(*args, **kw):
        r = real(*args, **kw)
        seen.append((r.dropped, r.kept.numel()))
        return r

    moe.route = recorded
    try:
        logits, cache = model.prefill({"tokens": tokens}, max_len=2048)
        prefill = seen[:]
        decode = []
        tok = logits.argmax(-1)[:, None]
        for _ in range(steps):
            seen.clear()
            logits, cache = model.decode(cache, {"tokens": tok})
            tok = logits.argmax(-1)[:, None]
            decode.append(seen[:])
    finally:
        moe.route = real
    return {"prefill_dropped": sum(d for d, _ in prefill),
            "prefill_slots": sum(n for _, n in prefill),
            "decode_dropped_per_step": [sum(d for d, _ in s) for s in decode],
            "decode_slots_per_step": sum(n for _, n in decode[0])}


def _vlm_batch(cfg, B, text=128):
    """B prompts that each carry ``cfg.n_patches`` patch embeddings (seeded,
    bf16, at the token embeddings' scale) between ``text`` text tokens before
    and after, with positions3 as Qwen2-VL lays an image out: text at
    (i, i, i); the patches of a side x side grid at (text, text + row, text
    + col); the text after them from text + side on."""
    import torch

    P = cfg.n_patches
    side = int(P ** 0.5)
    S = 2 * text + P
    gen = torch.Generator(device="cuda").manual_seed(12)
    tokens = torch.randint(1, cfg.vocab, (B, S), generator=gen, device="cuda")
    embeds = (torch.randn(B, P, cfg.d_model, generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16)
    pos3 = torch.arange(S, device="cuda")[None, :, None].repeat(B, 1, 3)
    grid = torch.arange(P, device="cuda")
    pos3[:, text:text + P] = text + torch.stack(
        [torch.zeros_like(grid), grid // side, grid % side], -1)
    pos3[:, text + P:] = text + side + torch.arange(text, device="cuda")[:, None]
    return {"tokens": tokens, "patch_embeds": embeds,
            "patch_positions": torch.arange(text, text + P, device="cuda").repeat(B, 1),
            "positions3": pos3}


def _greedy(model, batch, max_len, steps=16):
    """Prefill plus ``steps`` greedy decode steps → the new tokens."""
    import torch

    logits, cache = model.prefill(batch, max_len=max_len)
    tok = logits.argmax(-1)[..., None]
    outs = []
    for _ in range(steps):
        outs.append(tok)
        logits, cache = model.decode(cache, {"tokens": tok})
        tok = logits.argmax(-1)[..., None]
    return torch.cat(outs, -1)


def phase_vlm():
    import torch

    t0 = time.perf_counter()
    _drop_models()          # phase 7's engine
    cfg, full = _full_width("qwen2-vl-72b", dict(
        family="vlm", d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128, d_ff=29568,
        vocab=152064, mrope_sections=(16, 24, 24), n_patches=1024), 16)
    counters = _k2_counters()
    run, model, _ = _serve(cfg, counters)
    n = cfg.n_layers
    if run["launches"] != _want_k2(2 * n, "sm90"):
        raise AssertionError(f"K2 launches {run['launches']} in the qwen2-vl-72b run: every "
                             f"bf16 prefill layer (64/8 heads, D 128) takes the sm90 route")

    # a model-level prefill of 4 prompts that each carry 1024 patch
    # embeddings with M-RoPE over their (t, h, w) grid, then decode steps
    batch = _vlm_batch(cfg, 4)
    S = batch["tokens"].shape[1]
    _zero(counters)
    new = _greedy(model, batch, S + 16)
    patch_launches = _read(counters)
    if patch_launches != _want_k2(n, "sm90"):
        raise AssertionError(f"K2 launches {patch_launches} in the patch prefill, want "
                             f"{_want_k2(n, 'sm90')}")
    if new.shape != (4, 16) or not ((new >= 0) & (new < cfg.vocab)).all():
        raise AssertionError(f"qwen2-vl-72b: bad tokens after the patch prefill: {new}")
    patch_prefill_ms = cuda_ms(lambda: model.prefill(batch, max_len=S + 16), 3, 1)
    checks = _k2_in_model(model, batch, "sm90", 5e-2)
    emit(phase="vlm", depth=[n, full], patch_batch=[4, S, cfg.n_patches],
         patch_launches=patch_launches, patch_prefill_ms=patch_prefill_ms,
         peak_gib_all=torch.cuda.max_memory_allocated() / 2**30, **checks, **run,
         seconds=time.perf_counter() - t0)
    del model
    _drop_models()
    return run["launches"]["launches_sm90"] + patch_launches["launches_sm90"]


def phase_audio():
    import numpy as np
    import torch

    from repro_torch.models import Model

    t0 = time.perf_counter()
    # 16 of 48 layers: the script's time limit (phases 16-17 added about
    # 170 s), not the card, sets this depth
    cfg, full = _full_width("musicgen-large", dict(
        family="audio", d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64, d_ff=8192,
        vocab=2048, codebooks=4), 16)
    K = cfg.codebooks
    model = Model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (K, int(rng.integers(128, 1025))))
               for _ in range(8)]

    def batch_of(ps):
        """[4, K, S] codebook tokens, left-padded with 0 to the longest."""
        S = max(p.shape[1] for p in ps)
        toks = np.zeros((len(ps), K, S), np.int64)
        for i, p in enumerate(ps):
            toks[i, :, S - p.shape[1]:] = p
        return torch.from_numpy(toks).to("cuda")

    counters = _k2_counters()
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    t1 = time.perf_counter()
    batches = [batch_of(prompts[:4]), batch_of(prompts[4:])]
    new = [_greedy(model, {"tokens": b}, b.shape[2] + 16) for b in batches]
    generated = torch.cat(new).tolist()
    wall = time.perf_counter() - t1
    launches = _read(counters)
    n = cfg.n_layers
    if launches != _want_k2(2 * n, "sm90"):
        raise AssertionError(f"K2 launches {launches} in the musicgen-large run: every bf16 "
                             f"prefill layer (32/32 heads, D 64) takes the sm90 route")
    for row in generated:
        if len(row) != K or any(len(c) != 16 or not all(0 <= t < cfg.vocab for t in c)
                                for c in row):
            raise AssertionError(f"musicgen-large: bad tokens {row}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    tokens = batches[0]
    S = tokens.shape[2]
    prefill_ms = cuda_ms(lambda: model.prefill({"tokens": tokens}, max_len=S + 16), 3, 1)
    logits, cache = model.prefill({"tokens": tokens}, max_len=S + 16)
    tok = logits.argmax(-1)[..., None]

    def decode_steps():
        c, t = dict(cache), tok
        for _ in range(16):
            lg, c = model.decode(c, {"tokens": t})
            t = lg.argmax(-1)[..., None]

    decode_ms = cuda_ms(decode_steps, 3, 1) / 16
    profiles = {"prefill": device_profile(
                    lambda: model.prefill({"tokens": tokens}, max_len=S + 16), 2, top=8),
                "decode_16_steps": device_profile(decode_steps, 2, top=8)}
    checks = _k2_in_model(model, {"tokens": tokens}, "sm90", 5e-2)
    emit(phase="audio", arch=cfg.arch, depth=[n, full], params=cfg.param_count(),
         init_s=init_s, prompts=8, codebooks=K, prompt_frames=[p.shape[1] for p in prompts],
         batches=2, new_tokens=16, wall_s=wall, frames_per_s=8 * 16 / wall,
         prefill_ms_batch0=prefill_ms, decode_ms_per_token=decode_ms, peak_gib=peak_gib,
         launches=launches, busy_share=busy_share(profiles), profile=profiles, **checks,
         seconds=time.perf_counter() - t0)
    del model, cache
    _drop_models()
    return launches["launches_sm90"]


def phase_moe():
    t0 = time.perf_counter()
    # 8 of 32 layers, for the script's time (16 fit the card beside the checks)
    cfg, full = _full_width("phi3.5-moe-42b-a6.6b", dict(
        family="moe", d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128, d_ff=6400,
        vocab=32064, n_experts=16, top_k=2, d_ff_expert=6400, capacity_factor=1.25), 8)
    run, model, tokens = _serve(cfg, _k2_counters())
    n = cfg.n_layers
    if run["launches"] != _want_k2(2 * n, "sm90"):
        raise AssertionError(f"K2 launches {run['launches']} in the phi3.5-moe run: every "
                             f"bf16 prefill layer (32/8 heads, D 128) takes the sm90 route")
    drops = _drops(model, tokens)
    bf16 = _k2_in_model(model, {"tokens": tokens}, "sm90")
    fp32 = _routed_logits_fp32(model, {"tokens": tokens})
    emit(phase="moe", depth=[n, full], drops=drops, **bf16, **fp32, **run,
         seconds=time.perf_counter() - t0)
    del model
    _drop_models()
    return {"sm90": run["launches"]["launches_sm90"],
            "scalar": fp32["fp32_k2_launches"]["launches_scalar"]}


# the decode step's dropless MoE at full width: (arch, d, F, E, k, held,
# act, the rule's options) for Nemotron 3 Nano's 128 experts, all held, and
# DeepSeek-V2's 160, 20 held (one chip of EP8)
MOE_DECODE_LAYERS = {
    "nemotron-3-nano-30b-a3b": (2688, 1856, 128, 6, None, "relu2",
                                dict(norm_topk_prob=True, routed_scaling_factor=2.5,
                                     scoring="sigmoid")),
    "deepseek-v2-236b": (5120, 1536, 160, 6, (0, 20), "swiglu",
                         dict(n_group=8, topk_group=3, norm_topk_prob=False,
                              routed_scaling_factor=16.0)),
}


def _moe_decode_routes(arch, batches=(8, 64), draws=8, iters=48):
    """The decode step's routed-expert products alone, one layer at full
    width, by both dropless routes at each batch: ``grouped`` (the T·k
    slots grouped by expert over counts kept on the device, one grouped
    GEMM a projection, ``moe._grouped_experts``) and ``batched`` (C = T,
    every held expert over T rows, ``moe._batched_experts``), each from the
    routing's slots to the experts' outputs, over ``draws`` batches of
    tokens taken in turn (their routings differ, as a served step's do).
    For each: device ms (profiler, CUDA events beside it), ms replayed as
    CUDA graphs (one captured a draw, its replay equal to the op-by-op
    call bit for bit), the experts whose weights it reads a call
    (``experts_read``, the mean), those bytes and their bound at 3.35 TB/s."""
    import torch

    from repro_torch.models import moe

    d, F, E, k, held, act, rule = MOE_DECODE_LAYERS[arch]
    rule = moe.Rule(**rule)
    g = torch.Generator(device="cuda").manual_seed(E)
    layer = moe.MoE(g, d, F, E, device="cuda", held=held, act=act,
                    score_bias=rule.scoring == "sigmoid")
    if layer.e_score_correction_bias is not None:
        layer.e_score_correction_bias.copy_(
            torch.randn(E, generator=g, device="cuda").float() * 0.05)
    bias = layer.e_score_correction_bias
    n_held = E if held is None else held[1]
    per_expert = (2 if act == "relu2" else 3) * d * F * 2
    out = {}
    for B in batches:
        calls = {"grouped": [], "batched": []}
        read, held_slots = [], []
        for _ in range(draws):
            xf = torch.randn(B, d, generator=g, device="cuda").bfloat16()
            logits = xf.float() @ layer.router.float()
            probs = torch.sigmoid(logits) if rule.scoring == "sigmoid" else torch.softmax(logits, -1)
            r = moe.Routing(*moe._route_probs(probs, k, None, held, rule, None, bias))
            c = moe.Routing(*moe._route_probs(probs, k, B, held, rule, None, bias))
            calls["grouped"].append(
                lambda x=xf, r=r: moe._grouped_experts(layer, x[r.token_idx], r.counts))
            calls["batched"].append(
                lambda x=xf, c=c: moe._batched_experts(layer, x, c.token_idx, ()))
            read.append(int(r.experts_read))
            held_slots.append(int(r.held.sum()))
        row = {"T_k": B * k, "E": E, "held_slots": held_slots,
               "rule_takes": "grouped" if B * k < E else "batched"}
        for name, fns in calls.items():
            n_read = sum(read) / draws if name == "grouped" else n_held
            n_bytes = n_read * per_expert
            b, by = bound_ms(n_bytes, 0, "bfloat16")
            turn = [0]

            def call(fns=fns):
                fns[turn[0] % draws]()
                turn[0] += 1
            times = kernel_times(iters, b, ms=call)
            graphs = []
            for i, fn in enumerate(fns):
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    fn()
                torch.cuda.current_stream().wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    captured = fn()
                graph.replay()
                eager = fn()
                torch.cuda.synchronize()
                rows = held_slots[i] if name == "grouped" else eager.numel() // d
                if not torch.equal(captured.reshape(-1, d)[:rows], eager.reshape(-1, d)[:rows]):
                    raise AssertionError(f"{arch} B {B}: the {name} route's graph replay is "
                                         f"not its op-by-op call bit for bit")
                graphs.append(graph)
            turn[0] = 0

            def replay():
                graphs[turn[0] % draws].replay()
                turn[0] += 1
            row[name] = {"experts_read": n_read, "gbytes": n_bytes / 1e9, "bound_ms": b,
                         "bound_by": by, "graph_ms": cuda_ms(replay, iters),
                         "tb_s": n_bytes / times["ms"] / 1e9, **times}
            del graphs
        row["grouped_no_slower"] = (row["grouped"]["ms"] <= row["batched"]["ms"]
                                    and row["grouped"]["graph_ms"] <= row["batched"]["graph_ms"])
        out[f"b{B}"] = row
    del layer
    torch.cuda.empty_cache()
    return out


def phase_moe_decode():
    """The decode expert products alone by both dropless routes, at
    Nemotron's and DeepSeek's widths and decode batches 8 and 64
    (``_moe_decode_routes``): the numbers that choose the route rule."""
    t0 = time.perf_counter()
    routes = {arch: _moe_decode_routes(arch) for arch in MOE_DECODE_LAYERS}
    emit(phase="moe_decode", routes=routes, seconds=time.perf_counter() - t0)
    return routes


def _k2_at_deepseek_shape(max_err):
    """Both K2 kernels at deepseek-v2's prefill shape (B 4, S 1024, 128
    heads, D 192, Dv 128, bf16, causal), which takes the sm90 route: each
    held to its own plain version once, then timed beside it, and beside
    scaled_dot_product_attention where that takes the shape (the yardstick
    only; the port never calls it).  The scalar kernel, called by its own
    launcher, keeps the time of its row before the sm90 route took the
    shape.  ``max_err`` is each route's largest error so far."""
    import torch

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_torch

    B, S, H, D, Dv = 4, 1024, 128, 192, 128
    q, k, v = _attn_inputs(B, S, H, H, D, Dv, torch.bfloat16, 15)
    if ops.route(q, k, v) != "sm90":
        raise AssertionError("deepseek-v2's prefill shape does not take the sm90 route")
    kernels = {"sm90": (ops.flash_attention_sm90, ops.flash_attention_plain, 20),
               "scalar": (ops.flash_attention_scalar, flash_attention_torch, 10)}
    flops = 2 * B * H * (D + Dv) * S * (S + 1) / 2          # the causal pairs only
    n_bytes = 2 * (q.numel() + k.numel() + v.numel() + B * S * H * Dv)
    b, by = bound_ms(n_bytes, flops, "bfloat16")
    try:
        sdpa = _sdpa(q, k, v, True)
        sdpa()
        lib = kernel_times(10, b, library_ms=sdpa)
        lib["library_top_ms"] = device_profile(sdpa, 5, top=4)["top_ms"]
    except RuntimeError as e:          # no SDPA backend takes D != Dv here
        lib = {"library_ms": None, "library_event_ms": None, "timers": {},
               "library_error": str(e)[:200]}
    out = {}
    for route, (kernel, plain, iters) in kernels.items():
        err, excess = attn_excess(kernel(q, k, v), plain(q, k, v))
        if not excess <= 0:
            raise AssertionError(f"K2 {route} at deepseek-v2's shape: error {err} exceeds "
                                 f"its tolerance by {excess}")
        times = kernel_times(iters, b, ms=lambda: kernel(q, k, v),
                             plain_ms=lambda: plain(q, k, v))
        out[route] = {**times, **lib, "timers": {**times["timers"], **lib["timers"]},
                      "max_abs_err": max(max_err[route], err), "shape": [B, S, H, H, D, Dv],
                      "bound_ms": b, "bound_by": by, "tflops": flops / times["ms"] / 1e9}
        emit(phase="k2_timing", arch="deepseek-v2-236b", route=route, **out[route])
    return out


def phase_mla(k2_err):
    t0 = time.perf_counter()
    cfg, full = _full_width("deepseek-v2-236b", dict(
        family="mla_moe", d_model=5120, n_heads=128, n_kv_heads=128, q_lora=1536,
        kv_lora=512, nope_head_dim=128, rope_head_dim=64, v_head_dim=128, n_experts=160,
        top_k=6, n_shared_experts=2, d_ff_expert=1536, capacity_factor=1.25,
        vocab=102400), 4)
    run, model, tokens = _serve(cfg, _k2_counters())
    n = cfg.n_layers
    if run["launches"] != _want_k2(2 * n, "sm90"):
        raise AssertionError(f"K2 launches {run['launches']} in the deepseek-v2 run, want "
                             f"{_want_k2(2 * n, 'sm90')}: every bf16 prefill layer (128 "
                             f"heads, D 192, Dv 128) takes the sm90 route")
    prof = run["profile"]["prefill"]
    share = (prof["kernel_ms"]["k2_sm90"] / prof["device_ms"]
             if prof["device_ms"] else None)
    drops = _drops(model, tokens)
    bf16 = _k2_in_model(model, {"tokens": tokens}, "sm90", closer=True)
    fp32 = _routed_logits_fp32(model, {"tokens": tokens})
    emit(phase="mla_moe", depth=[n, full], drops=drops,
         k2_sm90_prefill_ms=prof["kernel_ms"]["k2_sm90"], k2_sm90_share_of_prefill=share,
         k2_scalar_prefill_ms=prof["kernel_ms"]["k2_scalar"], **bf16, **fp32, **run,
         seconds=time.perf_counter() - t0)
    del model
    _drop_models()
    timed = _k2_at_deepseek_shape({**k2_err, "sm90": max(k2_err["sm90"],
                                                          bf16["layer_max_abs_err"])})
    return {"sm90": run["launches"]["launches_sm90"],
            "scalar_fp32": fp32["fp32_k2_launches"]["launches_scalar"], "timed": timed}


# ---------------------------------------------------- xlstm and training ----
def _all_counters():
    """K1's, K2's and K3's launch counters (and K2's and K3's backward
    calls), by name."""
    from repro_torch.kernels.event_join import ops as k1_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    return {"k1": (k1_ops, "launches"), **{f"k2_{c}": (fa_ops, c) for c in COUNTERS},
            **{f"k3_{c}": (ssd_ops, c) for c in COUNTERS},
            "k2_backward_calls": (fa_ops, "backward_calls"),
            "k3_backward_calls": (ssd_ops, "backward_calls")}


RANGES = ("slstm_scan", "k2_plain_backward")   # this script's record_functions


def _kernel_events(prof_events):
    """The profile's device activities, without the spans that the
    script's ranges leave on the device's timeline."""
    from torch.autograd import DeviceType

    return [e for e in prof_events if e.device_type == DeviceType.CUDA and e.name not in RANGES]


def _range_ms(prof_events, name, iters):
    """Device ms per call of the kernels launched inside every profiled
    range called ``name`` (a record_function of this script's), and how
    many device operations they were."""
    from torch.autograd import DeviceType

    ranges = [e for e in prof_events if e.name == name and e.device_type == DeviceType.CPU]
    return (sum(e.device_time_total for e in ranges) / 1e3 / iters,
            sum(len(e.kernels) + sum(len(c.kernels) for c in _cpu_descendants(e))
                for e in ranges) / iters)


def _cpu_descendants(event):
    out, todo = [], list(event.cpu_children)
    while todo:
        e = todo.pop()
        out.append(e)
        todo.extend(e.cpu_children)
    return out


def _step_recurrence_check(layer, h, cfg):
    """One layer's own input ``h`` [B,S,d] at full width, in fp32 (weights
    and input cast): the chunked mLSTM against its step recurrence, or
    slstm_forward against step-by-step slstm_decode → (max |difference|,
    max |step output|)."""
    import copy

    import torch

    from repro_torch.models import xlstm as XL

    h = h.float()
    B, S, d = h.shape
    if layer.slstm is not None:
        p = copy.deepcopy(layer.slstm).float()
        full = XL.slstm_forward(p, h, cfg.n_heads)
        st = tuple(torch.zeros(B, cfg.n_heads, d // cfg.n_heads, device=h.device)
                   for _ in range(3))
        step = XL.slstm_decode
    else:
        p = copy.deepcopy(layer.mlstm).float()
        full = XL.mlstm_forward(p, h, cfg.n_heads, cfg.mlstm_chunk)
        Dh = cfg.ssm_expand * d // cfg.n_heads
        st = (torch.zeros(B, cfg.n_heads, Dh, Dh, device=h.device),
              torch.zeros(B, cfg.n_heads, Dh, device=h.device))
        step = XL.mlstm_decode
    outs = []
    for t in range(S):
        o, st = step(p, h[:, t:t + 1], st, cfg.n_heads)
        outs.append(o)
    want = torch.cat(outs, 1)
    return (full - want).abs().max().item(), want.abs().max().item()


def phase_xlstm():
    """xlstm-1.3b at full width, served, 24 of its 48 layers (cut for the
    script's time since phase 18 grew; three of its six sLSTM blocks); no
    kernel of K1-K3 behind it."""
    import torch

    from repro_torch.models import xlstm as XL

    t0 = time.perf_counter()
    _drop_models()
    cfg, full = _full_width("xlstm-1.3b", dict(
        family="xlstm", d_model=2048, n_heads=4, ssm_expand=2, slstm_every=8,
        mlstm_chunk=128, vocab=50304), 24)
    slstm_layers = [i for i in range(cfg.n_layers) if cfg.is_slstm(i)]
    if slstm_layers != [1, 9, 17]:
        raise AssertionError(f"xlstm-1.3b's sLSTM layers are {slstm_layers}")
    # its prefill launches about 10**5 small kernels, most in the sLSTM
    # scans, which the profiler takes long to read: the prefill and 16
    # decode steps are profiled once each, below
    run, model, tokens = _serve(cfg, _all_counters(), profile=False)
    if any(run["launches"].values()):
        raise AssertionError(f"the xlstm run launched a kernel of K1-K3: {run['launches']}")

    # the sLSTM scans' share of one prefill's device time (each
    # slstm_forward inside a profiled range of its own) and the cell steps
    # they run
    real_fwd, real_step = XL.slstm_forward, XL.slstm_cell_step
    steps = []

    def ranged(*args, **kw):
        with torch.profiler.record_function("slstm_scan"):
            return real_fwd(*args, **kw)

    def counted(*args, **kw):
        steps.append(1)
        return real_step(*args, **kw)

    from torch.profiler import ProfilerActivity, profile

    S = tokens.shape[1]
    XL.slstm_forward, XL.slstm_cell_step = ranged, counted
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            model.prefill({"tokens": tokens}, max_len=2048)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t1) * 1e3
    finally:
        XL.slstm_forward, XL.slstm_cell_step = real_fwd, real_step
    events = prof.events()
    scan_ms, scan_ops = _range_ms(events, "slstm_scan", 1)
    device_ms = sum(e.device_time_total for e in _kernel_events(events)) / 1e3
    if len(steps) != len(slstm_layers) * S:
        raise AssertionError(f"{len(steps)} sLSTM cell steps in a prefill of {S} tokens")

    # layer 0 (an mLSTM) and layer 1 (an sLSTM) on their own inputs, in fp32
    recurrences = {}
    prefill = {"wall_ms": wall_ms, "device_ms": device_ms or None,
               "device_ops": len(_kernel_events(events))}
    logits, cache = model.prefill({"tokens": tokens}, max_len=2048)

    def decode_steps():
        c, t = dict(cache), logits.argmax(-1)[:, None]
        for _ in range(16):
            lg, c = model.decode(c, {"tokens": t})
            t = lg.argmax(-1)[:, None]

    run["profile"] = {"prefill": prefill, "decode_16_steps": device_profile(decode_steps, 1)}
    run["busy_share"] = busy_share(run["profile"])
    del logits, cache

    with torch.no_grad():
        x = model._embed({"tokens": tokens})
        for i, kind in ((0, "mlstm"), (1, "slstm")):
            lp = model.layers[i]
            h = lp.norm(x)
            err, scale = _step_recurrence_check(lp, h, cfg)
            x = x + (XL.mlstm_forward(lp.mlstm, h, cfg.n_heads, cfg.mlstm_chunk)
                     if lp.mlstm is not None else XL.slstm_forward(lp.slstm, h, cfg.n_heads))
            # fp32 in another order: the chunked form sums over chunk pairs
            # and D = 1024 where the recurrence accumulates the state step
            # by step
            tol = 1e-3 * (1 + scale)
            recurrences[kind] = {"max_abs_err": err, "max_abs_out": scale, "tolerance": tol}
            if not err <= tol:
                raise AssertionError(f"xlstm-1.3b layer {i}: {kind} forward differs from its "
                                     f"step recurrence by {err} > {tol}")
    emit(phase="xlstm", depth=[cfg.n_layers, full],
         slstm_layers=slstm_layers, prefill_S=S, prefill_slstm_steps=len(steps),
         slstm_scan_device_ms=scan_ms, slstm_scan_device_ops=scan_ops,
         slstm_share_of_prefill=scan_ms / device_ms if device_ms else None,
         recurrence_checks_fp32=recurrences, **run, seconds=time.perf_counter() - t0)
    del model
    _drop_models()


def _grads(model, batch):
    """The loss's gradient of every parameter (the tensors autograd made,
    then cleared from the parameters)."""
    loss, _ = model.loss(batch)
    loss.backward()
    out = {}
    for k, p in model.named_parameters():
        out[k], p.grad = p.grad, None
    return out


def _grad_check(model, batch, tol):
    """The gradients with K2 in the forward (its Function: the kernel
    forward, the plain backward) against those with the sm90 route's plain
    version in the forward (autograd through it); and, against the same,
    the plain version with kv tiles of 64 (equally right: the rounding
    floor) and a wrong (non-causal) attention.  Per leaf: the relative L2
    error, and whether its gradient is non-zero.  Every leaf with a
    non-zero gradient in the plain run must have one with K2 (and the
    other way), wq, wk and wv of every layer among them; each leaf's error
    within ``tol``; all leaves' within twice the floor's; the wrong
    attention's farther than K2's."""
    import functools

    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_torch
    from repro_torch.models import layers

    real = layers.flash_attention
    plain = functools.partial(flash_attention_torch, **fa_ops.PLAIN_ARGS["sm90"])
    variants = {
        "plain": plain,
        "kernel": real,
        "plain_block64": functools.partial(flash_attention_torch, p_split=True, block_k=64),
        "wrong": lambda q, k, v, causal=True: plain(q, k, v, causal=False)}
    errs, nonzero, norms = {}, {}, {}
    try:
        for key, fn in variants.items():
            layers.flash_attention = fn
            grads = _grads(model, batch)
            nonzero[key] = {k: bool((g != 0).any()) for k, g in grads.items()}
            if key == "plain":
                want = grads
                continue
            num = den = 0.0
            errs[key] = {}
            for k, g in grads.items():
                d2 = (g.float() - want[k].float()).square().sum().item()
                w2 = want[k].float().square().sum().item()
                errs[key][k] = (d2 / w2) ** 0.5 if w2 else float(d2 > 0)
                num, den = num + d2, den + w2
            errs[key]["all"] = (num / den) ** 0.5
            if key == "kernel":
                norms = {k: [g.float().norm().item(), want[k].float().norm().item()]
                         for k, g in grads.items() if k.startswith("layers.0.attn.w")}
            del grads
    finally:
        layers.flash_attention = real
    del want
    torch.cuda.empty_cache()
    lost = [k for k, nz in nonzero["plain"].items() if nz != nonzero["kernel"][k]]
    if lost:
        raise AssertionError(f"with K2 these leaves' gradients are zero where the plain "
                             f"run's are not (or the other way): {lost}")
    for name in ("wq", "wk", "wv"):
        if not all(nonzero["kernel"][f"layers.{i}.attn.{name}"]
                   for i in range(model.cfg.n_layers)):
            raise AssertionError(f"no gradient reaches {name} through K2")
    worst = max((e, k) for k, e in errs["kernel"].items() if k != "all")
    if not worst[0] <= tol:
        raise AssertionError(f"K2's gradient of {worst[1]} lies {worst[0]} from the plain "
                             f"run's, over the tolerance {tol}")
    # and, over all leaves, within twice the floor: a kernel that differs by
    # rounding alone lands about as far as the plain version at another tile
    if not errs["kernel"]["all"] <= 2 * errs["plain_block64"]["all"]:
        raise AssertionError(f"K2's gradients lie {errs['kernel']['all']} from the plain "
                             f"run's, over twice the rounding floor "
                             f"{errs['plain_block64']['all']}")
    if not errs["wrong"]["all"] > errs["kernel"]["all"]:
        raise AssertionError(f"a wrong attention's gradients lie no farther from the plain "
                             f"run's than K2's: {errs['wrong']['all']} <= "
                             f"{errs['kernel']['all']}")
    return {"tolerance": tol, "kernel_max_leaf_rel_l2": worst[0], "kernel_worst_leaf": worst[1],
            "kernel_rel_l2_all": errs["kernel"]["all"],
            "floor_block64_rel_l2_all": errs["plain_block64"]["all"],
            "floor_block64_max_leaf_rel_l2": max(e for k, e in errs["plain_block64"].items()
                                                 if k != "all"),
            "wrong_rel_l2_all": errs["wrong"]["all"],
            "wrong_min_leaf_rel_l2": min(e for k, e in errs["wrong"].items() if k != "all"),
            "nonzero_leaves": sum(nonzero["kernel"].values()), "leaves": len(nonzero["kernel"]),
            "layer0_qkv_grad_norm_kernel_vs_plain": norms}


def _train_steps(model, data, n):
    """``n`` steps of make_train_step on the copy task, each profiled:
    loss, ms (host wall ending in a synchronize), tokens/s, the busy share,
    K2's launches and share of the step's device time, the plain backward's
    share (each call of K2's backward inside a profiled range of this
    script's), peak memory."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_step import make_train_step

    opt = AdamW()
    step_fn = make_train_step(model, opt)
    state = opt.init(dict(model.named_parameters()))
    real_bwd = fa_ops.FlashAttentionFn.backward

    def ranged(ctx, grad_out):
        with torch.profiler.record_function("k2_plain_backward"):
            return real_bwd(ctx, grad_out)

    rows = []
    fa_ops.FlashAttentionFn.backward = staticmethod(ranged)
    try:
        for i in range(n):
            batch = {k: torch.from_numpy(v).long().cuda() for k, v in data.batch_at(i).items()}
            torch.cuda.reset_peak_memory_stats()
            launches, calls = fa_ops.launches_sm90, fa_ops.backward_calls
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            events = prof.events()
            kernels = _kernel_events(events)
            device_ms = sum(e.device_time_total for e in kernels) / 1e3
            k2_ms = sum(e.device_time_total for e in kernels
                        if KERNEL_NAMES["k2_sm90"] in e.name) / 1e3
            bwd_ms, bwd_ops = _range_ms(events, "k2_plain_backward", 1)
            by_name: dict = {}
            for e in kernels:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
            tokens = batch["tokens"].numel()
            rows.append({"step": i + 1, "loss": loss, "grad_norm": float(metrics["grad_norm"]),
                         "ms": ms, "tokens_per_s": tokens / ms * 1e3,
                         "device_ms": device_ms or None,
                         "busy_share": device_ms / ms if device_ms else None,
                         "k2_launches": fa_ops.launches_sm90 - launches,
                         "k2_backward_calls": fa_ops.backward_calls - calls,
                         "k2_device_ms": k2_ms,
                         "k2_share": k2_ms / device_ms if device_ms else None,
                         "plain_backward_device_ms": bwd_ms,
                         "plain_backward_device_ops": bwd_ops,
                         "plain_backward_share": bwd_ms / device_ms if device_ms else None,
                         "device_ops": len(kernels),
                         "top_ms": [[k[:80], v] for k, v in sorted(
                             by_name.items(), key=lambda kv: -kv[1])[:6]],
                         "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    finally:
        fa_ops.FlashAttentionFn.backward = staticmethod(real_bwd)
    del state
    return rows


def _orchestrated(cfg_full, tmp):
    """run_training at full width, depth cut to 2 layers: 2 steps, then a
    new run on the same workdir to step 4, which must resume at step 2 with
    the saved parameters bit for bit; no K1 launch (the state machine's
    triggers are not counting joins); save and restore timed."""
    import dataclasses
    import shutil

    import torch

    from repro_torch.training import checkpoint as ckpt_lib
    from repro_torch.training import trainer

    cfg = dataclasses.replace(cfg_full, n_layers=2)
    n_params = cfg.param_count()
    need = 2 * 12 * n_params + 4 * 2**30        # two checkpoints of fp32 params, m, v
    workdir = tmp / "train"
    free = shutil.disk_usage(tmp).free
    if free < need:
        raise AssertionError(f"the orchestrated training needs {need / 1e9:.1f} GB of disk "
                             f"for two checkpoints, {free / 1e9:.1f} GB are free under {tmp}")
    timed = {"save": [], "restore": []}
    real_save, real_restore = ckpt_lib.save, ckpt_lib.restore

    def timed_save(*args, **kw):
        t0 = time.perf_counter()
        final = real_save(*args, **kw)
        timed["save"].append([time.perf_counter() - t0, sum(
            f.stat().st_size for f in Path(final).iterdir())])
        return final

    def timed_restore(*args, **kw):
        t0 = time.perf_counter()
        out = real_restore(*args, **kw)
        timed["restore"].append(time.perf_counter() - t0)
        return out

    restored = {}
    real_ensure = trainer.TorchCluster.ensure_state

    def ensure_state(self):
        fresh = self.model is None
        real_ensure(self)
        if fresh:
            restored["step"] = self.step
            restored["params"] = {k: p.detach().cpu().clone()
                                  for k, p in self.model.named_parameters()}

    counters = _all_counters()
    _zero(counters)
    ckpt_lib.save, ckpt_lib.restore = timed_save, timed_restore
    trainer.TorchCluster.ensure_state = ensure_state
    try:
        t0 = time.perf_counter()
        first = trainer.run_training(cfg, str(workdir), total_steps=2, chunk_steps=2,
                                     batch=8, seq=256, device="cuda")
        saved = {k: p.detach().cpu() for k, p in
                 first["cluster"].model.named_parameters()}
        del first
        _drop_models()
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        second = trainer.run_training(cfg, str(workdir), total_steps=4, chunk_steps=2,
                                      batch=8, seq=256, device="cuda")
        second_s = time.perf_counter() - t0
    finally:
        ckpt_lib.save, ckpt_lib.restore = real_save, real_restore
        trainer.TorchCluster.ensure_state = real_ensure
    launches = _read(counters)
    hist = second["history"]
    status = second["workflow_result"]["status"]
    same = all(torch.equal(restored["params"][k], t) for k, t in saved.items())
    if not (status == "succeeded" and restored["step"] == 2 and hist[0]["step"] == 4
            and same and ckpt_lib.latest_step(str(workdir)) == 4):
        raise AssertionError(f"the orchestrated run did not resume at step 2 with the saved "
                             f"parameters: status {status}, restored step "
                             f"{restored['step']}, history {hist}, parameters equal {same}")
    if launches["k1"]:
        raise AssertionError(f"the training state machine launched K1 {launches['k1']} times")
    del second, saved, restored
    _drop_models()
    shutil.rmtree(workdir)
    return {"depth": [cfg.n_layers, cfg_full.n_layers], "params": n_params,
            "first_run_s": first_s, "second_run_s": second_s, "history": hist,
            "save_s_bytes": timed["save"], "restore_s": timed["restore"],
            "launches": launches, "resumed_at": 2, "restored_params_equal_saved": True,
            "disk_free_gb": free / 1e9}


def phase_train(tmp):
    """llama3.2-3b trained at full width and depth (28 layers, lm_head
    untied): the gradient check, 5 steps of make_train_step on the copy task
    (batch 8, seq 256, bf16 parameters, fp32 moments), then the
    trigger-orchestrated loop at 2 of 28 layers."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.training.data import SyntheticData

    t0 = time.perf_counter()
    _drop_models()
    cfg = get_config("llama3.2-3b")
    if (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab) != (28, 3072, 24, 8, 128, 8192, 128256):
        raise AssertionError(f"llama3.2-3b is not at full width: {cfg}")
    model = Model(cfg, device="cuda", seed=0)
    model.requires_grad_(True)
    data = SyntheticData(cfg.vocab, 256, 8, kind="copy_task", seed=0)
    batch = {k: torch.from_numpy(v).long().cuda() for k, v in data.batch_at(0).items()}
    # bf16 gradients through 28 layers: the attention's rounding differs
    # between K2 and its plain version in some outputs of every layer
    checks = _grad_check(model, batch, tol=5e-2)
    counters = _all_counters()
    _zero(counters)
    steps = _train_steps(model, data, 5)
    launches = _read(counters)
    # remat recomputes each block's forward, K2 with it, in the backward
    per_step = cfg.n_layers * (2 if cfg.remat and cfg.remat_policy != "none" else 1)
    if launches["k2_launches_sm90"] != 5 * per_step or launches["k1"] or \
            launches["k2_backward_calls"] != 5 * cfg.n_layers:
        raise AssertionError(f"launches in 5 train steps: {launches}; want K2's sm90 route "
                             f"{per_step} times a step (remat {cfg.remat_policy}) and its "
                             f"backward once a layer a step, no K1")
    if not all(torch.isfinite(torch.tensor(r["loss"])) for r in steps):
        raise AssertionError(f"llama3.2-3b: a train step's loss is not finite: {steps}")
    del model
    _drop_models()
    orchestrated = _orchestrated(cfg, tmp)
    emit(phase="train", arch=cfg.arch, params=cfg.param_count(), batch=8, seq=256,
         grad_check=checks, steps=steps, launches=launches, orchestrated=orchestrated,
         seconds=time.perf_counter() - t0)
    return {"train": launches["k2_launches_sm90"],
            "train_orchestrated": orchestrated["launches"]["k2_launches_sm90"]}


# ------------------------------------------------------------ the mesh path ----
def _full(t):
    """A DTensor's whole value (a plain tensor as it is)."""
    return t.full_tensor() if type(t).__name__ == "DTensor" else t


def _mesh_batch(batch, resolver):
    """The batch's tensors split at ("batch", None, ...) on the resolver's
    mesh (every rank passes the same whole tensors)."""
    from torch.distributed.tensor import distribute_tensor

    return {k: distribute_tensor(v, resolver.mesh,
                                 resolver(("batch",) + (None,) * (v.dim() - 1), v.shape))
            for k, v in batch.items()}


def _compared_steps(cfg, data, n, resolver=None, want=None):
    """``n`` steps of make_train_step from seed 0, without a mesh or (with
    ``resolver``) on its mesh, the parameters DTensors; each step profiled:
    loss, ms (host wall ending in a synchronize), the busy share, peak
    memory.  Without a mesh each step's gradients are kept on the host;
    on the mesh each step's are held leaf by leaf against ``want``'s
    (relative L2 per leaf, on the card) → (rows, the kept gradients)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.distributed.sharding import activate, distribute_model
    from repro_torch.models import Model
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_step import make_train_step

    seen = []

    class Recording(AdamW):
        def update(self, grads, state, params):
            seen.append(dict(grads))
            return super().update(grads, state, params)

    model = Model(cfg, device="cuda", seed=0)
    if resolver is not None:
        distribute_model(model, resolver)
    opt = Recording()
    step_fn = make_train_step(model, opt)
    state = opt.init(dict(model.named_parameters()))
    rows, kept = [], []
    for i in range(n):
        batch = {k: torch.from_numpy(v).long().cuda() for k, v in data.batch_at(i).items()}
        if resolver is not None:
            batch = _mesh_batch(batch, resolver)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if resolver is None:
                state, metrics = step_fn(state, batch)
            else:
                with activate(resolver):
                    state, metrics = step_fn(state, batch)
            loss = float(_full(metrics["loss"]))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        device_ms = sum(e.device_time_total for e in _kernel_events(prof.events())) / 1e3
        row = {"step": i + 1, "loss": loss, "ms": ms, "device_ms": device_ms or None,
               "busy_share": device_ms / ms if device_ms else None,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        grads = seen.pop()
        if resolver is None:
            kept.append({k: g.detach().cpu() for k, g in grads.items()})
        else:
            errs = {}
            for k, g in grads.items():
                w = want[i][k].cuda().float()
                d = (_full(g).float() - w).norm().item()
                errs[k] = d / w.norm().item() if w.norm().item() else float(d > 0)
            worst = max(errs, key=errs.get)
            row.update(grad_max_leaf_rel_l2=errs[worst], grad_worst_leaf=worst,
                       grad_leaves_bit_equal=sum(e == 0 for e in errs.values()),
                       grad_leaves=len(errs))
        del grads
        rows.append(row)
    del model, state, step_fn, opt
    _drop_models()
    return rows, kept


def _dryrun_cell(arch, shape, timeout=240):
    """``python -m repro_torch.launch.dryrun`` on one cell, trace-proof only,
    in a process of its own (the fake 512-rank group must own its
    interpreter), with no card visible → its result."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                          "--shape", shape, "--no-probe"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    path = ROOT / "results" / "torch" / "dryrun" / f"{arch}_{shape}_single.json"
    if out.returncode or not path.is_file():
        raise AssertionError(f"the dry-run of {arch} × {shape} ended {out.returncode}: "
                             f"{out.stdout[-2000:]} {out.stderr[-2000:]}")
    res = json.loads(path.read_text())
    if res["status"] != "ok":
        raise AssertionError(f"the dry-run of {arch} × {shape}: {res}")
    return {"arch": arch, "shape": shape, "status": res["status"], "seconds": seconds,
            "trace_s": res["compile_s"], "n_devices": res["n_devices"],
            "terms_s": {k: res["roofline"][k] for k in ("t_compute", "t_memory",
                                                          "t_collective")},
            "dominant": res["dominant"], "collective_counts": {
                k: v for k, v in res["collectives"].items() if k.startswith("count_") and v}}


# the families run on the card's mesh in phase 18: published widths, the
# depth cut for the card's memory and the script's time, batch and sequence
MESH_FAMILIES = (
    ("phi3.5-moe-42b-a6.6b", dict(family="moe", d_model=4096, n_heads=32, n_kv_heads=8,
                                  head_dim=128, vocab=32064, n_experts=16, top_k=2,
                                  d_ff_expert=6400, capacity_factor=1.25), 2, 4, 512),
    ("deepseek-v2-236b", dict(family="mla_moe", d_model=5120, n_heads=128, vocab=102400,
                              q_lora=1536, kv_lora=512, nope_head_dim=128, rope_head_dim=64,
                              v_head_dim=128, n_experts=160, top_k=6, n_shared_experts=2,
                              d_ff_expert=1536, capacity_factor=1.25), 2, 4, 512),
    ("qwen2-vl-72b", dict(family="vlm", d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
                          d_ff=29568, vocab=152064, n_patches=1024), 4, 2, 1280),
    ("xlstm-1.3b", dict(family="xlstm", d_model=2048, n_heads=4, vocab=50304, slstm_every=8,
                        ssm_expand=2), 4, 4, 512),
)


def _family_on_mesh(arch, widths, layers, B, S, mesh, counters):
    """One loss forward and backward of ``arch`` at full width, ``layers``
    deep, bf16, batch B × S (qwen2-vl: 256 text tokens around 1024 patch
    embeddings), without the mesh and then on it, no optimizer step: the
    loss and every leaf's gradient on the mesh within 1e-3 relative (L2
    per leaf) of the meshless ones; K2's sm90 launches and backward calls
    as the attention layers and the config's remat predict, both ways; for
    the MoE families the token-slots dropped by every routing (forward and
    recompute), equal both ways → the phase's record."""
    import torch

    from repro_torch.distributed.sharding import Resolver, activate, distribute_model
    from repro_torch.models import Model, moe

    cfg, full = _full_width(arch, widths, layers)
    model = Model(cfg, device="cuda", seed=0).requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(3)
    if cfg.family == "vlm":
        batch = _vlm_batch(cfg, B)
        if batch["tokens"].shape[1] != S:
            raise AssertionError(f"qwen2-vl's batch has {batch['tokens'].shape[1]} positions")
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")}
    batch["targets"] = torch.roll(batch["tokens"], -1, dims=1)
    drops, route = [], moe.route

    def spy(*args, **kw):
        r = route(*args, **kw)
        drops[-1].append(int((~_full(r.kept)).sum()))
        return r

    attn = 0 if cfg.family == "xlstm" else cfg.n_layers
    remat = cfg.remat and cfg.remat_policy != "none"
    want = {"k2_launches_sm90": attn * (2 if remat else 1), "k2_launches_scalar": 0,
            "k2_backward_calls": attn, "k3_launches": 0, "k1": 0}
    runs, kept = [], {}
    moe.route = spy
    try:
        for on_mesh in (False, True):
            drops.append([])
            if on_mesh:
                resolver = Resolver(cfg, mesh)
                distribute_model(model, resolver)
                run_batch = _mesh_batch(batch, resolver)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero(counters)
            t0 = time.perf_counter()
            if on_mesh:
                with activate(resolver):
                    loss = model.loss(run_batch)[0]
                    loss.backward()
            else:
                loss = model.loss(batch)[0]
                loss.backward()
            torch.cuda.synchronize()
            row = {"mesh": on_mesh, "loss": float(_full(loss)),
                   "ms": (time.perf_counter() - t0) * 1e3,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "launches": {k: v for k, v in _read(counters).items() if v},
                   "dropped": drops[-1]}
            got = {k: _read(counters)[k] for k in want}
            if got != want:
                raise AssertionError(f"{arch} {'on' if on_mesh else 'without'} the mesh "
                                     f"launched {got}, want {want}")
            if not on_mesh:
                kept = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
            else:
                errs = {}
                for k, p in model.named_parameters():
                    w = kept.pop(k).cuda().float()
                    d = (_full(p.grad).float() - w).norm().item()
                    errs[k] = d / w.norm().item() if w.norm().item() else float(d > 0)
                worst = max(errs, key=errs.get)
                row.update(grad_max_leaf_rel_l2=errs[worst], grad_worst_leaf=worst,
                           grad_leaves_bit_equal=sum(e == 0 for e in errs.values()),
                           grad_leaves=len(errs))
            runs.append(row)
            del loss
    finally:
        moe.route = route
    plain, meshed = runs
    meshed["loss_rel_diff"] = abs(meshed["loss"] - plain["loss"]) / abs(plain["loss"])
    if not (meshed["loss_rel_diff"] <= 1e-3 and meshed["grad_max_leaf_rel_l2"] <= 1e-3):
        raise AssertionError(f"{arch} on the mesh: loss {meshed['loss']} against "
                             f"{plain['loss']}, worst leaf {meshed['grad_worst_leaf']} at "
                             f"{meshed['grad_max_leaf_rel_l2']} relative L2, over 1e-3")
    if plain["dropped"] != meshed["dropped"] or (cfg.n_experts and not plain["dropped"]):
        raise AssertionError(f"{arch}: token-slots dropped {meshed['dropped']} on the mesh, "
                             f"{plain['dropped']} without it")
    del model
    _drop_models()
    return {"arch": arch, "depth": [cfg.n_layers, full], "batch": B, "seq": S,
            "want_launches": want, "meshless": plain, "mesh": meshed}


def phase_distributed(tmp):
    """The sharded path on the card's host mesh (n,) ("data",): a one-rank
    NCCL group on a FileStore; llama3.2-3b at full width and depth, 2 train
    steps with its parameters, gradients and moments DTensors, K2's sm90
    kernel through local_map in every layer, loss and every leaf's gradient
    against the same steps without the mesh; zamba2-1.2b at full size, one
    bf16 loss on the mesh (K3's and K2's sm90 kernels through local_map)
    against the meshless loss, one fp32 loss on the scalar routes against
    the meshless one and the plain versions', and one bf16 loss with the
    bf16 decay (K3-sm90's bf16-decay form) against the plain versions';
    the four families of ``MESH_FAMILIES``, a forward and backward each
    (``_family_on_mesh``); one dry-run cell in a process of its own.  The group is destroyed and the card's memory freed
    before it returns."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Resolver, activate, distribute_model
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_scan_torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model, layers, ssm
    from repro_torch.training.data import SyntheticData

    t0 = time.perf_counter()
    _drop_models()
    if not dist.is_nccl_available():
        raise AssertionError("this torch has no NCCL: the mesh path needs it")
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp / "store"), 1),
                            rank=0, world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = make_host_mesh()
        counters = _all_counters()

        # llama3.2-3b: 2 train steps without the mesh, then on it
        cfg = get_config("llama3.2-3b")
        data = SyntheticData(cfg.vocab, 256, 8, kind="copy_task", seed=0)
        plain_rows, want = _compared_steps(cfg, data, 2)
        resolver = Resolver(cfg, mesh)
        _zero(counters)
        mesh_rows, _ = _compared_steps(cfg, data, 2, resolver, want)
        train_launches = _read(counters)
        del want
        remat = cfg.remat and cfg.remat_policy != "none"
        per_step = cfg.n_layers * (2 if remat else 1)     # forward (+ its recompute)
        want_k2 = {"k2_launches_sm90": 2 * per_step, "k2_backward_calls": 2 * cfg.n_layers,
                   "k2_launches_scalar": 0, "k3_launches": 0, "k1": 0}
        got = {k: train_launches[k] for k in want_k2}
        if got != want_k2:
            raise AssertionError(f"launches in 2 train steps on the mesh: {got}, want "
                                 f"{want_k2} (28 layers, remat {cfg.remat_policy})")
        for p, m in zip(plain_rows, mesh_rows):
            rel = abs(m["loss"] - p["loss"]) / abs(p["loss"])
            m["loss_rel_diff"] = rel
            if not (rel <= 1e-3 and m["grad_max_leaf_rel_l2"] <= 1e-3):
                raise AssertionError(f"llama3.2-3b on the mesh: step {m['step']} loss "
                                     f"{m['loss']} against {p['loss']}, worst leaf "
                                     f"{m['grad_worst_leaf']} at {m['grad_max_leaf_rel_l2']}"
                                     f" relative L2, over 1e-3")

        # zamba2-1.2b: one bf16 loss and one fp32 loss, without the mesh,
        # with the plain versions, and on the mesh
        zcfg = get_config("zamba2-1.2b")
        model = Model(zcfg, device="cuda", seed=0)
        rng = np.random.default_rng(0)
        tokens = torch.from_numpy(rng.integers(0, zcfg.vocab, (4, 512))).long().cuda()
        zbatch = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}
        sites = len(zcfg.shared_sites())
        fp32_cfg = dataclasses.replace(zcfg, dtype=torch.float32)

        decay_cfg = dataclasses.replace(zcfg, ssd_decay_dtype=torch.bfloat16)

        def loss_of(batch, fp32=False, on_mesh=False, decay=False):
            model.cfg = fp32_cfg if fp32 else decay_cfg if decay else zcfg
            try:
                with torch.no_grad():
                    if on_mesh:
                        with activate(resolver_z):
                            return float(_full(model.loss(batch)[0]))
                    return float(model.loss(batch)[0])
            finally:
                model.cfg = zcfg

        plain_bf16 = loss_of(zbatch)
        plain_fp32 = loss_of(zbatch, fp32=True)
        real_ssd, real_fa = ssm.ssd, layers.flash_attention
        ssm.ssd = ssd_scan_torch
        layers.flash_attention = fa_ops.flash_attention_plain
        _zero(counters)
        try:
            reference_fp32 = loss_of(zbatch, fp32=True)
            ssm.ssd = ssd_ops.ssd_plain            # each route's plain version
            reference_bf16 = loss_of(zbatch)
            reference_decay = loss_of(zbatch, decay=True)
        finally:
            ssm.ssd, layers.flash_attention = real_ssd, real_fa
        if any(_read(counters).values()):
            raise AssertionError(f"the plain versions' loss launched kernels: "
                                 f"{_read(counters)}")
        resolver_z = Resolver(zcfg, mesh)
        distribute_model(model, resolver_z)
        mbatch = _mesh_batch(zbatch, resolver_z)
        _zero(counters)
        mesh_bf16 = loss_of(mbatch, on_mesh=True)
        bf16_launches = _read(counters)
        _zero(counters)
        mesh_fp32 = loss_of(mbatch, fp32=True, on_mesh=True)
        fp32_launches = _read(counters)
        # the bf16-decay loss on the mesh, K3 held against its plain version
        # on each Mamba2 layer's own inputs (``bf16_decay_tol``)
        layer_excess = []

        def checked(x, dt, Bm, Cm, a, chunk, decay_dtype):
            got = real_ssd(x, dt, Bm, Cm, a, chunk, decay_dtype)
            args = [_full(t) for t in (x, dt, Bm, Cm, a)]
            want = ssd_ops.ssd_plain(*args, chunk, decay_dtype)
            tol = bf16_decay_tol(*args, chunk)
            layer_excess.append(max(ssd_excess(_full(got[0]), want[0], tol)[1],
                                    ssd_excess(_full(got[1]), want[1])[1]))
            return got

        ssm.ssd = checked
        _zero(counters)
        try:
            mesh_decay = loss_of(mbatch, on_mesh=True, decay=True)
        finally:
            ssm.ssd = real_ssd
        decay_launches = _read(counters)
        if len(layer_excess) != zcfg.n_layers or max(layer_excess) > 0:
            raise AssertionError(f"K3's bf16-decay form differs from its plain version "
                                 f"inside zamba2-1.2b: excess per layer {layer_excess}")
        want_bf16 = {"k3_launches_sm90": zcfg.n_layers, "k3_launches_scalar": 0,
                     "k2_launches_sm90": sites, "k2_launches_scalar": 0}
        want_fp32 = {"k3_launches_sm90": 0, "k3_launches_scalar": zcfg.n_layers,
                     "k2_launches_sm90": 0, "k2_launches_scalar": sites}
        for got, wanted, what in ((bf16_launches, want_bf16, "bf16"),
                                  (fp32_launches, want_fp32, "fp32"),
                                  (decay_launches, want_bf16, "bf16-decay")):
            if {k: got[k] for k in wanted} != wanted:
                raise AssertionError(f"zamba2-1.2b's {what} loss on the mesh launched "
                                     f"{got}, want {wanted}")
        gaps = {"bf16_mesh_vs_meshless": abs(mesh_bf16 - plain_bf16) / abs(plain_bf16),
                "fp32_mesh_vs_meshless": abs(mesh_fp32 - plain_fp32) / abs(plain_fp32),
                "fp32_mesh_vs_plain_versions": abs(mesh_fp32 - reference_fp32)
                / abs(reference_fp32),
                "bf16_decay_mesh_vs_plain_versions": abs(mesh_decay - reference_decay)
                / abs(reference_decay),
                "bf16_meshless_vs_plain_versions": abs(plain_bf16 - reference_bf16)
                / abs(reference_bf16),
                "bf16_decay_vs_fp32_decay": abs(mesh_decay - mesh_bf16) / abs(mesh_bf16)}
        # the fp32 loss with the kernels against the plain versions': the
        # rounding of 38 layers averaged over 2048 tokens, far under 1e-3.
        # In bf16 each kernel's output differs from its plain version's by a
        # rounding flip in some elements (phase k3, and the per-layer check
        # above), which 38 layers of bf16 activations carry into the loss.
        # A bf16 decay makes each layer a step function of its inputs (L's
        # bf16 steps are 0.5 wide at |L| >= 64, so exp(L_i - L_j) jumps by
        # up to e**0.5), which carries them farther: two plain forms that
        # differ only in their fp32 summation order give losses 5.4e-4
        # apart at 8 of 38 layers with a bf16 decay, 1.7e-4 with fp32
        # (scripts/ssd_decay_sensitivity.py).  The bf16-decay loss is held
        # within 5e-3 of the plain versions', the fp32-decay bf16 loss's own
        # gap recorded beside it
        if not (gaps["bf16_mesh_vs_meshless"] <= 1e-3 and gaps["fp32_mesh_vs_meshless"] <= 1e-3
                and gaps["fp32_mesh_vs_plain_versions"] <= 1e-3
                and gaps["bf16_decay_mesh_vs_plain_versions"] <= 5e-3):
            raise AssertionError(f"zamba2-1.2b's losses on the mesh: bf16 {mesh_bf16} against "
                                 f"{plain_bf16}; fp32 {mesh_fp32} against {plain_fp32} and "
                                 f"the plain versions' {reference_fp32}; bf16 decay "
                                 f"{mesh_decay} against the plain versions' "
                                 f"{reference_decay}: {gaps} over 1e-3 (5e-3)")
        del model
        _drop_models()

        families = [_family_on_mesh(*spec, mesh, counters) for spec in MESH_FAMILIES]

        dry = _dryrun_cell("llama3.2-3b", "decode_32k")
    finally:
        dist.destroy_process_group()
        _drop_models()
    emit(phase="distributed", mesh={"shape": [1], "axes": ["data"], "backend": "nccl"},
         llama={"arch": cfg.arch, "batch": 8, "seq": 256, "remat": cfg.remat_policy,
                "k2_launches_per_step": per_step, "launches": train_launches,
                "meshless": plain_rows, "mesh": mesh_rows},
         zamba={"arch": zcfg.arch, "batch": 4, "seq": 512, "loss_bf16": [plain_bf16, mesh_bf16],
                "loss_fp32": [plain_fp32, mesh_fp32, reference_fp32],
                "loss_bf16_decay": [reference_decay, mesh_decay],
                "loss_bf16_plain_versions": reference_bf16,
                "bf16_decay_layer_max_excess": max(layer_excess), "rel_gaps": gaps,
                "launches_bf16": bf16_launches, "launches_fp32": fp32_launches,
                "launches_bf16_decay": decay_launches},
         families=families, dryrun=dry, seconds=time.perf_counter() - t0)
    return {"k2_sm90": train_launches["k2_launches_sm90"] + bf16_launches["k2_launches_sm90"]
            + decay_launches["k2_launches_sm90"]
            + sum(f["mesh"]["launches"].get("k2_launches_sm90", 0) for f in families),
            "k2_scalar": fp32_launches["k2_launches_scalar"],
            "k3_sm90": bf16_launches["k3_launches_sm90"],
            "k3_sm90_bf16_decay": decay_launches["k3_launches_sm90"],
            "k3_scalar": fp32_launches["k3_launches_scalar"]}


# ------------------------------------------------------ child processes ----
def adopt_orphans() -> None:
    """Make this process the reaper of its descendants (Linux): a shard whose
    forkserver has ended is handed to this script, not to init, so that
    ``stop_children`` still finds it."""
    import ctypes

    try:
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)  # PR_SET_CHILD_SUBREAPER
    except (OSError, AttributeError):
        pass


def _descendants() -> set:
    parent = {}
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    parent[int(entry)] = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, IndexError, ValueError):
                pass
    found, todo = set(), [os.getpid()]
    while todo:
        pid = todo.pop()
        kids = [c for c, p in parent.items() if p == pid and c not in found]
        found.update(kids)
        todo.extend(kids)
    return found


def _reap() -> None:
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if not pid:
            return


def stop_children(timeout: float = 30.0) -> set:
    """Stop every process the phases started and wait until each has ended:
    shard processes a failed phase left behind, then multiprocessing's
    forkserver and resource tracker, which would otherwise outlive the script
    by the time they take to notice that it has ended.  Returns the pids that
    are still there after ``timeout``."""
    import gc
    import multiprocessing as mp
    from multiprocessing import forkserver, resource_tracker

    gc.collect()  # the shard counters' semaphores unregister now, not at exit
    for proc in mp.active_children():
        proc.kill()
        proc.join(10)
    server, tracker = forkserver._forkserver, resource_tracker._resource_tracker
    helpers = {getattr(server, "_forkserver_pid", None), getattr(tracker, "_pid", None)}
    for pid in _descendants() - helpers:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    deadline = time.monotonic() + timeout / 2
    while _descendants() - helpers and time.monotonic() < deadline:
        _reap()
        time.sleep(0.05)
    # both end once the last write end of their pipe closes; _stop closes
    # this process's end and waits for the pid
    server._stop()
    if hasattr(tracker, "_stop"):
        tracker._stop()
    deadline = time.monotonic() + timeout / 2
    while True:
        _reap()
        left = _descendants()
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    return left


# ------------------------------------------------ process shards (8-10) ----
class ShardJoinCounts:
    """``child_init`` for the port's process shards, handed to each shard
    process (pickled under ``spawn`` and ``forkserver``).  Each shard takes
    a slot of shared memory in ``child_init`` and from then on writes only
    its own slot, with no lock: a SIGKILL (phase 10) can leave no lock held
    that the other shards wait on.  The only lock, the one that hands out
    slots, is taken before a shard reports ready, and a shard is killed
    only after ``start_shards`` has returned.  Summed over the pool's
    shards (``read``): the join planes built (``planes``) and those whose
    backend is not ``want`` (``wrong_backend``); the vector plane's join
    calls, one per triage call (``triage_calls``), and the K1 launches they
    made by the wrapper's own count, ``ops.launches`` (``k1_launches``);
    the seconds spent in join calls (``join_s``) and in each shard's first
    one, where a card shard makes its CUDA context (``first_join_s``).
    ``first_call()`` and ``first_fire()`` are the wall clock of the first
    join call and of the first fire since ``reset``; the fire clock is the
    action ``stamp_first_fire``.  ``soak`` also registers the chaos soak's
    actions (its own ``child_init``)."""

    SLOTS = 64
    INTS = ("planes", "wrong_backend", "triage_calls", "k1_launches")
    SECS = ("join_s", "first_join_s", "first_call", "first_fire")

    def __init__(self, soak: bool = False):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.want, self.soak = "", soak
        self.next_slot = ctx.Value("i", 0)
        self.ints = ctx.RawArray("q", self.SLOTS * len(self.INTS))
        self.secs = ctx.RawArray("d", self.SLOTS * len(self.SECS))

    def reset(self) -> None:
        self.next_slot.value = 0
        self.ints[:] = [0] * len(self.ints)
        self.secs[:] = [0.0] * len(self.secs)

    def _column(self, array, fields, name) -> list:
        k = fields.index(name)
        return [array[slot * len(fields) + k] for slot in range(self.SLOTS)]

    def read(self) -> dict:
        out = {name: sum(self._column(self.ints, self.INTS, name)) for name in self.INTS}
        for name in ("join_s", "first_join_s"):
            out[name] = sum(self._column(self.secs, self.SECS, name))
        return out

    def first_call(self) -> float:
        return min((t for t in self._column(self.secs, self.SECS, "first_call") if t),
                   default=0.0)

    def first_fire(self) -> float:
        return min((t for t in self._column(self.secs, self.SECS, "first_fire") if t),
                   default=0.0)

    def __call__(self, backend) -> None:
        from repro_torch.core.actions import register_action
        from repro_torch.kernels.event_join import dispatch, ops

        if self.soak:
            from repro_torch.chaos.soak import register_soak_functions
            register_soak_functions()
        with self.next_slot.get_lock():
            slot = self.next_slot.value
            self.next_slot.value += 1
        if slot >= self.SLOTS:
            raise RuntimeError(f"more than {self.SLOTS} shard processes since reset")
        ints, secs = self.ints, self.secs
        i0, s0 = slot * len(self.INTS), slot * len(self.SECS)
        resolve, join = dispatch.resolve_join_backend, dispatch.join_counts_segments

        def resolved(name):
            out = resolve(name)
            ints[i0] += 1
            ints[i0 + 1] += out[0] != self.want
            return out

        def counted(lens, counts, expected, fn):
            before, t0 = ops.launches, time.perf_counter()
            out = join(lens, counts, expected, fn)
            seconds = time.perf_counter() - t0
            if not ints[i0 + 2]:
                secs[s0 + 1] = seconds
                secs[s0 + 2] = time.time()
            ints[i0 + 2] += 1
            ints[i0 + 3] += ops.launches - before
            secs[s0] += seconds
            return out

        def stamp_first_fire(ctx, event, params):
            if not secs[s0 + 3]:
                secs[s0 + 3] = time.time()

        # the worker is built after child_init: its join plane takes these
        dispatch.resolve_join_backend = resolved
        dispatch.join_counts_segments = counted
        register_action("stamp_first_fire", stamp_first_fire)


def _want_backend(pool) -> str:
    return str(pool.device) if pool.device.type == "cuda" else "torch"


def _join_triggers(n_triggers, events_each):
    from repro_torch.core import make_trigger

    return [make_trigger(f"j{t}", condition={"name": "counter", "expected": events_each,
                                             "aggregate": False},
                         action={"name": "noop"}, trigger_id=f"jt{t}", transient=False)
            for t in range(n_triggers)]


def _shard_join(device, root, counts, n_triggers=100, events_each=2000):
    """The Table-1 join through 4 shard processes of a ProcessShardPool over
    8 partitions of a FilePartitionedEventStore (the pool's defaults:
    batches of 512, fsync, every_batch)."""
    from repro_torch.bus import ProcessShardPool
    from repro_torch.core import termination_event

    n = n_triggers * events_each
    pool = ProcessShardPool(str(root), num_partitions=8, device=device, child_init=counts)
    try:
        counts.want = _want_backend(pool)
        pool.create_workflow("join")
        for trg in _join_triggers(n_triggers, events_each):
            pool.add_trigger("join", trg)
        pool.publish_batch("join", [termination_event(f"j{i % n_triggers}", i)
                                    for i in range(n)])
        counts.reset()
        t0 = time.perf_counter()
        pool.start_shards("join", 4)
        t1 = time.perf_counter()
        pool.wait_drained("join", timeout=300)
        t2 = time.perf_counter()
        out = {"device": str(pool.device), "start_method": pool.start_method,
               "start_s": t1 - t0, "drain_s": t2 - t1, "events_per_s": n / (t2 - t1),
               "fires": pool.total_fires("join"),
               "contexts": {f"jt{t}": pool.trigger_context("join", f"jt{t}")
                            for t in range(n_triggers)},
               "committed": len(pool.event_store.committed_events("join"))}
    finally:
        pool.stop_all()
    return dict(out, **counts.read())


def phase_shards(tmp):
    """The Table-1 join through process shards on the card and on the CPU
    in turns, twice (card, CPU, CPU, card): 100 fires and the same contexts
    on each, K1 launched in the card's shards once per triage call on the
    pool's card; K1's counts set to 0 just before each run and read just
    after.  The first card run starts the forkserver."""
    counts = ShardJoinCounts()
    runs = [_shard_join(device, tmp / f"shards{i}", counts)
            for i, device in enumerate(("cuda", "cpu", "cpu", "cuda") * 2)]
    ref = runs[1]["contexts"]
    for r in runs:
        card = r["device"].startswith("cuda")
        if r["fires"] != 100 or r["committed"] != 200_000:
            raise AssertionError(f"shard join on {r['device']}: {r['fires']} fires, "
                                 f"{r['committed']} committed")
        if r["contexts"] != ref:
            raise AssertionError(f"a trigger's context on {r['device']} differs from "
                                 f"the CPU run")
        if r["planes"] != 4 or r["wrong_backend"] or not r["triage_calls"]:
            raise AssertionError(f"the shards on {r['device']} did not all run their "
                                 f"own backend: {r}")
        if r["k1_launches"] != (r["triage_calls"] if card else 0):
            raise AssertionError(f"{r['k1_launches']} K1 launches for "
                                 f"{r['triage_calls']} triage calls on {r['device']}")
    keys = ("start_s", "drain_s", "events_per_s", "join_s", "first_join_s",
            "triage_calls", "k1_launches")
    emit(phase="shards", triggers=100, events=200_000, partitions=8, shards=4,
         fires=runs[0]["fires"], backend=runs[0]["device"],
         start_method={r["device"]: r["start_method"] for r in runs},
         **{f"{k}_{dev}": [r[k] for r in runs if r["device"].startswith(dev)]
            for k in keys for dev in ("cuda", "cpu")})
    return [r["k1_launches"] for r in runs if r["device"].startswith("cuda")]


def _wait(cond, timeout, what, state=None):
    """Poll ``cond`` until it holds; past ``timeout`` raise, with ``state()``
    where given."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout} s: {what}"
                                 + (f" ({state()})" if state else ""))
        time.sleep(0.01)


def _scale(device, root, counts, subjects=8, burst=1600, grace=5.0):
    """tests/test_autoscale.py's Fig. 8 lifecycle on a ProcessShardPool under
    KedaAutoscaler: burst, scale up, drain to zero shard processes, a second
    burst, scale from zero.  Each trigger is a join of its subject's share of
    a burst (reset on fire), whose fire stamps the clock.

    The grace period is 5 s, not the test's 0.4 s: a shard's idle clock runs
    from its start until its first assignment, which comes once every shard
    of the scale-up is ready, and on the card a shard may be ready seconds
    after its sibling (a spawned one imports torch first), so at 0.4 s the
    first one ready can leave before the rebalance."""
    from repro_torch.bus import ProcessShardPool
    from repro_torch.core import KedaAutoscaler, Triggerflow, make_trigger, termination_event

    pool = ProcessShardPool(str(root), num_partitions=4, batch_size=128, fsync=False,
                            device=device, child_init=counts)
    counts.want = _want_backend(pool)
    pool.create_workflow("w")
    for i in range(subjects):
        pool.add_trigger("w", make_trigger(
            f"s{i}", condition={"name": "counter", "expected": burst // subjects,
                                "aggregate": False, "reset_on_fire": True},
            action={"name": "stamp_first_fire"}, trigger_id=f"t{i}", transient=False))
    tf = Triggerflow(pool=pool, device=device)
    scaler = KedaAutoscaler(tf, poll_interval=0.05, grace_period=grace,
                            events_per_shard=400, max_shards_per_workflow=2)

    def publish(base):
        pool.publish_batch("w", [termination_event(f"s{i % subjects}", base + i)
                                 for i in range(burst)])

    def state():
        return (f"scale_ups {scaler.scale_ups}, scale_downs {scaler.scale_downs}, "
                f"restarts {scaler.restarts}, lag {pool.lag('w')}, timeline "
                f"{[(round(t, 2), n, lag) for t, n, lag in scaler.timeline if n or lag][:40]}")

    # the first burst lands before the autoscaler's first tick, which then
    # sees all of it (a tick in the middle of the publish would see one
    # partition's share and start one shard, which drains the rest)
    publish(0)
    scaler.start()
    try:
        _wait(lambda: pool.lag("w") == 0, 120, "the first burst did not drain", state)
        _wait(lambda: scaler.scale_ups >= 2, 30, "no scale-up to 2 shards", state)
        ups = scaler.scale_ups
        _wait(lambda: scaler.active_workers == 0, 60, "no scale to zero", state)
        counts.reset()
        t_pub = time.time()
        publish(burst)
        _wait(counts.first_fire, 120, "no fire after the second burst",
              state)
        cold_fire_s = counts.first_fire() - t_pub
        cold_join_s = counts.first_call() - t_pub if counts.first_call() else None
        _wait(lambda: pool.lag("w") == 0, 120, "the second burst did not drain", state)
        _wait(lambda: scaler.scale_ups > ups, 30, "no scale from zero", state)
        _wait(lambda: scaler.active_workers == 0, 60, "no scale to zero after burst 2",
              state)
        _wait(lambda: not pool.shard_ids("w"), 30, "reaped shards not dropped", state)
        ids = [e.id for e in pool.event_store.committed_events("w")]
        out = {"device": str(pool.device), "second_publish_to_first_fire_s": cold_fire_s,
               "second_publish_to_first_join_s": cold_join_s,
               "scale_ups": scaler.scale_ups, "scale_downs": scaler.scale_downs,
               "restarts": scaler.restarts,
               "peak_shards": max(w for _, w, _ in scaler.timeline),
               "fires": pool.total_fires("w"), "committed": len(ids),
               "unique": len(set(ids)), **counts.read()}
    finally:
        scaler.stop()
        tf.shutdown()
        pool.stop_all()
    return out


def phase_scale(tmp):
    """Scale-from-zero on the card and on the CPU, in turns (card, CPU, CPU,
    card): the time from the second burst's publish to its first fire is the
    cold start a shard process adds, its CUDA context included on the card
    (its first K1 call creates it)."""
    counts = ShardJoinCounts()
    runs = [_scale(device, tmp / f"scale{i}", counts)
            for i, device in enumerate(("cuda", "cpu", "cpu", "cuda"))]
    for r in runs:
        if r["committed"] != r["unique"] or r["committed"] != 3200 or r["fires"] != 16 \
                or r["restarts"] or r["wrong_backend"]:
            raise AssertionError(f"scale run on {r['device']}: {r}")
    emit(phase="scale", bursts=[1600, 1600], **{
        f"{k}_{dev}": [r[k] for r in runs if r["device"].startswith(dev)]
        for k in ("second_publish_to_first_fire_s", "second_publish_to_first_join_s",
                  "peak_shards", "scale_ups",
                  "scale_downs", "triage_calls", "k1_launches")
        for dev in ("cuda", "cpu")})


def _chaos_join(device, root, counts, seed=3, n_triggers=100, events_each=400,
                kills=2):
    """The Table-1 join's shape on 2 shard processes with seeded SIGKILLs and
    a torn segment tail after the first kill.  A plain counter is
    at-least-once: no event may be lost or committed twice, and each count
    reaches its events (a batch redelivered after a kill between its
    checkpoint and its commit counts again)."""
    from repro_torch.bus import ProcessShardPool
    from repro_torch.chaos import tear_segment_tail
    from repro_torch.chaos.soak import _u
    from repro_torch.core import termination_event

    n = n_triggers * events_each
    pool = ProcessShardPool(
        str(root), num_partitions=8, device=device, child_init=counts,
        breaker={"backoff_base": 0.02, "backoff_max": 0.1, "cooldown": 0.05})
    try:
        counts.want = _want_backend(pool)
        pool.create_workflow("join")
        for trg in _join_triggers(n_triggers, events_each):
            pool.add_trigger("join", trg)
        pool.publish_batch("join", [termination_event(f"j{i % n_triggers}", i)
                                    for i in range(n)])
        counts.reset()
        pool.start_shards("join", 2)
        for k in range(kills):
            u = _u(seed, "kill", k)
            target = int(n * (0.15 + 0.6 * u) * (k + 1) / kills)
            _wait(lambda: sum(pool.event_store.commit_offsets("join")) >= target
                  or not pool.lag("join"), 120, f"kill point {k}")
            members = pool.shard_ids("join")
            if members:
                pool.crash_shard("join", members[int(u * len(members)) % len(members)])
            if k == 0:
                tear_segment_tail(pool.bus_root, suffix=".log")
            pool.start_shards("join", 2)
        pool.wait_drained("join", timeout=300)
        ids = [e.id for e in pool.event_store.committed_events("join")]
        cnt = [pool.trigger_context("join", f"jt{t}").get("count", 0)
               for t in range(n_triggers)]
        out = {"events": n, "committed": len(ids), "unique": len(set(ids)),
               "lag": pool.lag("join"), "min_count": min(cnt), "max_count": max(cnt),
               "crashes": pool.metrics("join")["crashes"]}
    finally:
        pool.stop_all()
    return dict(out, **counts.read())


def phase_chaos(tmp):
    """run_soak_proc on the card (seeded SIGKILLs, a torn tail; its
    invariants are asserted inside), then the Table-1 join's shape under the
    same chaos on the card, where K1 runs in every shard."""
    import torch

    from repro_torch.chaos import soak

    dev = f"cuda:{torch.cuda.current_device()}"
    # the soak hands its shards the child_init it finds under this name
    counts, soak_init = ShardJoinCounts(soak=True), soak.soak_child_init
    counts.want = dev
    soak.soak_child_init = counts
    try:
        counts.reset()
        s = soak.run_soak_proc(str(tmp / "soak"), seed=3, device=dev)
        soak_counts = counts.read()
    finally:
        soak.soak_child_init = soak_init
    if s["crashes"] < 1 or s["lag"] or not soak_counts["planes"] \
            or soak_counts["wrong_backend"]:
        raise AssertionError(f"the soak on the card: {s['crashes']} crashes, lag "
                             f"{s['lag']}, {soak_counts}")
    counts = ShardJoinCounts()
    j = _chaos_join(dev, tmp / "chaos_join", counts)
    if j["lag"] or j["committed"] != j["events"] or j["unique"] != j["events"] \
            or j["min_count"] < 400 or j["crashes"] < 1 or j["wrong_backend"]:
        raise AssertionError(f"the join under SIGKILLs on the card: {j}")
    if not j["k1_launches"] or j["k1_launches"] != j["triage_calls"]:
        raise AssertionError(f"{j['k1_launches']} K1 launches for {j['triage_calls']} "
                             f"triage calls in the join under SIGKILLs")
    emit(phase="chaos", soak={"crashes": s["crashes"], "done_subjects": len(s["done"]),
                              "dlq_by_reason": s["dlq_by_reason"], **soak_counts},
         soak_note="the soak's triggers are `true` conditions, which the vector "
                   "join plane never claims: no K1 call in its shards",
         join=j)
    return j["k1_launches"]


def _orchestrators(device):
    """One run of each orchestrator on Triggerflow(device=...), the
    in-process facade; the outcomes only."""
    from repro_torch.core import Triggerflow
    from repro_torch.core.dag import DAG, MapOperator, PythonOperator
    from repro_torch.core.fedlearn import FederatedLearningOrchestrator, ObjectStore
    from repro_torch.core.statemachine import StateMachine
    from repro_torch.core.workflow_as_code import WorkflowAsCode

    def outcome(res):
        return {k: res.get(k) for k in ("status", "result", "error")}

    out = {}
    tf = Triggerflow(inline_functions=True, device=device)
    dag = DAG("diamond")
    a = dag.add(PythonOperator("a", lambda x: 1))
    b = dag.add(PythonOperator("b", lambda x: x + 10))
    c = dag.add(PythonOperator("c", lambda x: x + 100))
    d = dag.add(PythonOperator("d", lambda xs: sorted(xs)))
    a >> [b, c]
    b >> d
    c >> d
    dag.deploy(tf, "diamond")
    out["dag_diamond"] = outcome(dag.run(tf, "diamond", timeout=30))
    dag = DAG("mj")
    g = dag.add(PythonOperator("g", lambda x: list(range(7))))
    m = dag.add(MapOperator("m", lambda x: x + 1))
    r = dag.add(PythonOperator("r", sum))
    g >> m >> r
    dag.deploy(tf, "mj")
    out["dag_map_join"] = outcome(dag.run(tf, "mj", timeout=30))
    tf.backend.register("inc", lambda x: (x or 0) + 1)
    tf.backend.register("dbl", lambda x: (x or 0) * 2)
    tf.backend.register("flatten", lambda xs: [v for sub in xs for v in sub])
    sm = StateMachine({
        "StartAt": "Init",
        "States": {
            "Init": {"Type": "Pass", "Result": 0, "Next": "Inc"},
            "Inc": {"Type": "Task", "Resource": "inc", "Next": "Gate"},
            "Gate": {"Type": "Choice",
                     "Choices": [{"Variable": "$.result", "Op": "lt", "Value": 4,
                                  "Next": "Inc"}],
                     "Default": "Par"},
            "Par": {"Type": "Parallel", "Next": "Flat", "Branches": [
                {"StartAt": "X", "States": {"X": {"Type": "Pass", "Result": [1, 2],
                                                  "End": True}}},
                {"StartAt": "Y", "States": {"Y": {"Type": "Pass", "Result": [3],
                                                  "End": True}}}]},
            "Flat": {"Type": "Task", "Resource": "flatten", "Next": "Map"},
            "Map": {"Type": "Map", "Next": "Done", "Iterator": {
                "StartAt": "D", "States": {"D": {"Type": "Task", "Resource": "dbl",
                                                 "End": True}}}},
            "Done": {"Type": "Succeed"},
        }})
    sm.deploy(tf, "asl")
    res = outcome(sm.run(tf, "asl", timeout=30))
    out["asl_choice_parallel_map"] = dict(res, result=sorted(res["result"] or []))
    tf.backend.register("add", lambda x: x + 1)
    tf.backend.register("sq", lambda x: x * x)

    def orch(ex):
        a = ex.call_async("add", 1).result()
        return sum(ex.map("sq", [a, a + 1]).result())

    wac = WorkflowAsCode(tf, "wac", orch)
    wac.deploy()
    out["wac_suspend_replay"] = dict(outcome(wac.run(timeout=30)), replays=wac.replays)
    tf.shutdown()

    tf = Triggerflow(device=device)  # threaded: clients run concurrently
    store = ObjectStore()

    def client(args):
        if args["round"] == 1 and args["client"] < 3:
            raise RuntimeError("down")
        k = store.put(f"d/{args['round']}/{args['client']}", store.get(args["model"]) + 1.0)
        return {"round": args["round"], "result": k}

    def agg(keys, st):
        return sum(st.get(k) for k in keys) / len(keys)

    fl = FederatedLearningOrchestrator(tf, "fl", client, agg, n_clients=6, rounds=2,
                                       threshold=0.5, round_timeout=2.0,
                                       object_store=store)
    fl.deploy()
    try:
        res = fl.start(init_model=0.0, timeout=60)
    finally:
        tf.shutdown()
    out["fedlearn"] = {"status": res["status"], "model": store.get(res["result"]["model"])}
    return out


def phase_orchestrators():
    """The four orchestrators on the card's facade against the CPU's; they
    keep their event log, so their workers run no vector join."""
    card, cpu = _orchestrators("cuda"), _orchestrators("cpu")
    want = {"dag_diamond": [11, 101], "dag_map_join": 28,
            "asl_choice_parallel_map": [2, 4, 6], "wac_suspend_replay": 13}
    for name, res in want.items():
        if card[name]["status"] != "succeeded" or card[name]["result"] != res:
            raise AssertionError(f"{name} on the card: {card[name]}")
    if card["fedlearn"] != {"status": "succeeded", "model": 2.0}:
        raise AssertionError(f"fedlearn on the card: {card['fedlearn']}")
    if card != cpu:
        raise AssertionError(f"the orchestrators on the card {card} differ from the "
                             f"CPU's {cpu}")
    emit(phase="orchestrators", results=card, equal_to_cpu=True,
         note="the facade's workers keep their event log: no vector join, no K1")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; run it "
              "from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    adopt_orphans()
    try:
        lines = run_phases(torch)
    finally:
        left = stop_children()
    if left:
        raise AssertionError(f"processes still running after the phases: {sorted(left)}")
    for line in lines:
        print(line)
    return 0


def run_phases(torch) -> list:
    """Phases 1-19; returns the lines that end the output (the kernels line,
    the card's name and power limit, the result), printed once every process
    the phases started has ended."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    t_start = time.perf_counter()
    phase_build()
    k1 = phase_k1()
    k2 = phase_k2()
    k3 = phase_k3()
    k1_launches = phase_join()
    k2_launches = phase_serving()
    hybrid = phase_hybrid()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT / "build") as tmp:
        k1_shard_launches = phase_shards(Path(tmp))
        phase_scale(Path(tmp))
        k1_chaos_launches = phase_chaos(Path(tmp))
    phase_orchestrators()
    families = {}
    for name, phase in (("qwen2-vl-72b", phase_vlm), ("musicgen-large", phase_audio),
                        ("phi3.5-moe-42b-a6.6b", phase_moe),
                        ("deepseek-v2-236b", lambda: phase_mla(
                            {route: k2[route]["max_abs_err"] for route in k2}))):
        families[name] = phase()
    phase_xlstm()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT / "build") as tmp:
        train = phase_train(Path(tmp))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT / "build") as tmp:
        mesh = phase_distributed(Path(tmp))
    phase_moe_decode()
    emit(phase="total", seconds=time.perf_counter() - t_start)
    mla = families["deepseek-v2-236b"]
    sm90_paths = {"llama3.2-3b": k2_launches, "zamba2-1.2b": hybrid["k2_sm90"],
                  "qwen2-vl-72b": families["qwen2-vl-72b"],
                  "musicgen-large": families["musicgen-large"],
                  "phi3.5-moe-42b-a6.6b": families["phi3.5-moe-42b-a6.6b"]["sm90"],
                  "deepseek-v2-236b": mla["sm90"],
                  "train": train["train"],
                  "train_orchestrated": train["train_orchestrated"],
                  "distributed": mesh["k2_sm90"]}
    # the scalar route serves no path since deepseek-v2 took the sm90 route:
    # its launches are the fp32 logit checks'
    scalar_paths = {"zamba2-1.2b fp32": hybrid["k2_scalar"],
                    "phi3.5-moe-42b-a6.6b fp32": families["phi3.5-moe-42b-a6.6b"]["scalar"],
                    "deepseek-v2-236b fp32": mla["scalar_fp32"],
                    "distributed fp32": mesh["k2_scalar"]}
    # the sm90 row is timed at llama3.2-3b's shape, with deepseek-v2's beside
    # it; the scalar row keeps deepseek-v2's shape, as before the sm90 route
    # took it, with llama3.2-3b's beside it
    timing = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "tflops")
    sm90_at_deepseek = {k: mla["timed"]["sm90"][k] for k in timing}
    scalar_at_llama = {k: k2["scalar"][k] for k in ("ms", "plain_ms", "bound_ms",
                                                     "library_ms")}
    kernels = [
        {"name": "event_join", "route": "cuda", "source": "src/repro_torch/csrc/event_join.cu",
         "replaces": "src/repro/kernels/event_join/event_join.py:51",
         "launches": k1_launches, "launches_shard_path": k1_shard_launches,
         "launches_chaos_join": k1_chaos_launches, **k1},
        {"name": "flash_attention_sm90", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:78",
         "launches": sum(sm90_paths.values()), "launches_by_path": sm90_paths, **k2["sm90"],
         "at_deepseek_shape": sm90_at_deepseek},
        {"name": "flash_attention_scalar", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:78",
         "launches": sum(scalar_paths.values()), "launches_by_path": scalar_paths,
         **mla["timed"]["scalar"], "at_llama_shape": scalar_at_llama},
        {"name": "ssd_scan_sm90", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_scan_sm90.cu",
         "replaces": "src/repro/kernels/ssd/ssd.py:78",
         "launches": hybrid["k3_sm90"] + mesh["k3_sm90"] + mesh["k3_sm90_bf16_decay"],
         "launches_by_path": {"zamba2-1.2b": hybrid["k3_sm90"], "distributed": mesh["k3_sm90"],
                              "distributed bf16 decay": mesh["k3_sm90_bf16_decay"]},
         **k3["sm90"]},
        {"name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd/ssd.py:78",
         "launches": hybrid["k3_scalar"] + mesh["k3_scalar"],
         "launches_by_path": {"zamba2-1.2b fp32": hybrid["k3_scalar"],
                              "distributed fp32": mesh["k3_scalar"]},
         **k3["scalar"]},
        {"name": "ssd_step", "route": "cuda", "source": "src/repro_torch/csrc/ssd_step.cu",
         "replaces": "none: the JAX package's decode step is plain jnp "
                     "(src/repro/models/ssm.py, mamba2_decode)",
         "launches": hybrid["ssd_step"] + hybrid["ssd_step_op_by_op"],
         "launches_by_path": {"zamba2-1.2b served (warm-up and capture; replays relaunch it)":
                              hybrid["ssd_step"],
                              "zamba2-1.2b op-by-op check": hybrid["ssd_step_op_by_op"]},
         "max_abs_err": hybrid["ssd_step_err"],
         **{k: hybrid["ssd_step_timed"]["b64"][k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "at_batch_8": {k: hybrid["ssd_step_timed"]["b8"][k]
                        for k in ("ms", "plain_ms", "bound_ms", "bound_by")}},
    ]
    idle = [kern["name"] for kern in kernels if not kern["launches"]]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: {idle}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("launches_shard_path", "launches_chaos_join", "launches_by_path",
             "at_llama_shape", "at_deepseek_shape", "bf16_decay", "at_batch_8")
    return [json.dumps({"kernels": [{k: kern[k] for k in keys + extra if k in kern}
                                    for kern in kernels]}),
            card,
            json.dumps({"ok": True, "device": {"platform": "gpu",
                                                "kind": torch.cuda.get_device_name(0),
                                                "count": torch.cuda.device_count()}})]


if __name__ == "__main__":
    sys.exit(main())
