#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

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
             TMA) on every case that takes its route (bf16, D = Dv in
             {64, 128}) and on more at the serving shapes; a misaligned view
             must raise; both timed at the serving shapes of llama3.2-3b and
             zamba2-1.2b beside scaled_dot_product_attention (the yardstick
             only);
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
             yardstick);
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
             scalar routes of K2 and K3.

Each kernel's launch count is set to 0 just before the path that should
launch it (phases 5, 6 and 7, and the fp32 forwards of 7 for the scalar
kernels of K2 and K3) and read just after.  Earlier lines print JSON
results, the card's name and power limit and a "kernels" line; the last line
is {"ok": true, "device": {...}}.  Without CUDA, or away from the repo, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
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
                "k3_sm90": "ssd_sm90_", "k3_scalar": "ssd_fwd<"}


def device_profile(fn, iters: int, top: int = 0, attempts: int = 3) -> dict:
    """Per call of ``fn``: host wall ms (ending in a synchronize), and from
    torch.profiler the summed time of its device activities (kernels,
    copies, fills) and their number, and the time of each of the model's
    kernels (``kernel_ms``).  A profiling session now and then records no
    device activity at all; such a session is run again, up to ``attempts``
    sessions in all (``sessions`` says how many it took).  ``device_ms`` is
    None where none of them saw device activity; wall_ms - device_ms is the
    device's idle time on one stream."""
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
    if top:
        out["top_ms"] = [[name[:80], us / 1e3 / iters] for name, us in
                         sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]
    return out


def kernel_times(iters: int, **fns) -> dict:
    """For each of ``ms`` (the kernel), ``plain_ms`` and ``library_ms``: the
    device time per call from the profiler, and beside it (``*event_ms``) the
    CUDA-event time per call of back-to-back calls, which is the host's time
    where the host cannot keep the card busy.  Where no profiling session saw
    device activity, the value is the CUDA-event time; ``timers`` says which
    clock gave each value."""
    out, timers = {}, {}
    for key, fn in fns.items():
        prof = device_profile(fn, iters)
        event_ms = cuda_ms(fn, iters)
        if prof["device_ms"] is None:
            out[key], timers[key] = event_ms, "cuda_events"
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
    # not, and B 1 below one tile
    sm90_only = [(4, 64, 24, 8, 128, 128, bf16, True),
                 (4, 64, 32, 32, 64, 64, bf16, True),
                 (4, 128, 32, 32, 64, 64, bf16, True),
                 (4, 1000, 32, 32, 64, 64, bf16, True),
                 (2, 1000, 32, 32, 64, 64, bf16, False),
                 (1, 40, 4, 2, 64, 64, bf16, True)]
    runs = [("scalar", c) for c in cases] + [("sm90", c) for c in cases + sm90_only
                                             if c[6] == bf16 and c[4] == c[5]]
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


def ssd_excess(got, want) -> tuple:
    """(max |got - want|, max of |got - want| less its tolerance) for K3's
    y or state against its plain version.  Both compute in fp32 in another
    order (the chunk's cumsum of a*dt included), which leaves fp32 results
    within 1e-4 (1 + max|want|); a bf16 y differs by one rounding flip more,
    2**-7 |want|.  The check passes while the excess is <= 0."""
    import torch

    d = (got.float() - want.float()).abs()
    tol = 1e-4 * (1 + want.float().abs().max().item())
    if want.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * want.float().abs()
    return d.max().item(), (d - tol).max().item()


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
    results = []
    max_err = {"sm90": 0.0, "scalar": 0.0}
    for route, seed, (B, S, H, P, N, chunk, dtype) in runs:
        inputs = _ssd_inputs(B, S, H, P, N, dtype, seed)
        name = f"{route} B{B} S{S} H{H} P{P} N{N} Q{chunk} {str(dtype)[6:]} seed {seed}"
        if route == "scalar":
            y, state = ops.ssd_scalar(*inputs, chunk=chunk)
            want_y, want_state = ssd_scan_torch(*inputs, chunk=chunk)
        else:
            n_sm90, n_scalar = ops.launches_sm90, ops.launches_scalar
            y, state = ops.ssd(*inputs, chunk=chunk)
            if (ops.launches_sm90, ops.launches_scalar) != (n_sm90 + 1, n_scalar):
                raise AssertionError(f"ssd_scan {name}: did not take the sm90 route")
            want_y, want_state = ops.ssd_plain(*inputs, chunk=chunk)
        (ey, xy), (es, xs) = ssd_excess(y, want_y), ssd_excess(state, want_state)
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
    emit(phase="k3", cases=results, misaligned_x=refused, plain_vs_recurrence_excess=rec)
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


def _serve(cfg, counters):
    """Serve 8 seeded prompts of 128-1024 tokens, 4 to a batch, 16 new tokens
    each, through ServingEngine under KedaAutoscaler on the card.  Every
    counter of ``counters`` (name: (module, attribute)) is set to 0 just
    before the run and read just after.  Then time the first batch's prefill
    and decode and
    profile both.  Returns the run's numbers and what the checks need."""
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
                "decode_16_steps": device_profile(decode_steps, 2, top=8)}
    run = dict(arch=cfg.arch, params=cfg.param_count(), init_s=init_s, requests=8,
               batches=eng.batches, new_tokens=16, prompt_lens=[len(p) for p in prompts],
               wall_s=wall, tokens_per_s=8 * 16 / wall, prefill_ms_batch0=prefill_ms,
               decode_ms_per_token=decode_ms, peak_gib=peak_gib, launches=launches,
               profile=profiles)
    return run, model, tokens


def _logits_by_variant(model, tokens, module, name, variants):
    """The logits at every position of ``tokens`` with ``module.<name>``
    swapped for each of ``variants`` in turn (monkeypatches of this
    script's, not switches in the package)."""
    real = getattr(module, name)
    full = {}
    try:
        for key, fn in variants.items():
            setattr(module, name, fn)
            full[key] = model.forward({"tokens": tokens})[0]
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

    full = _logits_by_variant(model, tokens, layers, "flash_attention",
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


def phase_hybrid():
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_scan_torch
    from repro_torch.models import ssm

    cfg = get_config("zamba2-1.2b")
    H = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
    if (cfg.family, cfg.n_layers, cfg.d_model, cfg.ssm_expand * cfg.d_model, H,
            cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk, len(cfg.shared_sites()),
            cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.vocab) != \
            ("hybrid", 38, 2048, 4096, 64, 64, 64, 128, 7, 32, 32, 64, 32000):
        raise AssertionError(f"zamba2-1.2b is not at full width: {cfg}")
    counters = {"k3": (ssd_ops, "launches"), "k3_sm90": (ssd_ops, "launches_sm90"),
                "k3_scalar": (ssd_ops, "launches_scalar"),
                **{c: (fa_ops, c) for c in COUNTERS}}
    run, model, tokens = _serve(cfg, counters)
    launches = run["launches"]
    sites = len(cfg.shared_sites())
    want = {"k3": 2 * cfg.n_layers, "k3_sm90": 2 * cfg.n_layers, "k3_scalar": 0,
            "launches": 2 * sites, "launches_sm90": 2 * sites, "launches_scalar": 0}
    if launches != want:
        raise AssertionError(f"launches {launches} in the hybrid run, want {want}: every bf16 "
                             f"Mamba2 layer takes K3's sm90 route and every bf16 "
                             f"shared-attention site K2's")

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

    bf16 = _logits_by_variant(model, tokens, ssm, "ssd", {"kernel": checked})["kernel"]
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
        fp32 = _logits_by_variant(model, tokens, ssm, "ssd", variants)
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
         fp32_logits_plain_q64_vs_plain_max_abs=floor, **gaps, **run)
    return {"k3_sm90": launches["k3_sm90"], "k3_scalar": fp32_k3["launches_scalar"],
            "k2_sm90": launches["launches_sm90"],
            "k2_scalar": fp32_launches["launches_scalar"]}


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
    emit(phase="total", seconds=time.perf_counter() - t_start)
    kernels = [
        {"name": "event_join", "route": "cuda", "source": "src/repro_torch/csrc/event_join.cu",
         "replaces": "src/repro/kernels/event_join/event_join.py:51",
         "launches": k1_launches, **k1},
        {"name": "flash_attention_sm90", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:78",
         "launches": k2_launches + hybrid["k2_sm90"], **k2["sm90"]},
        {"name": "flash_attention_scalar", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:78",
         "launches": hybrid["k2_scalar"], **k2["scalar"]},
        {"name": "ssd_scan_sm90", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_scan_sm90.cu",
         "replaces": "src/repro/kernels/ssd/ssd.py:78",
         "launches": hybrid["k3_sm90"], **k3["sm90"]},
        {"name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd/ssd.py:78",
         "launches": hybrid["k3_scalar"], **k3["scalar"]},
    ]
    idle = [kern["name"] for kern in kernels if not kern["launches"]]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: {idle}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
