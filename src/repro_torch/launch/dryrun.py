"""Multi-pod dry-run: trace every (arch × shape × mesh) cell's step on the
production mesh with FakeTensor inputs and record memory, cost and
collective traffic (the counterpart of the reference's dry-run, which
lowers and compiles on 512 host devices).

A fake process group of 512 ranks takes the place of the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count=512``: ``main`` makes it
this interpreter's default group before any mesh exists, as the
reference's flag must precede JAX's start, so tests and ``chip_smoke.py``
run the dry-run in a subprocess of its own.  The model is built on the
``meta`` device, its parameters become DTensors of fake local shards, and
``make_fx`` traces rank 0's local program: its shapes are local shapes and
its communication is ``_c10d_functional`` collectives
(``distributed.hlo_analysis``).  The dry-run allocates no device memory at
all, and no host memory for a tensor's data.

The fake tensors live on ``cpu``, so attention takes the plain chunked
path and the SSD its plain version, as the reference's XLA lowering does.
A step whose op has no DTensor sharding strategy ends ``status: "failed"``
with the op in ``error``, as the reference records a failed compile; no
cell runs unsharded.

xlstm's sLSTM blocks scan the sequence one cell step a token, and the
trace unrolls the scan (a 2-layer train_4k cell: 634.5 s of one CPU core,
against 33.5 s extrapolated; the full depth about an hour a trace).  Where a
cell has sLSTM blocks and more than one token a sequence, it is traced
twice, each scan taking its first 1 and 2 steps (``models.xlstm.scan_steps``),
and the FLOPs, bytes, collective bytes and temporary memory are
extrapolated linearly to S steps, as ``analyze_cell`` extrapolates probes
over depth; the result says so in ``slstm_steps_extrapolated`` (S) and
never drops the blocks from the count.

Usage:
    python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--both-meshes] [--no-probe]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict

import torch

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.distributed.hlo_analysis import (HBM_BW, NET_BW, PEAK_FLOPS,
                                                  collective_bytes, cost_of, memory_of,
                                                  roofline_terms)
from repro_torch.distributed.sharding import Resolver, activate, distribute_model
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import batch_specs
from repro_torch.models import Model
from repro_torch.models import xlstm as XL
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train_step import (make_decode_step, make_prefill_step,
                                             make_train_step)

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "torch", "dryrun")
WORLD = 512          # the multi-pod mesh; the single-pod one spans its first 256


def init_fake_world() -> None:
    """Make a fake process group of ``WORLD`` ranks this interpreter's
    default group (once): its collectives return at once and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), world_size=WORLD, rank=0)
    elif dist.get_backend() != "fake":
        raise RuntimeError("the dry-run needs the fake process group as this "
                           "interpreter's default group; run it in a process of its own")


_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _patched_config(arch: str, config_patch):
    cfg = get_config(arch)
    for k, v in (config_patch or {}).items():
        if k.endswith("dtype") and isinstance(v, str):
            v = _DTYPES[v]
        setattr(cfg, k, v)
    return cfg


def _distribute(t: torch.Tensor, resolver: Resolver):
    """A batch entry at ("batch", None, ...), made from its fake local shard."""
    from torch.distributed.tensor import distribute_tensor

    axes = ("batch",) + (None,) * (t.dim() - 1)
    return distribute_tensor(t, resolver.mesh, resolver(axes, t.shape), src_data_rank=None)


def _trace(kind: str, model: Model, cfg, shape: str, resolver: Resolver, mode,
           accum_steps: int):
    """Trace rank 0's step → (graph, its fake local inputs)."""
    from torch.distributed.tensor import DTensor
    from torch.fx.experimental.proxy_tensor import make_fx

    s = SHAPES[shape]
    mesh = resolver.mesh
    with mode:
        batch = {k: _distribute(v, resolver) for k, v in batch_specs(cfg, shape, mode).items()}
        inputs = dict(batch)
        if kind == "train":
            opt = AdamW()
            step = make_train_step(model, opt, accum_steps=accum_steps)
            state = opt.init(dict(model.named_parameters()))
        elif kind == "prefill":
            step = make_prefill_step(model, max_len=s["seq"])
        else:
            step = make_decode_step(model)
            with activate(resolver):
                cache = model.init_cache(s["batch"], s["seq"])
            pos = cache.pop("pos")
            inputs.update({f"cache.{k}": v for k, v in cache.items()})
    names = list(inputs)
    layout = {k: (v.placements, v.shape, v.stride()) for k, v in inputs.items()}

    def local(out):
        return out.to_local() if isinstance(out, DTensor) else out

    def program(*locals_):
        got = {k: DTensor.from_local(t, mesh, layout[k][0], run_check=False,
                                     shape=layout[k][1], stride=layout[k][2])
               for k, t in zip(names, locals_)}
        b = {k: v for k, v in got.items() if not k.startswith("cache.")}
        with activate(resolver):
            if kind == "train":
                _, metrics = step(state, b)
                return local(metrics["loss"])
            if kind == "prefill":
                logits, cache_out = step(b)
            else:
                cache_in = {k[len("cache."):]: v for k, v in got.items()
                            if k.startswith("cache.")}
                logits, cache_out = step({**cache_in, "pos": pos}, b)
            return local(logits), [local(v) for k, v in cache_out.items() if k != "pos"]

    args = [inputs[k].to_local() for k in names]
    gm = make_fx(program, tracing_mode="fake")(*args)
    return gm, args


def dryrun_cell(arch: str, shape: str, multi_pod: bool = False,
                overrides: Dict[str, Any] = None,
                config_patch: Dict[str, Any] = None,
                accum_steps: int = 1) -> Dict[str, Any]:
    """One cell on the production mesh: trace, then the analysis of rank 0's
    graph, under the reference's result keys."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = _patched_config(arch, config_patch)
    if not shape_applicable(cfg, shape):
        return {"arch": arch, "shape": shape, "status": "skipped",
                "multi_pod": multi_pod,
                "reason": "full-attention arch at 500k context (see DESIGN.md §4)"}
    init_fake_world()
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    n_dev = mesh.size()
    resolver = Resolver(cfg, mesh, overrides=overrides)
    kind = SHAPES[shape]["kind"]
    steps = slstm_steps(cfg, shape)
    t0 = time.time()
    try:
        mode = FakeTensorMode()
        with mode:
            model = Model(cfg, device="meta")
            distribute_model(model, resolver)
        traced = []
        for n in ((1, 2) if steps else (None,)):
            with XL.scan_steps(n):
                gm, args = _trace(kind, model, cfg, shape, resolver, mode, accum_steps)
                with mode:
                    traced.append((cost_of(gm, args), collective_bytes(gm), memory_of(gm)))
    except Exception as e:  # noqa: BLE001
        traceback.print_exc()
        return {"arch": arch, "shape": shape, "status": "failed",
                "multi_pod": multi_pod, "error": f"{type(e).__name__}: {e}"[:2000]}
    cost, coll, mem = traced[0]
    if steps:
        cost, coll, mem = ({k: v + (traced[1][i][k] - v) * (steps - 1) for k, v in d.items()}
                           for i, d in enumerate(traced[0]))
        mem["peak_est_bytes"] = mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
    terms = roofline_terms(cost, coll, n_dev)

    # analytic model FLOPs
    n_params = cfg.param_count()
    n_active = cfg.active_param_count()
    s = SHAPES[shape]
    tokens = s["batch"] * (s["seq"] if kind != "decode" else 1)
    model_flops = ((6 if kind == "train" else 2) * n_active * tokens
                   + model_attention_flops(cfg, shape))
    hlo_flops_total = terms["flops_per_device"] * n_dev
    return {
        "arch": arch, "shape": shape, "status": "ok", "multi_pod": multi_pod,
        "n_devices": n_dev, "kind": kind, "n_layers": cfg.n_layers,
        "compile_s": round(time.time() - t0, 1),
        "graph_nodes": len(gm.graph.nodes),
        "params": n_params, "active_params": n_active,
        "tokens": tokens, "model_flops": model_flops,
        "hlo_flops_total": hlo_flops_total,
        "useful_flops_ratio": (model_flops / hlo_flops_total
                               if hlo_flops_total else 0.0),
        "memory": mem,
        "collectives": coll,
        "roofline": terms,
        "dominant": max(("t_compute", "t_memory", "t_collective"),
                        key=lambda k: terms[k]),
        **({"slstm_steps_extrapolated": steps} if steps else {}),
    }


def slstm_steps(cfg, shape: str) -> int:
    """S where the cell's sLSTM scans are traced at 1 and 2 steps and
    extrapolated to S (xlstm with sLSTM blocks, more than one token a
    sequence), else 0."""
    S = 1 if SHAPES[shape]["kind"] == "decode" else SHAPES[shape]["seq"]
    has_slstm = cfg.family == "xlstm" and any(map(cfg.is_slstm, range(cfg.n_layers)))
    return S if has_slstm and S > 1 else 0


def model_attention_flops(cfg, shape: str) -> float:
    """Analytic attention FLOPs (causal → S²/2) for the MODEL_FLOPS term."""
    s = SHAPES[shape]
    B, S = s["batch"], s["seq"]
    kind = s["kind"]
    mult = 3 if kind == "train" else 1  # fwd + 2×bwd
    if cfg.family in ("dense", "vlm", "audio", "moe"):
        n_attn, S_eff = cfg.n_layers, S
        dh_qk = dh_v = cfg.head_dim
    elif cfg.family == "mla_moe":
        n_attn, S_eff = cfg.n_layers, S
        dh_qk, dh_v = cfg.nope_head_dim + cfg.rope_head_dim, cfg.v_head_dim
    elif cfg.family == "hybrid":
        n_attn = len([i for i in range(cfg.n_layers)
                      if cfg.attn_every and i % cfg.attn_every == 0])
        S_eff, dh_qk, dh_v = S, cfg.head_dim, cfg.head_dim
    else:  # xlstm: attention-free
        return 0.0
    if kind == "decode":
        # one query over the full cache
        per_layer = 2 * B * cfg.n_heads * S * (dh_qk + dh_v)
    else:
        per_layer = 2 * B * cfg.n_heads * (S_eff ** 2 / 2) * (dh_qk + dh_v)
    return mult * n_attn * per_layer


# affine analysis probes: depths per family (chosen so heterogeneous block
# cadences — zamba's shared-attn sites, xlstm's sLSTM layers — appear at
# production density in the L2-L1 slope)
PROBE_POINTS = {"hybrid": (14, 26), "xlstm": (8, 16), "mla_moe": (3, 5)}
_EXTRAP_KEYS = ("flops_per_device", "bytes_per_device",
                "collective_bytes_per_device")


def analyze_cell(arch: str, shape: str, config_patch=None, overrides=None,
                 probe_patch=None, tag: str = "") -> Dict[str, Any]:
    """Production trace (memory truth) + affine probe (two shallower
    depths, attention unrolled with its causal block skip, cost and
    collective truth) → roofline terms extrapolated to the full depth."""
    cfg = get_config(arch)
    prod = dryrun_cell(arch, shape, multi_pod=False, overrides=overrides,
                       config_patch=config_patch)
    if prod["status"] != "ok":
        return prod
    L1, L2 = PROBE_POINTS.get(cfg.family, (2, 4))
    probes = []
    for depth in (L1, L2):
        patch = {"n_layers": depth, "scan_layers": False, "unroll_attention": True}
        patch.update(config_patch or {})
        patch.update(probe_patch or {})
        patch["n_layers"] = depth
        r = dryrun_cell(arch, shape, multi_pod=False, overrides=overrides,
                        config_patch=patch)
        if r["status"] != "ok":
            r["probe_L"] = depth
            return r
        probes.append(r)
    full_L = (config_patch or {}).get("n_layers", cfg.n_layers)
    extr = {}
    for key in _EXTRAP_KEYS:
        v1 = probes[0]["roofline"][key]
        v2 = probes[1]["roofline"][key]
        a = (v2 - v1) / (L2 - L1)
        extr[key] = v1 + a * (full_L - L1)
    terms = {
        "t_compute": extr["flops_per_device"] / PEAK_FLOPS,
        "t_memory": extr["bytes_per_device"] / HBM_BW,
        "t_collective": extr["collective_bytes_per_device"] / NET_BW,
        **extr,
    }
    n_dev = prod["n_devices"]
    hlo_total = extr["flops_per_device"] * n_dev
    result = dict(prod)
    result.update({
        "analysis": "affine_probe",
        "probe_points": [L1, L2],
        "probe_flops_per_device": [p["roofline"]["flops_per_device"] for p in probes],
        "probe_compile_s": [p["compile_s"] for p in probes],
        "roofline": terms,
        "hlo_flops_total": hlo_total,
        "useful_flops_ratio": (prod["model_flops"] / hlo_total) if hlo_total else 0.0,
        "dominant": max(("t_compute", "t_memory", "t_collective"),
                        key=lambda k: terms[k]),
        "production_cost_raw": prod["roofline"],
    })
    return result


def save_result(res: Dict[str, Any], tag: str = "") -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    mp = "multi" if res.get("multi_pod") else "single"
    name = f"{res['arch']}_{res['shape']}_{mp}{tag}.json".replace("/", "_")
    path = os.path.join(RESULTS_DIR, name)
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    return path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-probe", action="store_true",
                    help="trace-proof only (skip roofline probes)")
    args = ap.parse_args()
    init_fake_world()

    cells = []
    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                cells.append((arch, shape, mp))

    n_ok = n_skip = n_fail = 0
    for arch, shape, mp in cells:
        mp_tag = "multi" if mp else "single"
        fname = os.path.join(RESULTS_DIR, f"{arch}_{shape}_{mp_tag}.json")
        if args.skip_existing and os.path.exists(fname):
            print(f"[skip-existing] {arch} × {shape} × {mp_tag}")
            continue
        if mp or args.no_probe:
            res = dryrun_cell(arch, shape, multi_pod=mp)  # trace-proof only
        else:
            res = analyze_cell(arch, shape)               # + roofline probes
        path = save_result(res)
        if res["status"] == "ok":
            n_ok += 1
            t = res["roofline"]
            print(f"[ok]   {arch} × {shape} × {mp_tag}: "
                  f"compute={t['t_compute']:.3e}s memory={t['t_memory']:.3e}s "
                  f"coll={t['t_collective']:.3e}s dominant={res['dominant']} "
                  f"({res['compile_s']}s trace) -> {path}", flush=True)
        elif res["status"] == "skipped":
            n_skip += 1
            print(f"[skip] {arch} × {shape}: {res['reason']}", flush=True)
        else:
            n_fail += 1
            print(f"[FAIL] {arch} × {shape} × {mp_tag}: {res['error']}", flush=True)
    print(f"dry-run done: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
