"""Serving launcher: trigger-batched generation with scale-to-zero.

    python -m repro_torch.launch.serve --arch llama3.2-3b --requests 8
    python -m repro_torch.launch.serve --arch llama3.2-3b --smoke --device cpu
    python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b --smoke --device cpu
    python -m repro_torch.launch.serve --arch xlstm-1.3b --smoke --device cpu
    python -m repro_torch.launch.serve --arch zamba2-1.2b --smoke --device cpu \
        --metrics-dump serve-metrics --trace-dump serve-spans.jsonl

Every family but ``audio`` (musicgen-large, whose prompts are [K, S]
codebook grids: the engine refuses it) serves.
"""
from __future__ import annotations

import argparse
import time

from ..configs import ARCHS, get_config
from ..core import KedaAutoscaler, Triggerflow
from ..obs.trace import SpanCollector, Tracer
from ..serving.engine import ServingEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--metrics-dump", metavar="PREFIX", default=None,
                    help="on exit, write the aggregated metrics snapshot to "
                         "PREFIX.prom (Prometheus text) and PREFIX.json, the "
                         "engine's serving counters included")
    ap.add_argument("--trace-dump", metavar="PATH", default=None,
                    help="trace every request, batch, prefill and decode step and "
                         "write the spans to PATH as JSON lines on exit")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=args.smoke)
    tf = Triggerflow(inline_functions=True, device=args.device)
    tracer = None
    if args.trace_dump:
        # room for every span: a request, and at most a batch a request
        # with its prefill and decode steps
        tracer = Tracer(sample=1.0, collector=SpanCollector(
            capacity=args.requests * (3 + args.max_new_tokens)))
    eng = ServingEngine(cfg, tf, "serve", max_batch=args.max_batch,
                        max_new_tokens=args.max_new_tokens, max_len=256, tracer=tracer)
    eng.deploy()
    scaler = KedaAutoscaler(tf, poll_interval=0.05, grace_period=0.5).start()
    t0 = time.time()
    try:
        for i in range(args.requests):
            eng.submit(f"req-{i}", [1 + i, 2 + i, 3 + i])
        while eng.served < args.requests and time.time() - t0 < 300:
            time.sleep(0.05)
        print(f"served {eng.served} requests in {eng.batches} batches, "
              f"{time.time() - t0:.1f}s")
    finally:
        # order matters: stop() drains any in-flight autoscaler tick (one
        # caught mid-start_shards would otherwise provision workers *after*
        # shutdown began, leaving them unreaped), then shutdown reclaims
        # everything the drained tick started.
        scaler.stop()
        if args.metrics_dump:
            # scrape before shutdown tears the workers down: the snapshot
            # folds every worker registry + the autoscaler's counters
            from ..obs.metrics import dump_metrics, merge_snapshot
            snap = tf.metrics_snapshot()
            merge_snapshot(snap, scaler.metrics_snapshot())
            merge_snapshot(snap, eng.metrics.snapshot())
            for path in dump_metrics(snap, args.metrics_dump):
                print(f"metrics dumped to {path}")
        tf.shutdown()
        if tracer is not None:
            n = tracer.collector.export_jsonl(args.trace_dump)
            print(f"{n} spans dumped to {args.trace_dump}")


if __name__ == "__main__":
    main()
