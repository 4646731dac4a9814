"""Trigger-orchestrated batched serving engine.

Requests arrive as CloudEvents; a *batcher* trigger aggregates up to
``max_batch`` requests (or fires on a flush timeout — same rich-trigger
machinery as the FL aggregator), its action runs prefill + N greedy decode
steps on the Triggerflow's device, and emits one termination event per
request.  Scale-to-zero falls out of Triggerflow: no requests → no events →
the worker is reclaimed.  The action is ``serve.batch`` in the port's own
``PYFUNCS``, so the JAX package's engine and this one never share it.

Prompts are token lists, batched as [B, S], as in the JAX package's engine,
so the audio family (tokens [B, K, S] over K codebooks) is refused here and
runs at the model level (``Model.prefill`` / ``Model.decode``).

Observability.  The engine owns a ``MetricsRegistry`` (``metrics``) whose
counters are always on and take one ``inc`` a batch:
``tf_serve_requests_total``, ``tf_serve_batches_total``,
``tf_serve_prompt_tokens_total`` (real prompt tokens),
``tf_serve_pad_tokens_total`` (B·S less those),
``tf_serve_decode_steps_total`` and ``tf_serve_decode_graph_replays_total``
(the steps that replayed a CUDA graph, ``models.decode_graph``, read off
the model's own count; over the steps, the graph's hit share), and the MoE
layers' ``tf_serve_moe_routed_slots_total``, ``_held_slots_total`` (slots
whose expert this chip holds), ``_expert_rows_total`` (rows the expert
products computed: held experts × capacity, or the held slots where the
experts run grouped), ``_dropped_slots_total`` (held slots past the
capacity) and ``_experts_read_total`` (held experts whose weights the
products read, summed over the MoE calls; over held experts × calls, the
share of the experts' bytes read), read off the model's device-side
running sums (``Model.moe_sums``) once a batch, after the decode loop's
synchronising read of the tokens; 0 for a model without MoE layers.  Given a
``Tracer``, it records spans on the trace plane (``obs/trace.py``), all
stamped by ``Tracer.begin`` (``ts`` on ``time.time()``, the clock of the
profiler's device trace) and ended by ``Tracer.end``:

- ``serve.request``, a root opened in ``submit`` when the tracer's sampler
  admits it, ended as its ``serve|done|<id>`` event is produced (just
  before ``produce`` publishes it); the request and done events carry its
  context.  Attributes ``id``, ``prompt_len``, ``batch`` (its batch's span
  id);
- ``serve.batch``, a root for every fired batch, from the action's start to
  its last done event published: ``n``, ``S`` (padded length),
  ``prompt_tokens``, ``pad_tokens``, ``ids``;
- ``serve.prefill`` (``B``, ``S``, ``prompt_tokens``, ``pad_tokens``; for a
  model with MoE layers also the prefill's own ``moe_routed_slots``,
  ``moe_held_slots``, ``moe_expert_rows``, ``moe_dropped_slots`` and
  ``moe_experts_read``, the one place a span reads the device: the
  running sums before and after the prefill) and one
  ``serve.decode`` a step (``B``, ``pos``, ``graph``: whether the step
  replayed a graph), children of the batch, around
  the model's calls.  No span synchronises the device: on a card a span
  holds the host's side of the call.

Without a tracer (the default) no span is built and no clock is read.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core import Triggerflow, termination_event
from ..core.actions import register_pyfunc
from ..core.triggers import make_trigger
from ..models import Model, ModelConfig
from ..obs.metrics import MetricsRegistry
from ..obs.trace import Tracer, context_of_span, inject

_ENGINES: Dict[str, "ServingEngine"] = {}

# ``Model.moe_sums``' entries, in order, as counters and span attributes
MOE_COUNTS = ("routed_slots", "held_slots", "expert_rows", "dropped_slots", "experts_read")


def engine_for(workflow: str) -> Optional["ServingEngine"]:
    """The engine serving ``workflow``, or None."""
    return _ENGINES.get(workflow)


class ServingEngine:
    def __init__(self, cfg: ModelConfig, tf: Triggerflow, workflow: str,
                 max_batch: int = 4, max_new_tokens: int = 16,
                 max_len: int = 256, tracer: Optional[Tracer] = None):
        if cfg.family == "audio":
            raise ValueError(f"{cfg.arch}: the serving engine batches [B, S] token "
                             f"prompts; the audio family takes [B, K, S] codebook "
                             f"tokens and runs at the model level")
        self.cfg = cfg
        self.tf = tf
        self.workflow = workflow
        self.max_batch = max_batch
        self.max_new_tokens = max_new_tokens
        self.max_len = max_len
        self.device = tf.device
        self.model = Model(cfg, device=self.device, seed=0)
        self.tracer = tracer
        self._roots: Dict[str, dict] = {}       # request id -> its open serve.request
        # the open serve.batch: a field, not an argument, because the
        # benchmark wraps generate_batch(requests) with that signature
        self._batch: Optional[dict] = None
        self.metrics = MetricsRegistry()
        self._requests = self.metrics.counter("tf_serve_requests_total")
        self._batches = self.metrics.counter("tf_serve_batches_total")
        self._prompt_tokens = self.metrics.counter("tf_serve_prompt_tokens_total")
        self._pad_tokens = self.metrics.counter("tf_serve_pad_tokens_total")
        self._decode_steps = self.metrics.counter("tf_serve_decode_steps_total")
        self._graph_replays = self.metrics.counter("tf_serve_decode_graph_replays_total")
        self._moe = [self.metrics.counter(f"tf_serve_moe_{n}_total") for n in MOE_COUNTS]
        self._moe_read = [0] * len(MOE_COUNTS)      # the model's sums at the last read
        _ENGINES[workflow] = self

    @property
    def served(self) -> int:
        return self._requests.value

    @property
    def batches(self) -> int:
        return self._batches.value

    def _moe_sums(self) -> List[int]:
        """The model's MoE running sums (one device-to-host read), zeros
        before its first MoE call."""
        sums = self.model.moe_sums
        return [0] * len(MOE_COUNTS) if sums is None else sums.tolist()

    def deploy(self) -> None:
        self.tf.create_workflow(self.workflow, {"kind": "serving"})
        self.tf.add_trigger(self.workflow, make_trigger(
            "serve|request",
            condition={"name": "counter", "expected": self.max_batch,
                       "reset_on_fire": True},
            action={"name": "pyfunc", "func": "serve.batch", "engine": self.workflow},
            trigger_id=f"{self.workflow}/batcher",
            transient=False,
        ))

    def submit(self, request_id: str, prompt_tokens: List[int]) -> None:
        event = termination_event(
            "serve|request", result={"id": request_id, "prompt": prompt_tokens})
        if self.tracer is not None and self.tracer.sample_new():
            root = self.tracer.start_trace("serve.request", id=request_id,
                                           prompt_len=len(prompt_tokens))
            self._roots[request_id] = root
            inject([event], *context_of_span(root))
        self.tf.publish(self.workflow, event)

    def flush(self) -> None:
        """Force the batcher to fire with a partial batch (timeout analogue)."""
        worker = self.tf.worker(self.workflow)
        ctx = worker.context_of(f"{self.workflow}/batcher")
        pending = ctx.get("count", 0)
        if pending:
            ctx["expected"] = pending

    def prompt_batch(self, requests: List[Dict[str, Any]]) -> torch.Tensor:
        """The requests' prompts, left-padded with token 0 to the longest
        (the pad tokens are attended, as in the JAX package), on the device."""
        S = max(len(r["prompt"]) for r in requests)
        toks = np.zeros((len(requests), S), np.int64)
        for i, r in enumerate(requests):
            toks[i, S - len(r["prompt"]):] = r["prompt"]
        return torch.from_numpy(toks).to(self.device)

    def generate_batch(self, requests: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        tokens = self.prompt_batch(requests)
        B, S = tokens.shape
        real = sum(len(r["prompt"]) for r in requests)
        batch, tracer = self._batch, self.tracer
        moe = bool(self.cfg.n_experts)
        if batch is not None:
            batch.update(S=S, prompt_tokens=real, pad_tokens=B * S - real)
            span = tracer.begin("serve.prefill", batch["trace"], batch["span"], B=B, S=S,
                                prompt_tokens=real, pad_tokens=B * S - real)
            before = self._moe_sums() if moe else None
        logits, cache = self.model.prefill({"tokens": tokens}, max_len=self.max_len)
        if batch is not None:
            if moe:
                for name, a, b in zip(MOE_COUNTS, before, self._moe_sums()):
                    span[f"moe_{name}"] = b - a
            tracer.end(span)
        tok = logits.argmax(-1)[:, None]
        outs = []
        replays = self.model.decode_graph_replays
        for _ in range(self.max_new_tokens):
            outs.append(tok)
            if batch is not None:
                span = tracer.begin("serve.decode", batch["trace"], batch["span"], B=B,
                                    pos=cache["pos"])
                before = self.model.decode_graph_replays
            logits, cache = self.model.decode(cache, {"tokens": tok})
            if batch is not None:
                span["graph"] = self.model.decode_graph_replays > before
                tracer.end(span)
            tok = logits.argmax(-1)[:, None]
        # one device-to-host copy for the whole batch
        generated = torch.cat(outs, dim=1).tolist()
        self._requests.inc(B)
        self._batches.inc()
        self._prompt_tokens.inc(real)
        self._pad_tokens.inc(B * S - real)
        self._decode_steps.inc(self.max_new_tokens)
        self._graph_replays.inc(self.model.decode_graph_replays - replays)
        if moe:
            sums = self._moe_sums()
            for counter, now, last in zip(self._moe, sums, self._moe_read):
                counter.inc(now - last)
            self._moe_read = sums
        return [{"id": r["id"], "tokens": generated[i]} for i, r in enumerate(requests)]

    def serve(self, ctx, requests: List[Dict[str, Any]]) -> None:
        """The batcher's action: generate for one fired batch and produce a
        ``serve|done|<id>`` event a request.  A batch that raises still ends
        its batch span and its requests' spans, these marked ``error``."""
        tracer, batch = self.tracer, None
        if tracer is not None:
            ids = [r["id"] for r in requests]
            batch = tracer.start_trace("serve.batch", n=len(ids), ids=ids)
            for rid in ids:
                if rid in self._roots:
                    self._roots[rid]["batch"] = batch["span"]
        self._batch = batch
        try:
            for out in self.generate_batch(requests):
                done = termination_event(f"serve|done|{out['id']}", result=out)
                root = None if batch is None else self._roots.pop(out["id"], None)
                if root is not None:
                    inject([done], *context_of_span(root))
                    tracer.end(root)
                ctx.produce(done)        # publishes it to the event store
        finally:
            self._batch = None
            if batch is not None:
                for r in requests:       # left open only if the batch raised
                    root = self._roots.pop(r["id"], None)
                    if root is not None:
                        root["error"] = True
                        tracer.end(root)
                tracer.end(batch)

def _serve_batch(ctx, event, params) -> None:
    requests = [r for r in (ctx.get("fired_results") or []) if r]
    if requests:
        _ENGINES[params["engine"]].serve(ctx, requests)


register_pyfunc("serve.batch", _serve_batch)
