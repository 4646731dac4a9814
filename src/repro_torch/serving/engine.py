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
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..core import Triggerflow, termination_event
from ..core.actions import register_pyfunc
from ..core.triggers import make_trigger
from ..models import Model, ModelConfig

_ENGINES: Dict[str, "ServingEngine"] = {}


class ServingEngine:
    def __init__(self, cfg: ModelConfig, tf: Triggerflow, workflow: str,
                 max_batch: int = 4, max_new_tokens: int = 16,
                 max_len: int = 256):
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
        self.served = 0
        self.batches = 0
        _ENGINES[workflow] = self

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
        self.tf.publish(self.workflow, termination_event(
            "serve|request", result={"id": request_id, "prompt": prompt_tokens}))

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
        logits, cache = self.model.prefill({"tokens": tokens}, max_len=self.max_len)
        tok = logits.argmax(-1)[:, None]
        outs = []
        for _ in range(self.max_new_tokens):
            outs.append(tok)
            logits, cache = self.model.decode(cache, {"tokens": tok})
            tok = logits.argmax(-1)[:, None]
        # one device-to-host copy for the whole batch
        generated = torch.cat(outs, dim=1).tolist()
        self.served += len(requests)
        self.batches += 1
        return [{"id": r["id"], "tokens": generated[i]} for i, r in enumerate(requests)]


def _serve_batch(ctx, event, params) -> None:
    eng = _ENGINES[params["engine"]]
    requests = [r for r in (ctx.get("fired_results") or []) if r]
    if not requests:
        return
    for out in eng.generate_batch(requests):
        ctx.produce(termination_event(f"serve|done|{out['id']}", result=out))


register_pyfunc("serve.batch", _serve_batch)
