"""The slice as a whole: trigger-batched serving in the port against the
JAX package's engine, on the CPU.

Both engines serve the llama3.2-3b smoke config, the zamba2-1.2b (hybrid)
smoke config, and those of phi3.5-moe (moe), qwen2-vl-72b (vlm) and
deepseek-v2 (mla_moe), in fp32 with the same weights (the port loads the
reference's through ``params_from_jax``), six requests with seeded prompt
lengths, three to a batch.  Greedy tokens are integers: they must be
identical per request id.  Given a ``Tracer``, the port's engine also
records its serving spans and counts its tokens; the tokens it serves stay
the same.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import Triggerflow as RefTriggerflow
from repro.serving.engine import ServingEngine as RefServingEngine
from repro_torch.configs import get_config
from repro_torch.core import Triggerflow
from repro_torch.models.convert import params_from_jax
from repro_torch.obs.trace import Tracer, trace_context
from repro_torch.serving.engine import MOE_COUNTS, ServingEngine


def _prompts(seed=0, n=6, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, int(rng.integers(5, 41))).tolist() for _ in range(n)]


def _engines(wf_ref="srv", wf_port="srv", arch="llama3.2-3b", tracer=None):
    ref = RefServingEngine(
        dataclasses.replace(jax_get_config(arch, smoke=True), dtype=jnp.float32),
        RefTriggerflow(inline_functions=True), wf_ref,
        max_batch=3, max_new_tokens=3, max_len=48)
    port = ServingEngine(
        dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32),
        Triggerflow(inline_functions=True, device="cpu"), wf_port,
        max_batch=3, max_new_tokens=3, max_len=48, tracer=tracer)
    port.model.load_state_dict(params_from_jax(jax.device_get(ref.params)), strict=True)
    return ref, port


def _served_events(eng, prompts):
    eng.deploy()
    for i, p in enumerate(prompts):
        eng.submit(f"r{i}", p)
    w = eng.tf.worker(eng.workflow)
    for _ in range(30):
        w.run_once()
    return w.event_log


def _serve(eng, prompts):
    done = [e for e in _served_events(eng, prompts) if e.subject.startswith("serve|done|")]
    return {e.data["result"]["id"]: e.data["result"]["tokens"] for e in done}


def test_port_serves_same_tokens_as_reference():
    ref, port = _engines()
    prompts = _prompts()
    want = _serve(ref, prompts)
    got = _serve(port, prompts)
    assert ref.batches == port.batches == 2
    assert len(got) == 6
    assert got == want
    for toks in got.values():
        assert len(toks) == 3 and all(0 <= t < port.cfg.vocab for t in toks)


def test_port_serves_same_tokens_as_reference_hybrid():
    """zamba2-1.2b: every prefill runs Mamba2's chunked scan and the shared
    attention block, every decode step the SSM recurrence."""
    ref, port = _engines(arch="zamba2-1.2b")
    assert port.cfg.family == "hybrid"
    prompts = _prompts(seed=2)
    want = _serve(ref, prompts)
    got = _serve(port, prompts)
    assert ref.batches == port.batches == 2
    assert len(got) == 6
    assert got == want
    for toks in got.values():
        assert len(toks) == 3 and all(0 <= t < port.cfg.vocab for t in toks)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "qwen2-vl-72b",
                                  "deepseek-v2-236b"])
def test_port_serves_same_tokens_as_reference_other_families(arch):
    """The MoE's routing (deepseek-v2's smoke config decodes 3 tokens at
    cap 1), Qwen2-VL's M-RoPE with its positions broadcast to (t, h, w),
    and MLA's absorbed decode, through both engines."""
    ref, port = _engines(arch=arch)
    prompts = _prompts(seed=3)
    want = _serve(ref, prompts)
    got = _serve(port, prompts)
    assert ref.batches == port.batches == 2
    assert len(got) == 6
    assert got == want


def test_engine_refuses_the_audio_family():
    """The engine batches [B, S] token prompts, as the reference's does;
    musicgen's [B, K, S] codebook grids run at the model level."""
    cfg = get_config("musicgen-large", smoke=True)
    with pytest.raises(ValueError, match="model level"):
        ServingEngine(cfg, Triggerflow(inline_functions=True, device="cpu"), "srv-audio")


def test_each_batcher_runs_its_own_engine():
    """Both packages register ``serve.batch`` in one process, each in its own
    PYFUNCS.  Two engines on the same workflow name, driven in turns: each
    batcher must run its own engine, and each engine serve only its own
    requests."""
    from repro.core.actions import PYFUNCS as REF_PYFUNCS
    from repro_torch.core.actions import PYFUNCS

    assert PYFUNCS["serve.batch"].__module__ == "repro_torch.serving.engine"
    assert REF_PYFUNCS["serve.batch"].__module__ == "repro.serving.engine"
    ref, port = _engines()
    prompts = _prompts(seed=1)
    workers = []
    for eng in (ref, port):
        eng.deploy()
        for i, p in enumerate(prompts):
            eng.submit(f"r{i}", p)
        workers.append(eng.tf.worker(eng.workflow))
    for _ in range(30):
        for w in workers:
            w.run_once()
    assert (ref.served, ref.batches) == (port.served, port.batches) == (6, 2)
    done = [{e.data["result"]["id"]: e.data["result"]["tokens"] for e in w.event_log
             if e.subject.startswith("serve|done|")} for w in workers]
    assert done[0] == done[1] and len(done[0]) == 6


@pytest.mark.parametrize("sample", [1.0, 0.0])
def test_traced_engine_records_its_serving_spans(sample):
    """A request span from publish to done (the sampler's roots), one batch
    span a fired batch with its prefill and a decode span a new token, the
    request's context on its request and done events, and the tokens of
    the untraced engine and of the reference."""
    tracer = Tracer(sample=sample)
    ref, port = _engines(wf_port="srv-traced", tracer=tracer)
    plain = ServingEngine(port.cfg, Triggerflow(inline_functions=True, device="cpu"), "srv",
                          max_batch=3, max_new_tokens=3, max_len=48)
    plain.model.load_state_dict(port.model.state_dict())
    prompts = _prompts(seed=4)
    events = _served_events(port, prompts)
    got = {e.data["result"]["id"]: e.data["result"]["tokens"] for e in events
           if e.subject.startswith("serve|done|")}
    assert got == _serve(plain, prompts) == _serve(ref, prompts) and len(got) == 6

    spans = list(tracer.collector.spans)
    assert all(s["dur"] is not None for s in spans)
    batches = {s["span"]: s for s in spans if s["name"] == "serve.batch"}
    roots = {s["id"]: s for s in spans if s["name"] == "serve.request"}
    assert len(batches) == 2
    assert sorted(i for b in batches.values() for i in b["ids"]) == sorted(got)
    for b in batches.values():
        calls = [s for s in spans if s["parent"] == b["span"]]
        prefill = [s for s in calls if s["name"] == "serve.prefill"]
        decode = sorted((s for s in calls if s["name"] == "serve.decode"), key=lambda s: s["ts"])
        assert len(prefill) == 1 and len(decode) == 3 and len(calls) == 4
        lens = [len(prompts[int(i[1:])]) for i in b["ids"]]
        B, S = len(lens), max(lens)
        want = {"B": B, "S": S, "prompt_tokens": sum(lens), "pad_tokens": B * S - sum(lens)}
        assert {k: prefill[0][k] for k in want} == want
        assert {k: b[k] for k in ("n", "S", "prompt_tokens", "pad_tokens")} == \
            {"n": B, "S": S, "prompt_tokens": sum(lens), "pad_tokens": B * S - sum(lens)}
        assert [(d["B"], d["pos"], d["graph"]) for d in decode] == \
            [(B, S + k, False) for k in range(3)]
        assert all(c["trace"] == b["trace"] for c in calls)
        assert b["ts"] <= prefill[0]["ts"] < decode[0]["ts"]
        assert prefill[0]["ts"] + prefill[0]["dur"] <= b["ts"] + b["dur"]
    if sample == 0.0:
        assert not roots
        assert all(trace_context(e) is None for e in events)
        return
    assert sorted(roots) == sorted(got)
    by_subject = {e.subject + (e.data["result"]["id"] if e.subject == "serve|request" else ""): e
                  for e in events}
    for rid, root in roots.items():
        batch = batches[root["batch"]]
        assert rid in batch["ids"] and root["parent"] is None
        assert root["prompt_len"] == len(prompts[int(rid[1:])])
        assert root["ts"] <= batch["ts"]
        assert root["ts"] + root["dur"] <= batch["ts"] + batch["dur"]
        ctx = (root["trace"], root["span"])
        assert trace_context(by_subject["serve|request" + rid]) == ctx
        assert trace_context(by_subject["serve|done|" + rid]) == ctx


def test_traced_batch_that_raises_ends_its_spans():
    """A batch whose model raises ends its batch span and its requests'
    roots (marked ``error``) and leaves nothing open on the engine."""
    tracer = Tracer(sample=1.0)
    _, port = _engines(tracer=tracer)
    port.deploy()
    prompts = _prompts(seed=6, n=3)
    for i, p in enumerate(prompts):
        port.submit(f"r{i}", p)

    def broken(*args, **kwargs):
        raise RuntimeError("decode failed")

    port.model.decode = broken
    produced = []
    ctx = type("Ctx", (), {"produce": lambda self, e: produced.append(e)})()
    with pytest.raises(RuntimeError, match="decode failed"):
        port.serve(ctx, [{"id": f"r{i}", "prompt": p} for i, p in enumerate(prompts)])
    assert produced == [] and port._roots == {} and port._batch is None
    spans = list(tracer.collector.spans)
    assert sorted(s["name"] for s in spans) == ["serve.batch", "serve.prefill"] \
        + ["serve.request"] * 3
    batch = next(s for s in spans if s["name"] == "serve.batch")
    roots = [s for s in spans if s["name"] == "serve.request"]
    assert all(r["error"] and r["batch"] == batch["span"] for r in roots)
    assert all(s["dur"] is not None for s in spans)
    assert (port.served, port.batches) == (0, 0)


def test_engine_counts_requests_batches_and_prompt_tokens():
    """The engine's counters after two batches, beside ``served`` and
    ``batches``; an engine without a tracer records no span."""
    ref, port = _engines()
    assert port.tracer is None
    prompts = _prompts(seed=5)
    _serve(port, prompts)
    assert (port.served, port.batches) == (6, 2)
    # the batcher fires on each third request, in publish order
    lens = [len(p) for p in prompts]
    slots = sum(3 * max(lens[k:k + 3]) for k in (0, 3))
    assert port.metrics.snapshot()["counters"] == {
        "tf_serve_requests_total": 6, "tf_serve_batches_total": 2,
        "tf_serve_prompt_tokens_total": sum(lens),
        "tf_serve_pad_tokens_total": slots - sum(lens),
        "tf_serve_decode_steps_total": 6, "tf_serve_decode_graph_replays_total": 0,
        "tf_serve_moe_routed_slots_total": 0, "tf_serve_moe_held_slots_total": 0,
        "tf_serve_moe_expert_rows_total": 0, "tf_serve_moe_dropped_slots_total": 0,
        "tf_serve_moe_experts_read_total": 0}
    assert port._roots == {} and port._batch is None


@pytest.mark.parametrize("arch", ["llama3.2-3b", "zamba2-1.2b"])
def test_engine_counts_decode_steps_and_graph_replays(arch):
    """Every decode step counts; on the CPU none replays a graph, and each
    ``serve.decode`` span says so.  With a model that reports replays (here
    every other step, as a card's would), the engine counts exactly those
    and marks their spans."""
    tracer = Tracer(sample=1.0)
    _, port = _engines(arch=arch, tracer=tracer)
    prompts = _prompts(seed=7)
    _serve(port, prompts)
    counters = port.metrics.snapshot()["counters"]
    assert counters["tf_serve_decode_steps_total"] == 6
    assert counters["tf_serve_decode_graph_replays_total"] == 0
    assert port.model.decode_graph_captures == port.model.decode_graph_replays == 0
    decodes = [s for s in tracer.collector.spans if s["name"] == "serve.decode"]
    assert len(decodes) == 6 and all(s["graph"] is False for s in decodes)

    model, real = port.model, port.model.decode
    calls = []

    def decode(cache, batch):
        calls.append(cache["pos"])
        model.decode_graph_replays += len(calls) % 2
        return real(cache, batch)

    model.decode = decode
    for i, p in enumerate(_prompts(seed=8)):
        port.submit(f"s{i}", p)
    worker = port.tf.worker(port.workflow)
    for _ in range(30):
        worker.run_once()
    counters = port.metrics.snapshot()["counters"]
    assert counters["tf_serve_decode_steps_total"] == 12
    assert counters["tf_serve_decode_graph_replays_total"] == 3
    decodes = [s for s in tracer.collector.spans if s["name"] == "serve.decode"][6:]
    assert [s["graph"] for s in sorted(decodes, key=lambda s: s["ts"])] == \
        [True, False] * 3


@pytest.mark.parametrize("capacity_factor", [None, 1.25])
def test_engine_counts_the_moe_slots_and_the_prefill_span_carries_them(capacity_factor):
    """deepseek-v2's smoke model (3 layers, the last 2 MoE, top-2) served
    dropless or at the default capacity: the routed slots are B·k·2 a
    position (the prefill's S and 3 decode steps), every expert held, the
    rows at least the slots; dropless drops none.  Each ``serve.prefill``
    carries its own five counts, and ``engine_for`` finds the engine."""
    from repro_torch.serving.engine import engine_for

    cfg = dataclasses.replace(get_config("deepseek-v2-236b", smoke=True), dtype=torch.float32,
                              capacity_factor=capacity_factor)
    tracer = Tracer(sample=1.0)
    port = ServingEngine(cfg, Triggerflow(inline_functions=True, device="cpu"), "srv-moe",
                         max_batch=3, max_new_tokens=3, max_len=48, tracer=tracer)
    assert engine_for("srv-moe") is port and engine_for("no-such-workflow") is None
    prompts = _prompts(seed=9)
    _serve(port, prompts)
    c = port.metrics.snapshot()["counters"]
    prefills = [sp for sp in tracer.collector.spans if sp["name"] == "serve.prefill"]
    assert len(prefills) == 2
    routed = sum(sp["B"] * 2 * 2 * (sp["S"] + 3) for sp in prefills)
    assert c["tf_serve_moe_routed_slots_total"] == c["tf_serve_moe_held_slots_total"] == routed
    assert sum(sp["moe_routed_slots"] for sp in prefills) == sum(
        sp["B"] * 2 * 2 * sp["S"] for sp in prefills)
    for name in MOE_COUNTS:
        assert 0 <= sum(sp[f"moe_{name}"] for sp in prefills) <= c[f"tf_serve_moe_{name}_total"]
    if capacity_factor is None:
        assert c["tf_serve_moe_dropped_slots_total"] == 0
        assert c["tf_serve_moe_expert_rows_total"] >= routed
    else:
        # decode's 3 tokens over 8 experts at top-2: one slot an expert
        assert c["tf_serve_moe_dropped_slots_total"] > 0
    assert tuple(port.model.moe_sums.tolist()) == tuple(
        c[f"tf_serve_moe_{n}_total"] for n in MOE_COUNTS)


def test_a_model_without_moe_layers_counts_no_moe_slots():
    tracer = Tracer(sample=1.0)
    _, port = _engines(arch="zamba2-1.2b", tracer=tracer)
    _serve(port, _prompts(seed=10))
    c = port.metrics.snapshot()["counters"]
    assert port.batches == 2 and port.model.moe_sums is None
    assert [c[f"tf_serve_moe_{n}_total"] for n in MOE_COUNTS] == [0] * 5
    assert not any(k.startswith("moe_") for sp in tracer.collector.spans for k in sp)


def test_serve_launcher_dumps_the_engines_counters_and_spans(tmp_path, monkeypatch, capsys):
    """``launch/serve.py --metrics-dump`` carries the engine's counters and
    ``--trace-dump`` writes its spans as JSON lines."""
    import json

    from repro_torch.launch import serve

    prefix, path = str(tmp_path / "serve"), str(tmp_path / "spans.jsonl")
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", "llama3.2-3b", "--smoke", "--device", "cpu", "--requests", "4",
        "--max-batch", "2", "--max-new-tokens", "2", "--metrics-dump", prefix,
        "--trace-dump", path])
    serve.main()
    assert "served 4 requests in 2 batches" in capsys.readouterr().out
    counters = json.loads(open(prefix + ".json").read())["counters"]
    # the launcher's prompts are 3 tokens each: no padding
    assert {k: counters[k] for k in ("tf_serve_requests_total", "tf_serve_batches_total",
                                     "tf_serve_prompt_tokens_total",
                                     "tf_serve_pad_tokens_total")} == {
        "tf_serve_requests_total": 4, "tf_serve_batches_total": 2,
        "tf_serve_prompt_tokens_total": 12, "tf_serve_pad_tokens_total": 0}
    assert "tf_serve_requests_total 4" in open(prefix + ".prom").read()
    names = sorted(json.loads(line)["name"] for line in open(path))
    assert names == ["serve.batch"] * 2 + ["serve.decode"] * 4 + ["serve.prefill"] * 2 \
        + ["serve.request"] * 4
