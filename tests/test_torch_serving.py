"""The slice as a whole: trigger-batched serving in the port against the
JAX package's engine, on the CPU.

Both engines serve the llama3.2-3b smoke config, the zamba2-1.2b (hybrid)
smoke config, and those of phi3.5-moe (moe), qwen2-vl-72b (vlm) and
deepseek-v2 (mla_moe), in fp32 with the same weights (the port loads the
reference's through ``params_from_jax``), six requests with seeded prompt
lengths, three to a batch.  Greedy tokens are integers: they must be
identical per request id.
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
from repro_torch.serving.engine import ServingEngine


def _prompts(seed=0, n=6, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, int(rng.integers(5, 41))).tolist() for _ in range(n)]


def _engines(wf_ref="srv", wf_port="srv", arch="llama3.2-3b"):
    ref = RefServingEngine(
        dataclasses.replace(jax_get_config(arch, smoke=True), dtype=jnp.float32),
        RefTriggerflow(inline_functions=True), wf_ref,
        max_batch=3, max_new_tokens=3, max_len=48)
    port = ServingEngine(
        dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32),
        Triggerflow(inline_functions=True, device="cpu"), wf_port,
        max_batch=3, max_new_tokens=3, max_len=48)
    port.model.load_state_dict(params_from_jax(jax.device_get(ref.params)), strict=True)
    return ref, port


def _serve(eng, prompts):
    eng.deploy()
    for i, p in enumerate(prompts):
        eng.submit(f"r{i}", p)
    w = eng.tf.worker(eng.workflow)
    for _ in range(30):
        w.run_once()
    done = [e for e in w.event_log if e.subject.startswith("serve|done|")]
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
