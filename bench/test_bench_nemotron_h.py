"""The nemotron_h family (Nemotron 3 Nano, whole) on the CPU: the plain
reference against the port's own path, the family's counts against hand
counts at the configuration's sizes, the harness serving the family's small
configuration to ``correct``, and the check failing where the program
departs from the published model."""
import dataclasses
import json
import time

import pytest
import torch

from benchlib import harness, smoke, weights
from benchlib.counts import k3_call
from benchlib.spec import BENCH, Spec, load
from reference import nemotron_h as ref

CPU = torch.device("cpu")
CELL = "nemotron-3-nano-30b-a3b.longprompt"
FAMILY = load(BENCH, "families", "nemotron_h")


def _conf():
    return json.loads((BENCH / "configs" / "nemotron-3-nano-30b-a3b.json").read_text())


def _served(model, prompts, steps):
    """Greedy serving as the engine does it: left-pad with 0, prefill, then
    ``steps`` decode steps through the Mamba2 states, conv windows and K/V
    → (padded S, tokens [B, steps + 1], logits [B, steps + 1, V])."""
    S = max(map(len, prompts))
    toks = torch.tensor([[0] * (S - len(p)) + p for p in prompts])
    lg, cache = model.prefill({"tokens": toks}, max_len=S + steps + 1)
    outs, logits = [lg.argmax(-1)], [lg]
    for _ in range(steps):
        lg, cache = model.decode(cache, {"tokens": outs[-1][:, None]})
        outs.append(lg.argmax(-1))
        logits.append(lg)
    return S, torch.stack(outs, 1), torch.stack(logits, 1)


@pytest.mark.parametrize("lengths", [(7, 19, 12, 3), (40, 1, 33, 17)])
def test_reference_matches_the_port_in_fp32(lengths):
    """Prefill, then decode through the cache, against the reference's full
    forward at logits, fp32 on both sides: the sums' order alone differs
    (the port's chunked scan, its conv and its norms against the
    reference's), ≈ 2e-6 of logits of ≈ 4; 2e-4·(1 + max|logit|) leaves a
    hundredfold room.  The MoE's running sums: k slots a real position (the
    left pads take none) in each of the pattern's E blocks, all held, none
    dropped."""
    conf = smoke.config("nemotron_h")
    model, w = weights.build(conf, 2**31 + 3, "cpu")
    model.cfg.dtype = torch.float32
    g = torch.Generator().manual_seed(0)
    prompts = [torch.randint(1, conf["vocab_size"], (n,), generator=g).tolist()
               for n in lengths]
    S, got, port = _served(model, prompts, 4)
    seqs = torch.cat([torch.tensor([[0] * (S - len(p)) + p for p in prompts]), got[:, :-1]], 1)
    want = ref.logits(w, conf, seqs, S, list(range(S - 1, S + 4)))
    assert (want - port).abs().max().item() <= 2e-4 * (1 + want.abs().max().item())
    assert torch.equal(want.argmax(-1), got)
    routed, held, rows, dropped = model.moe_counts.tolist()
    n_e = conf["hybrid_override_pattern"].count("E")
    per_position = conf["num_experts_per_tok"] * n_e
    assert routed == held == per_position * (sum(lengths) + 4 * len(lengths))
    assert rows >= held and dropped == 0


def test_the_configuration_is_published_nemotron_3_nano_whole():
    conf = _conf()
    cfg = FAMILY.model_config(conf)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (2688, 32, 2, 128)
    assert (cfg.ssm_d_inner, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_groups) == (4096, 64, 128, 8)
    assert cfg.ssm_conv_bc and cfg.ssm_gate_norm_groups and cfg.ssm_chunk == 128
    assert (cfg.n_experts, cfg.top_k, cfg.d_ff_expert, cfg.d_ff_shared) == (128, 6, 1856, 3712)
    assert cfg.router_scoring == "sigmoid" and cfg.expert_act == "relu2"
    assert cfg.norm_topk_prob and cfg.routed_scaling_factor == 2.5
    assert cfg.capacity_factor is None and cfg.experts_held is None
    assert cfg.rms_eps == 1e-5 and cfg.vocab == 131072 and cfg.n_layers == 52
    assert cfg.layer_pattern == conf["hybrid_override_pattern"] and not conf["reduced"]
    # a Mamba2 block: its norm, wz/wx/wo, the conv over 4096 + 2·1024
    # channels with bias, out_norm, wB/wC of 8 groups of 128, wdt, dt_bias,
    # a_log, d_skip; an MoE block: its norm, the router and its correction
    # bias, 128 experts of up and down, the shared expert's; an attention
    # block: its norm and q, k, v, o
    mamba = 2688 + 3 * 2688 * 4096 + 5 * 6144 + 4096 + 2 * 2688 * 1024 + 2688 * 64 + 3 * 64
    moe = 2688 + 2688 * 128 + 128 + 128 * 2 * 2688 * 1856 + 2 * 2688 * 3712
    attn = 2688 + 2688 * 128 * (2 * 32 + 2 * 2)
    outer = 2 * 131072 * 2688 + 2688
    assert cfg.param_count() == 23 * (mamba + moe) + 6 * attn + outer == 31_577_940_288
    from repro_torch.models import Model

    model = Model(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()


def test_kernel_calls_and_flops_against_hand_counts():
    conf = _conf()
    calls = FAMILY.kernel_calls(conf, 8, 4096)
    assert calls["k2"] == [(8, 4096, 32, 128, 128)] * 6
    # 23 Mamba2 scans, each 8 groups of 8 heads reading their group's B, C:
    # a group as one head 8·64 wide and the other 7 heads' dt and a
    assert calls["k3"] == [(8, 4096, 1, 512, 128, 128), (8, 4096, 7, 0, 0, 128)] * (8 * 23)
    # the group's own counts: C·Bᵀ once for its 8 heads, the rest a head;
    # x and y of 8 heads, dt of 8, B and C once, 8 heads' fp32 state, a
    ops = sum(k3_call(*c)[0] for c in calls["k3"][:2])
    n_bytes = sum(k3_call(*c)[1] for c in calls["k3"][:2])
    assert ops == 8 * 32 * 2 * (128 * 129 // 2 * (128 + 8 * 64) + 8 * 2 * 128 * 128 * 64)
    assert n_bytes == (2 * 2 * 8 * 4096 * 8 * 64 + 4 * 8 * 4096 * 8 + 2 * 2 * 8 * 4096 * 128
                       + 4 * 8 * 8 * 128 * 64 + 4 * 8)
    # a token: 23 × Mamba2 (z, x 2·2688·4096; B, C 2·2688·1024; dt 2688·64;
    # out 4096·2688; the conv 4·6144), 23 × MoE (router 2688·128, 6 routed
    # experts 2·2688·1856, the shared 2·2688·3712), 6 × attention 2688·128·68
    mamba = 2 * (2 * 2688 * 4096 + 2 * 2688 * 1024 + 2688 * 64 + 4096 * 2688) + 2 * 4 * 6144
    moe = 2 * (2688 * 128 + 6 * 2 * 2688 * 1856 + 2 * 2688 * 3712)
    attn = 2 * 2688 * 128 * 68
    token = 23 * (mamba + moe) + 6 * attn
    assert token == 5_750_095_872
    # the scan: per group and chunk of 128, C·Bᵀ once and M·x of 8 heads
    # over the causal pairs, C·h and the state update of 8 heads, at N 128,
    # P 64
    chunk = 2 * (128 * 129 // 2 * (128 + 8 * 64) + 8 * 2 * 128 * 128 * 64)
    scan = 23 * 8 * 8 * 32 * chunk
    k2 = 2 * 8 * 32 * 256 * 4096 * 4097 // 2
    unembed = 2 * 8 * 2688 * 131072
    assert FAMILY.prefill_flops(conf, 8, 4096) == 8 * 4096 * token + 6 * k2 + scan + unembed
    assert FAMILY.decode_flops(conf, 8, 4099) == 8 * (
        token + 23 * 4 * 64 * 128 * 64 + 6 * 4 * 32 * 128 * 4100) + unembed


def test_model_config_raises_where_the_port_cannot_run_the_file():
    for key, value in (("mlp_hidden_act", "silu"), ("n_group", 8), ("conv_kernel", 3),
                       ("residual_in_fp32", True), ("num_hidden_layers", 51)):
        with pytest.raises(ValueError, match=key):
            FAMILY.model_config({**_conf(), key: value})


def _run(seed, trace_on=False, on_engine=None, limits=None, check_tokens=24):
    mix = smoke.mix("longprompt", check_tokens=check_tokens)
    settings = {"limits": limits or {"served_logit_gap_mean": 0.05}}
    return harness.run_cell(Spec(), CELL, seed, 2.0, trace_on, CPU, time.perf_counter(),
                            conf=smoke.config("nemotron_h"), mix=mix, on_engine=on_engine,
                            settings=settings)


@pytest.mark.parametrize("trace_on", [False, True])
def test_the_harness_serves_the_family_to_correct(trace_on):
    """bf16 serving of the small configuration through the whole path.  Over
    six seeds at 24 compared tokens its mean gap read 0-0.0152 (one near-tie
    flip of 0.36 among the 24), the fp8 control's 0.009-0.044."""
    res = _run(2**31 + 22, trace_on)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    if trace_on:
        # on the CPU the device trace's readers find nothing
        assert set(res["metrics"]) == {
            "fire_lag_ms.longprompt", "prefill_us_per_token.longprompt",
            "step_mfu.longprompt"}
    else:
        assert set(res["metrics"]) == {"tokens_per_s", "request_p95_ms.longprompt",
                                       "setup_s"}


def _norm_before_gate(eng):
    for lp in eng.model.layers:
        if lp.mamba is not None:
            lp.mamba.gate_norm_groups = False          # zamba2's form


def _unbiased(eng):
    for lp in eng.model.layers:
        if lp.moe is not None:
            lp.moe.e_score_correction_bias = None      # choose by s alone


def _with_rope(monkeypatch):
    """RoPE on q and k in the attention blocks (θ 10000, the config's
    unread rope_theta)."""
    from repro_torch.models import layers as L

    forward, decode = L.gqa_forward, L.gqa_decode

    def gqa_forward(p, x, cos, sin, *args, **kwargs):
        if cos is None:
            cos, sin = L.rope_angles(torch.arange(x.shape[1], device=x.device),
                                     p.wq.shape[-1])
        return forward(p, x, cos, sin, *args, **kwargs)

    def gqa_decode(p, x, ck, cv, pos, cos, sin):
        if cos is None:
            at = torch.as_tensor(pos, device=x.device).expand(x.shape[0], 1)
            cos, sin = L.rope_angles(at, p.wq.shape[-1])
        return decode(p, x, ck, cv, pos, cos, sin)

    monkeypatch.setattr(L, "gqa_forward", gqa_forward)
    monkeypatch.setattr(L, "gqa_decode", gqa_decode)


@pytest.mark.parametrize("change", [None, "norm_before_gate", "unbiased", "rope"])
def test_a_departure_from_the_published_model_is_not_correct(change, monkeypatch):
    """The program in fp32, where it agrees with the reference to the order
    of its sums and every gap reads 0 at this seed; the departures' widest
    gaps read 2.61 (the norm before the gate), 0.34 (the experts chosen by s
    alone) and 0.35 (RoPE) here."""
    def plant(eng):
        eng.model.cfg = dataclasses.replace(eng.model.cfg, dtype=torch.float32)
        if change == "norm_before_gate":
            _norm_before_gate(eng)
        elif change == "unbiased":
            _unbiased(eng)

    if change == "rope":
        _with_rope(monkeypatch)
    res = _run(2**31 + 21, on_engine=plant, limits={"served_logit_gap_max": 0.1},
               check_tokens=48)
    assert res["correct"] == (change is None)
    if change:
        assert res["compared"]["served_logit_gap_max"]["value"] > 0.1
