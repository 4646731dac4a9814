"""The mla_moe family (DeepSeek-V2 on one chip's share of its expert
layers) on the CPU: the plain reference against the port's own path, the
family's counts against hand counts at the configuration's sizes, the
harness serving the family's small configuration to ``correct``, and the
check failing where the program departs from the published model."""
import dataclasses
import json
import time

import pytest
import torch

from benchlib import harness, smoke, weights
from benchlib.spec import BENCH, Spec, load
from reference import mla_moe as ref

CPU = torch.device("cpu")
CELL = "deepseek-v2-236b.longprompt"
FAMILY = load(BENCH, "families", "mla_moe")


def _conf():
    return json.loads((BENCH / "configs" / "deepseek-v2-236b.json").read_text())


def _served(model, prompts, steps):
    """Greedy serving as the engine does it: left-pad with 0, prefill, then
    ``steps`` decode steps through the latent cache → (padded S, tokens
    [B, steps + 1], logits [B, steps + 1, V] of every served token)."""
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
    """Prefill, then decode through the absorbed form and the latent cache,
    against the reference's full forward at logits (fp32 on both sides:
    the sums' order alone differs)."""
    conf = smoke.config("mla_moe")
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
    # the slots routed (the pads take none), held here, the rows computed;
    # dropless drops none
    routed, held, rows, dropped = model.moe_counts.tolist()
    assert routed == 2 * 6 * (sum(lengths) + 4 * len(lengths)) and 0 < held < routed
    assert rows >= held and dropped == 0


def test_the_configuration_is_published_deepseek_v2_on_one_chips_share():
    conf = _conf()
    cfg = FAMILY.model_config(conf)
    assert (cfg.d_model, cfg.n_heads, cfg.q_lora, cfg.kv_lora) == (5120, 128, 1536, 512)
    assert (cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim) == (128, 64, 128)
    assert (cfg.n_experts, cfg.top_k, cfg.n_group, cfg.topk_group) == (160, 6, 8, 3)
    assert (cfg.d_ff_expert, cfg.n_shared_experts, cfg.d_ff) == (1536, 2, 12288)
    assert not cfg.norm_topk_prob and cfg.routed_scaling_factor == 16.0
    assert cfg.capacity_factor is None and cfg.experts_held == (0, 20)
    assert cfg.rms_eps == 1e-6 and cfg.rope_scaling.factor == 40.0
    assert cfg.n_layers == 12
    # layer 0 (MLA, its dense MLP, two norms), 11 MoE layers (MLA, router,
    # 20 held experts, 2 shared), the embedding, head and final norm
    mla = 149_225_472 + 1536 + 512
    layer0 = mla + 188_743_680 + 2 * 5120
    moe = mla + 2 * 5120 + 819_200 + 20 * 23_592_960 + 47_185_920
    assert cfg.param_count() == layer0 + 11 * moe + 1_048_581_120 == 8_746_685_440
    from repro_torch.models import Model

    model = Model(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    assert model.layers[0].moe.wg.shape == (20, 5120, 1536)
    assert model.layers[0].moe.router.shape == (5120, 160)


def test_kernel_calls_and_flops_against_hand_counts():
    conf = _conf()
    assert FAMILY.kernel_calls(conf, 8, 4096) == {"k2": [(8, 4096, 128, 192, 128)] * 12,
                                                  "k3": []}
    # a token: 12 × MLA's 149,225,472 multiply-adds, layer 0's MLP
    # 188,743,680, and 11 × (router 819,200 + shared 47,185,920 + the
    # routed experts at 6 · 20/160 of 23,592,960 = 17,694,720), × 2
    token = 2 * (12 * 149_225_472 + 188_743_680 + 11 * (819_200 + 47_185_920 + 17_694_720))
    assert token == 5_404_295_168
    k2 = 2 * 8 * 128 * (192 + 128) * 4096 * 4097 // 2
    unembed = 2 * 8 * 5120 * 102400
    assert FAMILY.prefill_flops(conf, 8, 4096) == 8 * 4096 * token + 12 * k2 + unembed
    # decode at pos 4099: per layer and head, scores over 512 + 64 and the
    # context over 512, at 4100 positions
    assert FAMILY.decode_flops(conf, 8, 4099) == (
        8 * (token + 12 * 2 * 128 * 4100 * (2 * 512 + 64)) + unembed)


def test_model_config_raises_where_the_port_cannot_run_the_file():
    for key, value in (("topk_method", "noaux_tc"), ("scoring_func", "sigmoid"),
                       ("first_k_dense_replace", 3), ("intermediate_size", 10944)):
        with pytest.raises(ValueError, match=key):
            FAMILY.model_config({**_conf(), key: value})


def _run(seed, trace_on=False, on_engine=None, limits=None, check_tokens=8):
    mix = smoke.mix("longprompt", check_tokens=check_tokens)
    settings = {"limits": limits or {"served_logit_gap_mean": 0.05}}
    return harness.run_cell(Spec(), CELL, seed, 2.0, trace_on, CPU, time.perf_counter(),
                            conf=smoke.config("mla_moe"), mix=mix, on_engine=on_engine,
                            settings=settings)


@pytest.mark.parametrize("trace_on", [False, True])
def test_the_harness_serves_the_family_to_correct(trace_on):
    """bf16 serving of the small configuration through the whole path.  Its
    mean gap reads 0-0.012 over eight seeds, the fp8 control's 0.08-0.12."""
    res = _run(2**31 + 21, trace_on)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    if trace_on:
        # on the CPU the device trace's readers find nothing
        assert set(res["metrics"]) == {
            "fire_lag_ms.longprompt", "prefill_us_per_token.longprompt",
            "step_mfu.longprompt"}
    else:
        assert set(res["metrics"]) == {"tokens_per_s", "request_p95_ms.longprompt",
                                       "setup_s"}


@pytest.mark.parametrize("change", [
    {},
    {"norm_topk_prob": True, "routed_scaling_factor": 1.0},    # renormalised top-k
    {"n_group": 0, "topk_group": 0},                           # greedy over all experts
    {"rope_scaling": None},                                    # plain RoPE
    {"capacity_factor": 1.25}])                                # capacity drops slots
def test_a_departure_from_the_published_model_is_not_correct(change):
    """The program in fp32, where it agrees with the reference to the
    order of its sums and every gap reads 0 at this seed; each departure
    reads 0.76-1.9 here."""
    served = {}

    def plant(eng):
        eng.model.cfg = dataclasses.replace(eng.model.cfg, dtype=torch.float32, **change)
        served["eng"] = eng

    res = _run(2**31 + 21, on_engine=plant, limits={"served_logit_gap_max": 0.3},
               check_tokens=48)
    assert res["correct"] == (not change)
    if change:
        assert res["compared"]["served_logit_gap_max"]["value"] > 0.3
    dropped = served["eng"].metrics.snapshot()["counters"]["tf_serve_moe_dropped_slots_total"]
    assert (dropped > 0) == ("capacity_factor" in change)
