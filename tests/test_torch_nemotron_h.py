"""Nemotron-H's published forms in the port, each against a plain loop
written here, on the CPU: the sigmoid router with its correction bias;
Mamba2's groups, conv over [x, B, C] and gate before a grouped norm; the
grouped SSD scan and decode step; relu² experts; and the nemotron_h family
built from its layer pattern, served through the engine."""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_scan_recurrence, ssd_scan_torch
from repro_torch.models import Model, moe, ssm

F32 = torch.float32


# -------------------------------------------------------------- routing ----
def _route_loop(s, bias, k, norm, scale):
    """NemotronHTopkRouter token by token: the top k of s + bias, ties to
    the lower index, weighted by s, normalised with + 1e-20, × scale."""
    weights, experts = [], []
    for row in s.tolist():
        choice = [v + b for v, b in zip(row, bias.tolist())]
        top = sorted(range(len(row)), key=lambda e: (-choice[e], e))[:k]
        w = [row[e] for e in top]
        if norm:
            total = sum(w) + 1e-20
            w = [x / total for x in w]
        weights.append([x * scale for x in w])
        experts.append(top)
    return torch.tensor(weights), torch.tensor(experts)


@pytest.mark.parametrize("norm", [True, False])
def test_sigmoid_rule_matches_the_loop(norm):
    g = torch.Generator().manual_seed(0)
    s = torch.sigmoid(torch.randn(64, 16, generator=g))
    bias = torch.randn(16, generator=g) * 0.05
    rule = moe.Rule(norm_topk_prob=norm, routed_scaling_factor=2.5, scoring="sigmoid")
    top_p, top_e = moe._top_k(s, 6, rule, bias)
    want_p, want_e = _route_loop(s, bias, 6, norm, 2.5)
    assert torch.equal(top_e, want_e)
    assert torch.allclose(top_p, want_p, rtol=1e-6, atol=0)


def test_the_bias_changes_the_choice_but_not_the_weight():
    """A bias that lifts expert 3 above expert 0 makes it chosen, weighted
    by its own score; its bias does not enter the weights."""
    s = torch.tensor([[0.9, 0.8, 0.7, 0.1]])
    rule = moe.Rule(norm_topk_prob=False, routed_scaling_factor=1.0, scoring="sigmoid")
    top_p, top_e = moe._top_k(s, 2, rule, torch.tensor([0.0, 0.0, 0.0, 1.0]))
    assert top_e.tolist() == [[3, 0]]
    assert torch.equal(top_p, torch.tensor([[0.1, 0.9]]))
    top_p, top_e = moe._top_k(s, 2, rule, None)
    assert top_e.tolist() == [[0, 1]]


def test_ties_go_to_the_lower_index_and_weights_sum_to_the_scale():
    s = torch.full((3, 8), 0.5)
    rule = moe.Rule(norm_topk_prob=True, routed_scaling_factor=2.5, scoring="sigmoid")
    top_p, top_e = moe._top_k(s, 6, rule, torch.zeros(8))
    assert top_e.tolist() == [list(range(6))] * 3
    assert torch.allclose(top_p.sum(-1), torch.full((3,), 2.5))
    # + 1e-20 keeps all-zero scores finite
    top_p, _ = moe._top_k(torch.zeros(1, 8), 6, rule, torch.zeros(8))
    assert torch.equal(top_p, torch.zeros(1, 6))


def test_sigmoid_over_groups_and_unknown_scores_raise():
    with pytest.raises(ValueError, match="n_group"):
        moe.Rule(n_group=8, topk_group=4, scoring="sigmoid")
    moe.Rule(n_group=1, topk_group=1, scoring="sigmoid")
    with pytest.raises(ValueError, match="sigmoid"):
        moe.Rule(scoring="tanh")


@pytest.mark.parametrize("ragged", [False, True], ids=["capacity", "ragged"])
def test_relu2_experts_hold_no_gate_and_compute_the_ungated_mlp(ragged):
    layer = moe.MoE(torch.Generator().manual_seed(1), 16, 8, 4, n_shared=1, device="cpu",
                    act="relu2", score_bias=True, d_ff_shared=12)
    assert layer.wg is None and layer.shared.wg is None
    assert layer.shared.wu.shape == (16, 12) and layer.e_score_correction_bias.shape == (4,)
    x = torch.randn(1, 5, 16, generator=torch.Generator().manual_seed(2))
    out, _ = moe.moe_forward(layer, x, 2, None, rule=moe.Rule(scoring="sigmoid"),
                             ragged=ragged)
    xf = x.reshape(5, 16)
    s = torch.sigmoid(xf @ layer.router.float())
    w, e = _route_loop(s, layer.e_score_correction_bias.float(), 2, True, 1.0)
    want = torch.zeros(5, 16)
    for t in range(5):
        for j in range(2):
            h = F.relu(xf[t] @ layer.wu[e[t, j]].float()) ** 2
            want[t] += w[t, j] * (h @ layer.wd[e[t, j]].float())
    want += (F.relu(xf @ layer.shared.wu.float()) ** 2) @ layer.shared.wd.float()
    assert torch.allclose(out.reshape(5, 16), want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- Mamba2 ----
def _mamba_loop(p, u):
    """The published mixer token by token in fp32 (NemotronHMamba2Mixer's
    torch path): [x, B, C] through the causal conv with bias and SiLU, the
    recurrence per head over its group's B and C, D's skip, the gate, an
    RMSNorm over each group, the output projection."""
    f = {n: t.float() for n, t in p.named_parameters()}
    b, L, _ = u.shape
    G = p.n_groups
    H = f["a_log"].shape[0]
    Di = f["wx"].shape[1]
    N = f["wB"].shape[1] // G
    P = Di // H
    raw = torch.cat([u @ f["wx"], u @ f["wB"], u @ f["wC"]], -1)
    W = f["conv_w"].shape[0]
    a = -torch.exp(f["a_log"])
    h = torch.zeros(b, H, N, P)
    outs = []
    for t in range(L):
        window = [raw[:, t - W + 1 + i] if t - W + 1 + i >= 0 else torch.zeros_like(raw[:, 0])
                  for i in range(W)]
        c = F.silu(sum(wi * f["conv_w"][i] for i, wi in enumerate(window)) + f["conv_b"])
        x, Bm, Cm = c[:, :Di].reshape(b, H, P), c[:, Di:Di + G * N], c[:, Di + G * N:]
        dt = F.softplus(u[:, t] @ f["wdt"] + f["dt_bias"])
        y = torch.zeros(b, H, P)
        for hd in range(H):
            g = hd // (H // G)
            Bg, Cg = Bm[:, g * N:(g + 1) * N], Cm[:, g * N:(g + 1) * N]
            h[:, hd] = torch.exp(dt[:, hd] * a[hd])[:, None, None] * h[:, hd] \
                + dt[:, hd, None, None] * Bg[:, :, None] * x[:, hd, None, :]
            y[:, hd] = torch.einsum("bn,bnp->bp", Cg, h[:, hd]) + f["d_skip"][hd] * x[:, hd]
        gated = (y.reshape(b, Di) * F.silu(u[:, t] @ f["wz"])).reshape(b, G, Di // G)
        normed = gated * torch.rsqrt((gated ** 2).mean(-1, keepdim=True) + p.out_norm.eps)
        outs.append((normed.reshape(b, Di) * f["out_norm.w"]) @ f["wo"])
    return torch.stack(outs, 1), h


def _mamba(seed, G=2):
    p = ssm.Mamba2(torch.Generator().manual_seed(seed), 32, 64, 8, headdim=8, device="cpu",
                   n_groups=G, conv_bc=True, gate_norm_groups=True)
    with torch.no_grad():      # non-trivial bias, skip and norm weight
        g = torch.Generator().manual_seed(seed + 1)
        p.conv_b.copy_(torch.randn(p.conv_b.shape, generator=g) * 0.1)
        p.d_skip.copy_(torch.rand(p.d_skip.shape, generator=g) + 0.5)
        p.out_norm.w.copy_(torch.rand(p.out_norm.w.shape, generator=g) + 0.5)
        p.a_log.copy_(torch.randn(p.a_log.shape, generator=g) * 0.5)
    return p


@pytest.mark.parametrize("G", [1, 2, 4])
def test_mamba2_options_against_the_token_loop(G):
    """The full-sequence path (the chunked scan, over 3 chunks of 16) and
    then decode steps through the cache it leaves, against the token loop:
    fp32 on both sides, the sums' order alone differs."""
    p = _mamba(3, G)
    u = torch.randn(2, 40, 32, generator=torch.Generator().manual_seed(4))
    want, want_h = _mamba_loop(p, u)
    out, (state, conv) = ssm.mamba2_forward(p, u[:, :36], chunk=16, return_state=True)
    assert conv.shape == (2, 3, 64 + 2 * G * 8)
    tol = 1e-5 * (1 + want.abs().max().item())
    assert (out - want[:, :36]).abs().max().item() <= tol
    state, conv = state.clone(), conv.clone()
    for t in range(36, 40):
        step, _, _ = ssm.mamba2_decode(p, u[:, t:t + 1], state, conv)
        assert (step[:, 0] - want[:, t]).abs().max().item() <= tol
    assert (state - want_h).abs().max().item() <= 1e-5 * (1 + want_h.abs().max().item())


def test_mamba2_defaults_are_the_reference_form():
    """Off, the options leave zamba2's mixer as it was: the conv over x
    alone, one group, the norm before the gate."""
    p = ssm.Mamba2(torch.Generator().manual_seed(0), 32, 64, 8, headdim=8, device="cpu")
    assert (p.n_groups, p.conv_bc, p.gate_norm_groups) == (1, False, False)
    assert p.conv_w.shape == (4, 64) and p.wB.shape == (32, 8)
    y, z = torch.randn(3, 64), torch.randn(3, 64)
    from repro_torch.models.layers import rms_norm

    assert torch.equal(ssm._out(p, y, z), rms_norm(y, p.out_norm.w, p.out_norm.eps) * F.silu(z))


# ------------------------------------------------------------ the scan ----
def _grouped_inputs(B, S, H, G, P, N, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(B, S, H, P, generator=g) * 0.5).to(dtype)
    dt = F.softplus(torch.randn(B, S, H, generator=g))
    Bm, Cm = ((torch.randn(B, S, G, N, generator=g) * 0.5).to(dtype) for _ in "BC")
    a = -torch.exp(torch.randn(H, generator=g) * 0.3)
    return x, dt, Bm, Cm, a


def test_grouped_scan_is_the_sum_of_two_halves_of_n():
    """The N 128 route's oracle: the scan is separable over N (y sums
    C_n·h_n; each n's state is its own), so N 128 in 8 groups is the sum of
    the two N 64 halves' y and the concatenation of their states.  The sm90
    route's plain version (bf16, P 64) on every side: y within two bf16
    roundings of the halves' sum, the fp32 states within 1e-5."""
    x, dt, Bm, Cm, a = _grouped_inputs(1, 200, 16, 2, 64, 128, torch.bfloat16, 0)
    assert ssd_ops.route(x, Bm) == "sm90" == ssd_ops.route(x, Bm[..., :64])
    y, state = ssd_ops.ssd(x, dt, Bm, Cm, a, chunk=128)
    y1, s1 = ssd_ops.ssd(x, dt, Bm[..., :64], Cm[..., :64], a, chunk=128)
    y2, s2 = ssd_ops.ssd(x, dt, Bm[..., 64:], Cm[..., 64:], a, chunk=128)
    halves = y1.float() + y2.float()
    tol = 2.0 ** -7 * (y1.float().abs() + y2.float().abs() + y.float().abs()) + 1e-4
    assert ((y.float() - halves).abs() <= tol).all()
    assert (state - torch.cat([s1, s2], 2)).abs().max().item() <= 1e-5 * state.abs().max()


def test_grouped_scan_against_the_recurrence():
    """fp32 through the scalar route's plain version, 4 heads in 2 groups,
    against the time recurrence with each head given its group's B and C."""
    x, dt, Bm, Cm, a = _grouped_inputs(2, 50, 4, 2, 8, 16, F32, 1)
    y, state = ssd_ops.ssd(x, dt, Bm, Cm, a, chunk=16)
    want_y, want_h = ssd_scan_recurrence(x, dt, Bm, Cm, a)
    for g in range(2):
        hy, hh = ssd_scan_recurrence(x[:, :, 2 * g:2 * g + 2], dt[:, :, 2 * g:2 * g + 2],
                                     Bm[:, :, g], Cm[:, :, g], a[2 * g:2 * g + 2])
        assert torch.equal(want_y[:, :, 2 * g:2 * g + 2], hy)
        assert torch.equal(want_h[:, 2 * g:2 * g + 2], hh)
    assert torch.allclose(y, want_y, rtol=1e-4, atol=1e-5)
    assert torch.allclose(state, want_h, rtol=1e-4, atol=1e-5)
    # one group is the shared [B,S,N] layout, bit for bit
    y1, s1 = ssd_scan_torch(x, dt, Bm[:, :, :1], Cm[:, :, :1], a, 16)
    y0, s0 = ssd_scan_torch(x, dt, Bm[:, :, 0], Cm[:, :, 0], a, 16)
    assert torch.equal(y1, y0) and torch.equal(s1, s0)


def test_grouped_step_is_each_group_apart():
    g = torch.Generator().manual_seed(2)
    B, H, G, N, P = 3, 8, 4, 16, 8
    state = torch.randn(B, H, N, P, generator=g)
    x = torch.randn(B, H, P, generator=g).bfloat16()
    dt = F.softplus(torch.randn(B, H, generator=g))
    a = -torch.exp(torch.randn(H, generator=g))
    Bm, Cm = (torch.randn(B, G, N, generator=g) for _ in "BC")
    d_skip = torch.randn(H, generator=g)
    got_state = state.clone()
    y = ssd_ops.ssd_step(got_state, x, dt, a, Bm, Cm, d_skip)
    hpg = H // G
    for k in range(G):
        hs = slice(k * hpg, (k + 1) * hpg)
        want_state = state[:, hs].clone()
        want = ssd_ops.ssd_step_plain(want_state, x[:, hs], dt[:, hs], a[hs], Bm[:, k],
                                      Cm[:, k], d_skip[hs])
        assert torch.allclose(got_state[:, hs], want_state, rtol=1e-6, atol=1e-6)
        assert torch.allclose(y[:, hs].float(), want.float(), rtol=2 ** -7, atol=1e-5)
    with pytest.raises(ValueError, match="do not agree"):
        ssd_ops.ssd_step(state.clone(), x, dt, a, Bm[:, :3], Cm[:, :3], d_skip)


# --------------------------------------------------------------- family ----
def test_the_family_is_built_from_its_pattern():
    cfg = get_config("nemotron-3-nano-30b-a3b")
    assert cfg.layer_pattern.count("M") == 23 == cfg.layer_pattern.count("E")
    assert [i for i, k in enumerate(cfg.layer_pattern) if k == "*"] == [5, 12, 19, 26, 33, 42]
    assert cfg.param_count() == 31_577_940_288
    model = Model(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    lay = model.layers
    assert lay[0].mamba.wB.shape == (2688, 1024) and lay[0].mamba.conv_w.shape == (4, 6144)
    assert lay[1].moe.wu.shape == (128, 2688, 1856) and lay[1].moe.wg is None
    assert lay[1].moe.shared.wu.shape == (2688, 3712)
    assert lay[5].attn.wk.shape == (2688, 2, 128) and lay[5].mamba is lay[5].moe is None
    layout = model.cache_layout(8, 4100)
    assert layout["ssm"][0] == (23, 8, 64, 128, 64) and layout["conv"][0] == (23, 8, 3, 6144)
    assert layout["k"][0] == (6, 8, 4100, 2, 128)
    for bad in ("MEM-E*", "MEMX"):
        with pytest.raises(ValueError, match="layer_pattern"):
            dataclasses.replace(cfg, layer_pattern=bad, n_layers=len(bad))


def test_prefill_then_decode_match_the_forward():
    """fp32: a prefill and decode steps through the cache give the full
    forward's logits at those positions, within the sums' order; the MoE's
    running sums count k slots a position in each E block, the rows
    computed are the slots, and a step reads at most the T·k = 6 experts
    its slots chose of the 8, where C = T would read all 8."""
    cfg = dataclasses.replace(get_config("nemotron-3-nano-30b-a3b", smoke=True),
                              dtype=F32)
    model = Model(cfg, device="cpu", seed=1)
    toks = torch.randint(1, cfg.vocab, (3, 21), generator=torch.Generator().manual_seed(5))
    full, _ = model.forward({"tokens": toks})
    lg, cache = model.prefill({"tokens": toks[:, :17]}, max_len=24)
    assert (lg - full[:, 16]).abs().max().item() <= 1e-5
    for t in range(17, 21):
        lg, cache = model.decode(cache, {"tokens": toks[:, t:t + 1]})
        assert (lg - full[:, t]).abs().max().item() <= 1e-5 * (1 + full.abs().max().item())
    routed, held, rows, dropped, read = model.moe_sums.tolist()
    n_e = cfg.layer_pattern.count("E")
    assert routed == held == cfg.top_k * n_e * 3 * 21 and dropped == 0
    assert rows == held and cfg.n_experts > 3 * cfg.top_k
    # an E block's prefill reads at most every expert, each of its 4 steps
    # at most 6, and every call at least one
    assert n_e * 5 <= read <= n_e * (cfg.n_experts + 4 * 3 * cfg.top_k)


def test_the_engine_counts_k_slots_a_real_position_in_each_e_block():
    """The smoke model served through ``ServingEngine`` with the left pads
    unrouted: the routed slots are k × (the pattern's E blocks) × the
    positions that are no pad (each prompt's own tokens and 3 decode steps a
    request), every one held, and dropless drops none; the prefill spans
    carry their own share."""
    from repro_torch.core import Triggerflow
    from repro_torch.obs.trace import Tracer
    from repro_torch.serving.engine import ServingEngine

    cfg = dataclasses.replace(get_config("nemotron-3-nano-30b-a3b", smoke=True),
                              dtype=F32, unrouted_pad=0)
    tracer = Tracer(sample=1.0)
    eng = ServingEngine(cfg, Triggerflow(inline_functions=True, device="cpu"), "srv-nemo",
                        max_batch=3, max_new_tokens=3, max_len=48, tracer=tracer)
    g = torch.Generator().manual_seed(9)
    prompts = [torch.randint(1, cfg.vocab, (n,), generator=g).tolist()
               for n in (5, 11, 8, 3, 9, 14)]
    eng.deploy()
    for i, p in enumerate(prompts):
        eng.submit(f"r{i}", p)
    w = eng.tf.worker(eng.workflow)
    for _ in range(30):
        w.run_once()
    done = [e for e in w.event_log if e.subject.startswith("serve|done|")]
    assert len(done) == 6 and all(len(e.data["result"]["tokens"]) == 3 for e in done)
    c = eng.metrics.snapshot()["counters"]
    per_position = cfg.top_k * cfg.layer_pattern.count("E")
    routed = per_position * (sum(map(len, prompts)) + 3 * len(prompts))
    assert c["tf_serve_moe_routed_slots_total"] == c["tf_serve_moe_held_slots_total"] == routed
    assert c["tf_serve_moe_dropped_slots_total"] == 0
    prefills = [sp for sp in tracer.collector.spans if sp["name"] == "serve.prefill"]
    assert sum(sp["moe_routed_slots"] for sp in prefills) == per_position * sum(map(len, prompts))
