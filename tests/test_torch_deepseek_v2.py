"""DeepSeek-V2's published forms in the port, each against a plain loop
written here, on the CPU: group-limited routing with unnormalised, scaled
gates; YaRN's frequencies and softmax factor; ``rms_eps`` in every norm;
one chip's share of the routed experts; the dropless capacity; and the
defaults, which still compute the JAX package's function bit for bit."""
import dataclasses
import math

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import Model, layers, mla, moe
from repro_torch.models.layers import RMSNorm, YaRN

DEEPSEEK_YARN = YaRN(factor=40, original_max_position_embeddings=4096, beta_fast=32,
                     beta_slow=1, mscale=0.707, mscale_all_dim=0.707)


# -------------------------------------------------------------- routing ----
def _route_loop(probs, k, n_group, topk_group, norm, scale):
    """MoEGate's rule token by token: groups ranked by their best
    probability, the top ``topk_group`` kept, the top k of their experts
    taken; ties to the lower index."""
    T, E = probs.shape
    weights, experts = [], []
    for p in probs.tolist():
        if n_group:
            size = E // n_group
            best = [max(p[g * size:(g + 1) * size]) for g in range(n_group)]
            groups = sorted(range(n_group), key=lambda g: (-best[g], g))[:topk_group]
            cand = [e for g in sorted(groups) for e in range(g * size, (g + 1) * size)]
        else:
            cand = list(range(E))
        top = sorted(cand, key=lambda e: (-p[e], e))[:k]
        w = [p[e] for e in top]
        if norm:
            w = [x / sum(w) for x in w]
        weights.append([x * scale for x in w])
        experts.append(top)
    return torch.tensor(weights), torch.tensor(experts)


def _probs_with_ties():
    """16 experts in 4 groups: token 0's best six span all four groups,
    token 1 ties groups 1 and 2 on their best and experts within them."""
    g = torch.Generator().manual_seed(3)
    p = torch.rand(4, 16, generator=g)
    p[0] = torch.tensor([.9, .1, .1, .1, .8, .1, .1, .1, .7, .1, .1, .1, .6, .5, .4, .3])
    p[1] = torch.tensor([.2, .1, .1, .1, .5, .5, .1, .1, .5, .3, .3, .1, .4, .1, .1, .1])
    return p / p.sum(-1, keepdim=True)


@pytest.mark.parametrize("norm,scale", [(False, 16.0), (True, 1.0), (False, 1.0)])
def test_group_limited_routing_against_the_loop(norm, scale):
    probs = _probs_with_ties()
    got_p, got_e = moe._top_k(probs, 6, moe.Rule(4, 2, norm, scale))
    want_p, want_e = _route_loop(probs, 6, 4, 2, norm, scale)
    assert torch.equal(got_e, want_e)
    torch.testing.assert_close(got_p, want_p, rtol=1e-6, atol=0)
    # token 0: greedy over all would take experts of groups 0-3; the rule
    # keeps groups 0 and 1 (best 0.9 and 0.8) and takes six of their eight
    greedy = moe._top_k(probs, 6)[1]
    assert set(greedy[0].tolist()) == {0, 4, 8, 12, 13, 14}
    assert got_e[0].tolist() == [0, 4, 1, 2, 3, 5]
    # token 1: groups 1 and 2 tie at 0.5, both kept; 4, 5 and 8 tie and
    # come in index order
    assert got_e[1].tolist()[:3] == [4, 5, 8]


def test_route_routes_the_router_output_by_the_published_rule():
    g = torch.Generator().manual_seed(5)
    router = torch.randn(32, 64, generator=g) * 32 ** -0.5
    x = torch.randn(40, 32, generator=g)
    r = moe.route(router, x, 6, None, moe.Rule(8, 3, False, 16.0))
    probs = torch.softmax(x @ router, -1)
    want_p, want_e = _route_loop(probs, 6, 8, 3, False, 16.0)
    assert torch.equal(r.top_e, want_e)
    # each kept slot's gate is its probability × 16, at the row it was given
    gate = r.gate.reshape(-1)[r.where.reshape(-1)].reshape(40, 6)
    torch.testing.assert_close(gate, want_p, rtol=1e-6, atol=0)
    assert r.dropped == 0 and r.held.all() and r.kept.all()


# ----------------------------------------------------------------- YaRN ----
def test_yarn_frequencies_and_factors_against_the_formula():
    dim, theta = 64, 10000.0

    def turns_dim(turns):
        return dim * math.log(4096 / (turns * 2 * math.pi)) / (2 * math.log(theta))

    low, high = math.floor(turns_dim(32)), math.ceil(turns_dim(1))
    assert (low, high) == DEEPSEEK_YARN.correction_range(dim, theta) == (10, 23)
    want = []
    for i in range(dim // 2):
        extra = 1.0 / theta ** (2 * i / dim)
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        want.append(extra / 40 * ramp + extra * (1 - ramp))
    torch.testing.assert_close(DEEPSEEK_YARN.inv_freq(dim, theta),
                               torch.tensor(want, dtype=torch.float32), rtol=2e-6, atol=0)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert DEEPSEEK_YARN.softmax_factor == pytest.approx(m * m) == pytest.approx(1.58962, abs=1e-5)
    assert DEEPSEEK_YARN.cos_sin_factor == 1.0
    pos = torch.arange(5000)
    cos, sin = layers.rope_angles(pos, dim, theta, DEEPSEEK_YARN)
    ang = pos.float()[:, None] * torch.tensor(want)
    torch.testing.assert_close(cos, ang.cos(), rtol=0, atol=2e-3)
    torch.testing.assert_close(sin, ang.sin(), rtol=0, atol=2e-3)
    # the plain angles are untouched without scaling
    assert torch.equal(layers.rope_angles(pos, dim, theta)[0],
                       torch.cos(pos.float()[:, None]
                                 * theta ** (-torch.arange(32, dtype=torch.float32) / 32)))


def _mla(seed=0):
    g = torch.Generator().manual_seed(seed)
    return mla.MLA(g, 64, 4, 32, 16, nope_dim=16, rope_dim=8, v_dim=16).float()


def test_mla_softmax_scale_is_mscale_squared_over_root_d_in_prefill_and_decode():
    """The expanded prefill against attention written out with the
    published scale; the absorbed decode's last position against it."""
    p = _mla()
    B, S = 2, 9
    x = torch.randn(B, S, 64, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(S)
    out, (ckv, kr) = mla.mla_forward(p, x, pos, 16, 8, rope_scaling=DEEPSEEK_YARN)
    # written out
    cos, sin = layers.rope_angles(pos, 8, 10000.0, DEEPSEEK_YARN)
    cq = p.q_norm(x @ p.wdq.float())
    q = torch.einsum("bsq,qhk->bshk", cq, p.wuq.float())
    q = torch.cat([q[..., :16], layers.apply_rope(q[..., 16:], cos, sin)], -1)
    c = p.kv_norm(x @ p.wdkv.float())
    k = torch.cat([torch.einsum("bsc,chk->bshk", c, p.wuk.float()),
                   layers.apply_rope((x @ p.wkr.float())[:, :, None], cos, sin).expand(
                       B, S, 4, 8)], -1)
    v = torch.einsum("bsc,chk->bshk", c, p.wuv.float())
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * DEEPSEEK_YARN.softmax_factor / math.sqrt(24)
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), float("-inf"))
    want = torch.einsum("bhqk,bkhd,hde->bqe", s.softmax(-1), v, p.wo.float())
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    # decode at S - 1 over the prefill's latent cache of the first S - 1
    cache_c = torch.zeros(B, S, 16)
    cache_r = torch.zeros(B, S, 8)
    cache_c[:, :S - 1], cache_r[:, :S - 1] = ckv[:, :S - 1], kr[:, :S - 1]
    dec, _, _ = mla.mla_decode(p, x[:, S - 1:], cache_c, cache_r, S - 1, 16, 8,
                               rope_scaling=DEEPSEEK_YARN)
    torch.testing.assert_close(dec[:, 0], want[:, -1], rtol=1e-4, atol=1e-5)
    plain, _ = mla.mla_forward(p, x, pos, 16, 8)
    assert (plain - out).abs().max() > 1e-2


# ------------------------------------------------------------------ eps ----
def _family_configs():
    out = []
    for arch in ("deepseek-v2-236b", "zamba2-1.2b", "xlstm-1.3b"):
        out.append(dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32,
                                       rms_eps=1e-6))
    return out


@pytest.mark.parametrize("cfg", _family_configs(), ids=lambda c: c.family)
def test_rms_eps_reaches_every_norm(cfg):
    """Every RMSNorm of the model takes ``rms_eps``; the output with 1e-6
    differs from that with 1e-5; and each norm's site reads its own eps
    (raising one norm's eps alone moves the logits)."""
    model = Model(cfg, device="cpu", seed=1)
    norms = [(n, m) for n, m in model.named_modules() if isinstance(m, RMSNorm)]
    assert norms and all(m.eps == 1e-6 for _, m in norms)
    tokens = torch.randint(1, cfg.vocab, (2, 12), generator=torch.Generator().manual_seed(2))
    # small embeddings make eps matter against the rows' mean square
    with torch.no_grad():
        model.embed.mul_(1e-2)
        base = model.forward({"tokens": tokens})[0]
        coarse = Model(dataclasses.replace(cfg, rms_eps=1e-5), device="cpu", seed=1)
        coarse.load_state_dict(model.state_dict())
        assert not torch.equal(coarse.forward({"tokens": tokens})[0], base)
        for name, m in norms:
            m.eps = 1.0
            moved = model.forward({"tokens": tokens})[0]
            m.eps = 1e-6
            assert not torch.equal(moved, base), name


# ------------------------------------------------------ the expert share ----
def _layer(E, held=None, shared=1, seed=0):
    return moe.MoE(torch.Generator().manual_seed(seed), 16, 8, E, shared, held=held).float()


def _share_of(whole, first, count):
    part = _layer(whole.router.shape[1], (first, count))
    state = dict(whole.state_dict())
    for n in ("wg", "wu", "wd"):
        state[n] = state[n][first:first + count]
    part.load_state_dict(state)
    return part


@pytest.mark.parametrize("S,ragged", [(7, False), (100, True)], ids=["7", "100"])
def test_the_eight_shares_add_up_to_the_uncut_layer(S, ragged):
    """16 experts over 8 chips, 2 each: each share routes over all 16 and
    adds its own experts' part and the shared expert; the parts, the
    shared expert counted once, are the uncut layer's output.  The
    experts' rows padded to C = T (a decode step's route), or ragged."""
    whole = _layer(16)
    T = 3 * S
    x = torch.randn(3, S, 16, generator=torch.Generator().manual_seed(4))
    rule = moe.Rule(8, 3, False, 16.0)
    want, _ = moe.moe_forward(whole, x, 4, None, rule=rule, ragged=ragged)
    shared = layers.mlp_forward(whole.shared, x)
    parts = [moe.moe_forward(_share_of(whole, 2 * i, 2), x, 4, None, rule=rule,
                             ragged=ragged)[0] - shared
             for i in range(8)]
    torch.testing.assert_close(sum(parts) + shared, want, rtol=1e-5, atol=1e-5)
    counts = torch.zeros(4, dtype=torch.int64)
    moe.moe_forward(_share_of(whole, 6, 2), x, 4, None, counts=counts, rule=rule,
                    ragged=ragged)
    r = moe.route(whole.router, x.reshape(-1, 16), 4, None, rule)
    held = int(((r.top_e >= 6) & (r.top_e < 8)).sum())
    rows = held if ragged else 2 * T
    assert counts.tolist() == [T * 4, held, rows, 0]


def test_a_share_is_a_range_of_the_experts():
    for held in ((-1, 2), (15, 2), (0, 0)):
        with pytest.raises(ValueError):
            _layer(16, held)


# --------------------------------------------------------------- dropless ----
def _plain_moe(p, x, k, scale):
    """Every token's k chosen experts (greedy, unnormalised × scale), summed
    token by token, and the shared expert."""
    xf = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(xf @ p.router.float(), -1)
    w, e = _route_loop(probs, k, 0, 0, False, scale)
    out = []
    for t in range(xf.shape[0]):
        acc = torch.zeros(xf.shape[-1])
        for j in range(k):
            i = int(e[t, j])
            h = torch.nn.functional.silu(xf[t] @ p.wg[i]) * (xf[t] @ p.wu[i])
            acc = acc + w[t, j] * (h @ p.wd[i])
        out.append(acc)
    return torch.stack(out).reshape(x.shape) + layers.mlp_forward(p.shared, x)


@pytest.mark.parametrize("T,ragged", [(12, False), (300, True), (12, True)],
                         ids=["12", "300", "12-ragged"])
def test_dropless_drops_nothing_where_the_capacity_drops(monkeypatch, T, ragged):
    """A skewed router sends most tokens to expert 3.  Dropless equals the
    plain sum, its rows padded to C = T (a decode step's route) or ragged
    (a full-sequence pass's: each expert over its own rows, the counts
    read on the host); the default capacity drops slots."""
    p = _layer(8)
    with torch.no_grad():
        p.router[:, 3] += 1.0
    x = torch.randn(1, T, 16, generator=torch.Generator().manual_seed(6)) + 0.5
    seen = []
    real = moe.route

    def spy(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(moe, "route", spy)
    rule = moe.Rule(norm_topk_prob=False)
    got, _ = moe.moe_forward(p, x, 2, None, rule=rule, ragged=ragged)
    dropped, _ = moe.moe_forward(p, x, 2, 1.25, rule=rule, ragged=ragged)
    free, capped = seen
    counts = torch.bincount(free.top_e.reshape(-1), minlength=8)
    assert free.dropped == 0 and free.kept.all()
    if ragged:
        assert free.sizes == counts.tolist() and free.rows == 2 * T
        assert free.cap == max(free.sizes)
    else:
        assert free.cap == T and free.sizes is None and free.rows == 8 * T
    assert counts.max() > capped.cap and capped.dropped > 0
    torch.testing.assert_close(got, _plain_moe(p, x, 2, 1.0), rtol=1e-5, atol=1e-5)
    assert (got - dropped).abs().max() > 1e-3


# ------------------------------------------------------------------ pads ----
@pytest.mark.parametrize("ragged", [False, True])
def test_pads_take_no_routed_slot(ragged):
    """Rows 0-4 of the first sequence and row 0 of the second are pads: they
    get the shared expert alone, the others what they get without pads
    (dropless rows are independent), and the counters leave the pads'
    slots out of the routed and held slots."""
    whole = _layer(16)
    part = _share_of(whole, 4, 4)
    x = torch.randn(2, 9, 16, generator=torch.Generator().manual_seed(8))
    pads = torch.zeros(2, 9, dtype=torch.bool)
    pads[0, :5] = pads[1, 0] = True
    rule = moe.Rule(8, 3, False, 16.0)
    for p in (whole, part):
        counts = torch.zeros(4, dtype=torch.int64)
        got, _ = moe.moe_forward(p, x, 4, None, counts=counts, rule=rule, ragged=ragged,
                                 pads=pads)
        free, _ = moe.moe_forward(p, x, 4, None, rule=rule, ragged=ragged)
        shared = layers.mlp_forward(p.shared, x)
        torch.testing.assert_close(got[pads], shared[pads], rtol=0, atol=0)
        torch.testing.assert_close(got[~pads], free[~pads], rtol=1e-6, atol=1e-6)
        r = moe.route(p.router, x.reshape(-1, 16), 4, None, rule, held=p.held,
                      pads=pads.reshape(-1))
        first, n = p.held or (0, 16)
        mine = (r.top_e >= first) & (r.top_e < first + n) & ~pads.reshape(-1, 1)
        assert torch.equal(r.held, mine) and torch.equal(r.kept, mine)
        rows = int(mine.sum()) if ragged else n * 18
        assert counts.tolist() == [12 * 4, int(mine.sum()), rows, 0]


@pytest.mark.parametrize("ragged", [False, True])
def test_a_layer_with_no_held_slot_adds_the_shared_expert_alone(ragged):
    """Every token a pad: no slot is routed, and the layer's output is the
    shared expert's."""
    p = _share_of(_layer(16), 4, 4)
    x = torch.randn(2, 5, 16, generator=torch.Generator().manual_seed(9))
    counts = torch.zeros(4, dtype=torch.int64)
    got, _ = moe.moe_forward(p, x, 4, None, counts=counts, ragged=ragged,
                             pads=torch.ones(2, 5, dtype=torch.bool))
    assert torch.equal(got, layers.mlp_forward(p.shared, x))
    assert counts.tolist() == [0, 0, 0 if ragged else 4 * 10, 0]


def test_the_model_finds_each_rows_leading_pads():
    """``unrouted_pad`` marks each row's leading run of the pad token only;
    a prompt without pads is served bit for bit as without the option."""
    cfg = dataclasses.replace(get_config("deepseek-v2-236b", smoke=True), dtype=torch.float32,
                              capacity_factor=None)
    model = Model(dataclasses.replace(cfg, unrouted_pad=0), device="cpu", seed=3)
    tokens = torch.tensor([[0, 0, 5, 0, 3], [7, 0, 0, 2, 1], [0, 0, 0, 0, 4]])
    assert model._pads({"tokens": tokens}).tolist() == [
        [True, True, False, False, False], [False] * 5, [True] * 4 + [False]]
    plain = Model(cfg, device="cpu", seed=3)
    assert plain._pads({"tokens": tokens}) is None
    full = tokens[1:2]
    assert torch.equal(model.prefill({"tokens": full})[0], plain.prefill({"tokens": full})[0])
    assert not torch.equal(model.prefill({"tokens": tokens})[0],
                           plain.prefill({"tokens": tokens})[0])


# ---------------------------------------------------------------- decode ----
def test_decode_at_a_device_position_matches_decode():
    """The step at a tensor ``pos`` (``Model.decode_in_place`` with a 0-d
    int64 ``pos``, as the decode graph captures it) with every published
    option on, on its own cache, for 8 steps after a prefill, the last at
    ``max_len - 1``, against ``Model.decode`` (an int ``pos``) of a twin
    model: the same greedy tokens, logits, ``ckv``/``kr`` and MoE running
    sums, bit for bit."""
    cfg = dataclasses.replace(
        get_config("deepseek-v2-236b", smoke=True), dtype=torch.float32, n_group=4,
        topk_group=2, norm_topk_prob=False, routed_scaling_factor=16.0, capacity_factor=None,
        experts_held=(2, 4), rope_scaling=DEEPSEEK_YARN, unrouted_pad=0)
    model, twin = (Model(cfg, device="cpu", seed=3) for _ in range(2))
    B, S, steps = 2, 12, 8
    max_len = S + steps
    tokens = torch.randint(1, cfg.vocab, (B, S), generator=torch.Generator().manual_seed(5))
    tokens[0, :4] = 0                                   # left pads, unrouted
    logits, static = model.prefill({"tokens": tokens}, max_len=max_len)
    want_logits, cache = twin.prefill({"tokens": tokens}, max_len=max_len)
    assert torch.equal(logits, want_logits)
    assert torch.equal(model.moe_counts, twin.moe_counts)
    prefilled = twin.moe_counts.clone()
    del static["pos"]
    pos = torch.zeros((), dtype=torch.int64)
    tok = logits.argmax(-1)[:, None]
    for k in range(steps):
        pos.fill_(S + k)
        got = model.decode_in_place(static, {"tokens": tok}, pos)
        want, cache = twin.decode(cache, {"tokens": tok})
        assert torch.equal(got, want)
        for key, v in static.items():
            assert torch.equal(v, cache[key]), key
        tok = want.argmax(-1)[:, None]
    assert int(pos) == max_len - 1 and cache["pos"] == max_len
    assert torch.equal(model.moe_counts, twin.moe_counts)
    # every decoded token routed its top k in each MoE layer
    routed = twin.moe_counts[0] - prefilled[0]
    assert routed == steps * B * cfg.top_k * (cfg.n_layers - 1)


# --------------------------------------------------------------- defaults ----
def _route_probs_before(probs, top_k, cap):
    """The routing before the published forms were added, verbatim."""
    T, E = probs.shape
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :top_k], top_e[:, :top_k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    TK = T * top_k
    flat_e = top_e.reshape(TK)
    counts = torch.zeros(E, dtype=flat_e.dtype).index_add_(0, flat_e, torch.ones_like(flat_e))
    aux_loss = E * torch.sum(probs.mean(0) * (counts.float() / TK))
    sort_idx = torch.argsort(flat_e, stable=True)
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(sort_idx)
    rank[sort_idx] = torch.arange(TK)
    within = rank - offsets[flat_e]
    kept = within < cap
    where = flat_e * cap + torch.clamp(within, max=cap - 1)
    col = torch.arange(cap)
    slot = torch.clamp(offsets[:, None] + col[None, :], max=TK - 1)
    valid = col[None, :] < counts[:, None]
    token_slot = sort_idx[slot]
    gate = top_p.reshape(TK)[token_slot] * valid
    return (top_e, kept.reshape(T, top_k), where.reshape(T, top_k), token_slot // top_k,
            gate, aux_loss)


@pytest.mark.parametrize("T,k,E,cf", [(24, 2, 16, 1.25), (4, 2, 16, 1.25), (40, 6, 16, 1.0)])
def test_the_defaults_route_as_before_bit_for_bit(T, k, E, cf):
    probs = torch.softmax(torch.randn(T, E, generator=torch.Generator().manual_seed(T)), -1)
    cap = moe.capacity(T, k, E, cf)
    got = moe._route_probs(probs, k, cap)
    want = _route_probs_before(probs, k, cap)
    assert got[7] == cap and got[8] is None and got[6].all()
    for a, b in zip(got[:6], want):
        assert torch.equal(a, b)


def test_the_defaults_serve_as_before_bit_for_bit():
    """The mla_moe smoke model with every new option spelled out at its
    default gives the default model's logits bit for bit."""
    cfg = get_config("deepseek-v2-236b", smoke=True)
    spelled = dataclasses.replace(cfg, rms_eps=1e-5, n_group=0, topk_group=0,
                                  norm_topk_prob=True, routed_scaling_factor=1.0,
                                  rope_scaling=None, experts_held=None, unrouted_pad=None)
    a, b = Model(cfg, device="cpu", seed=3), Model(spelled, device="cpu", seed=3)
    tokens = torch.randint(1, cfg.vocab, (2, 10), generator=torch.Generator().manual_seed(0))
    la, ca = a.prefill({"tokens": tokens}, max_len=12)
    lb, cb = b.prefill({"tokens": tokens}, max_len=12)
    assert torch.equal(la, lb)
    assert torch.equal(a.decode(ca, {"tokens": la.argmax(-1)[:, None]})[0],
                       b.decode(cb, {"tokens": lb.argmax(-1)[:, None]})[0])


@pytest.fixture
def one_rank_mesh(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1,))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("held,cf,pads", [((0, 2), 1.25, None), (None, None, None),
                                          (None, 1.25, torch.zeros(6, dtype=torch.bool))],
                         ids=["held0-1.25", "None-None", "pads"])
def test_a_share_or_dropless_on_a_mesh_raises(one_rank_mesh, held, cf, pads):
    """A share of the experts, dropless, or pads left unrouted."""
    from torch.distributed.tensor import DTensor, Replicate

    g = torch.Generator().manual_seed(0)
    router = DTensor.from_local(torch.randn(16, 8, generator=g), one_rank_mesh, [Replicate()])
    x = DTensor.from_local(torch.randn(6, 16, generator=g), one_rank_mesh, [Replicate()])
    with pytest.raises(ValueError, match="off a mesh"):
        moe.route(router, x, 2, cf, held=held, pads=pads)
