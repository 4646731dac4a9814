"""The port's MoE layer against the JAX package's, on the CPU.

Both get the same fp32 numpy weights and inputs.  The routing is integer
work and must match exactly: the experts each token-slot picks (``top_e``)
and the set of token-slots dropped past an expert's capacity.  The
reference's own values are read off its ``moe_forward`` as it runs (a spy on
the module's ``jnp``: the argument of its ``argsort`` is the flat ``top_e``,
its one ``concatenate`` the experts' offsets, its first ``take`` the
[E, C] token-slots).  The output and the aux loss agree within
1e-5·(1 + max|ref|) (fp32, another summation order).  Exact equality of
``top_e`` is only meaningful where no token's k-th and (k+1)-th
probabilities lie within the two packages' fp32 gap, so the random cases
assert a margin above that gap; the tie cases make exact ties on purpose.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as REF
from repro_torch.configs import get_config
from repro_torch.models import moe as MOE
from repro_torch.models.layers import mlp_forward


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _weights(seed, D, F, E, n_shared=0):
    rng = np.random.default_rng(seed)
    w = {"router": _np(rng, D, E, scale=D ** -0.5),
         "wg": _np(rng, E, D, F, scale=D ** -0.5), "wu": _np(rng, E, D, F, scale=D ** -0.5),
         "wd": _np(rng, E, F, D, scale=F ** -0.5)}
    if n_shared:
        w["shared"] = {"wg": _np(rng, D, F * n_shared, scale=D ** -0.5),
                       "wu": _np(rng, D, F * n_shared, scale=D ** -0.5),
                       "wd": _np(rng, F * n_shared, D, scale=(F * n_shared) ** -0.5)}
    return w


def _port(w):
    D, E = w["router"].shape
    F = w["wg"].shape[-1]
    n_shared = w["shared"]["wg"].shape[1] // F if "shared" in w else 0
    p = MOE.MoE(torch.Generator().manual_seed(0), D, F, E, n_shared).float()
    state = {}
    for k, v in w.items():
        if isinstance(v, dict):
            state.update({f"{k}.{kk}": torch.from_numpy(vv) for kk, vv in v.items()})
        else:
            state[k] = torch.from_numpy(v)
    p.load_state_dict(state, strict=True)
    return p


class _Spy:
    """Stands in for the reference module's ``jnp``: records the calls of
    ``names`` (arguments and result) and forwards everything."""

    def __init__(self, names):
        self.calls = {n: [] for n in names}

    def __getattr__(self, name):
        fn = getattr(jnp, name)
        if name not in self.calls:
            return fn

        def recorded(*args, **kw):
            out = fn(*args, **kw)
            self.calls[name].append((args, out))
            return out
        return recorded


def _reference(monkeypatch, w, x, top_k, capacity_factor):
    """The reference's (out, aux, top_e [T,k], dropped flat slots, cap)."""
    spy = _Spy(("argsort", "concatenate", "take"))
    monkeypatch.setattr(REF, "jnp", spy)
    jw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray)
              else {kk: jnp.asarray(vv) for kk, vv in v.items()}) for k, v in w.items()}
    out, aux = REF.moe_forward(jw, jnp.asarray(x), top_k, capacity_factor)
    monkeypatch.undo()
    flat_e = np.asarray(spy.calls["argsort"][0][0][0])
    offsets = np.asarray(spy.calls["concatenate"][0][1])
    token_slot = np.asarray(spy.calls["take"][0][1])
    TK, cap = flat_e.size, token_slot.shape[1]
    counts = np.diff(np.append(offsets, TK))
    kept = token_slot[np.arange(cap)[None, :] < counts[:, None]]
    dropped = np.setdiff1d(np.arange(TK), kept)
    return np.asarray(out), float(aux), flat_e.reshape(-1, top_k), dropped, cap


def _run_port(p, x, top_k, capacity_factor):
    xt = torch.from_numpy(x)
    r = MOE.route(p.router, xt.reshape(-1, x.shape[-1]), top_k, capacity_factor)
    out, aux = MOE.moe_forward(p, xt, top_k, capacity_factor)
    dropped = np.flatnonzero(~r.kept.numpy().reshape(-1))
    return out.numpy(), float(aux), r, dropped


def _margin(w, x, top_k):
    """The least gap, over tokens, between the k-th and (k+1)-th routing
    probabilities (fp32 on the port's side)."""
    xf = torch.from_numpy(x).reshape(-1, x.shape[-1])
    probs = torch.softmax(xf @ torch.from_numpy(w["router"]), -1)
    top = torch.sort(probs, -1, descending=True).values
    return float((top[:, top_k - 1] - top[:, top_k]).min())


def _check(monkeypatch, w, x, top_k, capacity_factor):
    want, want_aux, ref_top_e, ref_dropped, ref_cap = _reference(
        monkeypatch, w, x, top_k, capacity_factor)
    got, aux, r, dropped = _run_port(_port(w), x, top_k, capacity_factor)
    assert r.cap == ref_cap
    np.testing.assert_array_equal(r.top_e.numpy(), ref_top_e)
    np.testing.assert_array_equal(dropped, ref_dropped)
    assert np.abs(got - want).max() <= 1e-5 * (1 + np.abs(want).max())
    assert abs(aux - want_aux) <= 1e-5 * (1 + abs(want_aux))
    return r, dropped


# (T = B·S, D, F, E, top_k, capacity factor, shared experts): factors that
# drop slots (1.0, 1.25) and factors that do not (8.0)
@pytest.mark.parametrize("B,S,D,F,E,k,cf,n_shared", [
    (2, 24, 16, 24, 4, 2, 1.0, 0),
    (2, 24, 16, 24, 4, 2, 1.25, 0),
    (2, 24, 16, 24, 4, 2, 8.0, 0),
    (3, 17, 32, 16, 8, 3, 1.25, 1),     # deepseek-like: top-3 of 8, shared experts
    (1, 40, 16, 16, 16, 2, 1.25, 0),    # phi3.5-moe's E and k
    (4, 1, 16, 24, 16, 2, 1.25, 0),     # phi3.5-moe's decode at batch 4: cap 1
])
def test_moe_forward_matches_reference(monkeypatch, B, S, D, F, E, k, cf, n_shared):
    w = _weights(B * S + E, D, F, E, n_shared)
    x = _np(np.random.default_rng(S), B, S, D)
    # the packages' probabilities differ by < 1e-6 in fp32: a margin of 1e-5
    # makes the exact comparison of top_e meaningful
    assert _margin(w, x, k) > 1e-5
    r, dropped = _check(monkeypatch, w, x, k, cf)
    T = B * S
    assert r.cap == MOE.capacity(T, k, E, cf)
    if MOE.capacity(T, k, E, cf) >= T:          # no expert can overflow
        assert dropped.size == 0
    if cf == 1.0:
        assert dropped.size > 0


def test_capacity_formula():
    """int(max(1, ceil(T·k/E) · capacity_factor)), the reference's rounding:
    the product is a float, truncated."""
    for T, k, E, cf, want in [(4, 2, 16, 1.25, 1),        # phi3.5-moe decode at batch 4
                              (4096, 2, 16, 1.25, 640),   # phi3.5-moe prefill, 4 × 1024
                              (4096, 6, 160, 1.25, 192),  # deepseek-v2 prefill, 4 × 1024
                              (1, 1, 64, 1.0, 1), (7, 3, 4, 1.5, 9), (8, 2, 4, 8.0, 32)]:
        assert MOE.capacity(T, k, E, cf) == want
        assert MOE.capacity(T, k, E, cf) == int(max(1, -(-(T * k) // E) * cf))


@pytest.mark.parametrize("top_k,cf", [(1, 1.0), (2, 1.0), (1, 8.0), (3, 1.25)])
def test_ties_break_to_the_lower_expert_as_in_the_reference(monkeypatch, top_k, cf):
    """Experts 1 and 2 (and 0 and 3) have the same router column, so every
    token's probabilities tie exactly between them: ``jax.lax.top_k`` takes
    the lower index first, and so must the port, whatever ``torch.topk``
    would do.  Many tokens then pick the same expert, and the stable sort
    keeps the first ones in token order up to the capacity."""
    D, F, E = 16, 16, 4
    w = _weights(3, D, F, E)
    col = w["router"][:, 1].copy()
    w["router"][:, 1] = w["router"][:, 2] = col
    w["router"][:, 0] = w["router"][:, 3] = -0.5 * col
    x = _np(np.random.default_rng(5), 2, 12, D)
    r, dropped = _check(monkeypatch, w, x, top_k, cf)
    top = r.top_e.numpy()
    for a, b in ((1, 2), (0, 3)):
        # where both tied experts are picked, the lower comes first; where one
        # is, it is the lower
        assert not ((top == b).any(-1) & ~(top == a).any(-1)).any()
    if cf == 1.0:
        assert dropped.size > 0


def test_phi35_moe_decode_drops_token_slots(monkeypatch):
    """Served decode at batch 4 routes T = 4 tokens: TK = 8 slots over
    phi3.5-moe's 16 experts gives cap = int(ceil(8/16)·1.25) = 1, so a
    second slot on one expert is dropped, in the reference and in the port
    alike.  This is the reference's function, kept (ROADMAP.md §3)."""
    cfg = get_config("phi3.5-moe-42b-a6.6b")
    E, k, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
    assert MOE.capacity(4, k, E, cf) == 1
    w = _weights(11, 32, 16, E)
    # two tokens that route alike: at least one slot of the second is dropped
    x = _np(np.random.default_rng(7), 4, 1, 32)
    x[1] = x[0] * 1.5
    r, dropped = _check(monkeypatch, w, x, k, cf)
    assert dropped.size >= 1 and not r.kept[1].all()


def _expert_loop(p, x, top_k, rule, pads):
    """A decode batch's routed experts token by token in fp64: each slot
    whose expert the layer holds, its token no pad, adds its gate times its
    expert's MLP of the token; the routing is the port's own ``_top_k``."""
    xf = x.reshape(-1, x.shape[-1])
    logits = xf @ p.router
    probs = torch.sigmoid(logits) if rule.scoring == "sigmoid" else torch.softmax(logits, -1)
    top_p, top_e = MOE._top_k(probs, top_k, rule, p.e_score_correction_bias)
    first, n = p.held or (0, p.router.shape[1])
    out = torch.zeros(xf.shape, dtype=torch.float64)
    for t in range(xf.shape[0]):
        if pads is not None and pads.reshape(-1)[t]:
            continue
        v = xf[t].double()
        for j in range(top_k):
            e = int(top_e[t, j]) - first
            if not 0 <= e < n:
                continue
            u = v @ p.wu[e].double()
            h = (torch.square(torch.relu(u)) if p.wg is None
                 else torch.nn.functional.silu(v @ p.wg[e].double()) * u)
            out[t] += top_p[t, j].double() * (h @ p.wd[e].double())
    return out


@pytest.fixture
def unwritten_is_nan():
    """Deterministic mode fills every fresh tensor with NaN, so an output
    row the grouped GEMM does not write reads NaN."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


# (rule, act, E, held, B, k, pads): Nemotron's rule (sigmoid with a bias,
# relu², all held) and DeepSeek's (group-limited ×16, SwiGLU, a held share),
# each with T·k below E (the grouped route) and at or above it (C = T); a
# batch none of whose slots is held here; left pads
@pytest.mark.parametrize("case", [
    ("sigmoid", "relu2", 16, None, 2, 6, False),
    ("sigmoid", "relu2", 16, None, 4, 6, False),
    ("groups", "swiglu", 16, (4, 8), 2, 3, False),
    ("groups", "swiglu", 16, (4, 8), 8, 3, False),
    ("groups", "swiglu", 16, "unused", 2, 2, False),
    ("sigmoid", "relu2", 16, None, 3, 4, True),
    ("groups", "swiglu", 16, (0, 8), 3, 3, True),
], ids=["nemotron-below", "nemotron-above", "deepseek-below", "deepseek-above",
        "none-held", "nemotron-pads", "deepseek-pads"])
def test_dropless_decode_step_reads_only_the_routed_experts(unwritten_is_nan, case):
    """A decode-shaped [B,1,D] batch through the dropless layer in fp32,
    against the routed experts token by token: where T·k < E the slots stay
    grouped over the counts on the device (the rows computed are the held
    slots, the experts read those with a row), else C = T (every held
    expert reads T rows); the five running sums say which.  With no slot
    held here the output is the shared experts' alone, finite, though the
    grouped GEMM wrote none of its rows."""
    scoring, act, E, held, B, k, with_pads = case
    D, F = 32, 24
    rule = (MOE.Rule(scoring="sigmoid", routed_scaling_factor=2.5) if scoring == "sigmoid"
            else MOE.Rule(n_group=4, topk_group=2, norm_topk_prob=False,
                          routed_scaling_factor=16.0))
    x = torch.randn(B, 1, D, generator=torch.Generator().manual_seed(B * k))
    pads = None
    if with_pads:
        pads = torch.zeros(B, 1, dtype=torch.bool)
        pads[0] = True

    def layer(held):
        p = MOE.MoE(torch.Generator().manual_seed(E), D, F, E, 1, held=held, act=act,
                    score_bias=scoring == "sigmoid").float()
        if p.e_score_correction_bias is not None:
            p.e_score_correction_bias.copy_(
                torch.randn(E, generator=torch.Generator().manual_seed(1)) * 0.05)
        return p

    if held == "unused":
        # two neighbouring experts that no slot of the batch chose
        top_e = MOE.route(layer(None).router, x.reshape(B, D), k, None, rule,
                          ragged=True).top_e
        first = next(e for e in range(E - 1) if not (top_e == e).any() | (top_e == e + 1).any())
        held = (first, 2)
    p = layer(held)
    n_held = E if held is None else held[1]
    counts = torch.zeros(5, dtype=torch.int64)
    out, _ = MOE.moe_forward(p, x, k, None, counts=counts, rule=rule, pads=pads)

    shared = mlp_forward(p.shared, x)
    want = _expert_loop(p, x, k, rule, pads).reshape(B, 1, D) + shared.double()
    assert torch.isfinite(out).all()
    assert (out.double() - want).abs().max().item() <= 1e-5 * (1 + want.abs().max().item())
    r = MOE.route(p.router, x.reshape(B, D), k, None, rule, held=p.held,
                  pads=None if pads is None else pads.reshape(B),
                  bias=p.e_score_correction_bias)
    held_slots = int(r.held.sum())
    used = len(set(r.top_e[r.held].tolist()))
    routed = (B - int(with_pads)) * k
    if B * k < E:
        rows, read = held_slots, used
    else:
        rows, read = n_held * B, n_held
    assert counts.tolist() == [routed, held_slots, rows, 0, read]
    if held_slots == 0:
        assert torch.equal(out, shared)
