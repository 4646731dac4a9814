"""The yardstick's counts against hand counts at small sizes, pinned at the
cells' sizes, and the readers' arithmetic on synthetic runs."""
import hashlib
import importlib.util
import json
import math
import types

import pytest

from benchlib import counts, readers, smoke, weights
from benchlib.spec import ROOT, Spec, family


def test_bound_is_chip_smokes():
    spec = importlib.util.spec_from_file_location("chip_smoke_copy", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for n_bytes, n_ops, dtype in ((1e9, 1e12, "bfloat16"), (1e6, 1e13, "tfloat32"),
                                  (5e8, 0.0, "float32")):
        assert counts.bound_ms(n_bytes, n_ops, dtype) == cs.bound_ms(n_bytes, n_ops, dtype)


def test_k2_by_hand():
    # B 1, S 4, one head, D = Dv = 2: 10 causal pairs, each 2·(2 + 2) FLOPs;
    # q, k, v and the output, 4·2 bf16 elements each
    assert counts.k2_call(1, 4, 1, 2, 2) == (80, 64)
    # D 192 / Dv 128 at B 2, S 3, 2 heads: 6 pairs · 2 · 320 · 2 · 2
    assert counts.k2_call(2, 3, 2, 192, 128)[0] == 2 * 2 * 2 * 320 * 6


def test_k3_by_hand():
    # S 3 in chunks of 2: a chunk of 2 (3 pairs) and one of 1 (1 pair)
    flops, n_bytes = counts.k3_call(1, 3, 1, 1, 1, 2)
    assert flops == 2 * (3 * 2 + 2 * 2) + 2 * (1 * 2 + 2 * 1)
    assert n_bytes == 2 * 2 * 3 + 4 * 3 + 2 * 2 * 3 + 4 + 4


def _matrix_flops(conf, fam):
    """2 · the elements of every weight matrix a token passes through, read
    off the port's model built on meta (an independent count of the
    configuration's linear work)."""
    from repro_torch.models import Model

    model = Model(family(conf).model_config(conf), device="meta")
    total = 0
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.dim() < 2 or name in ("embed", "lm_head") or leaf == "router":
            continue
        if name.startswith("shared_attn."):
            total += 2 * p.numel() * len(model.shared_proj)            # at every site
        else:
            total += 2 * p.numel()
    return total


@pytest.mark.parametrize("S", [1, 5, 37])
def test_prefill_flops_by_matrix(S):
    fam = "hybrid"
    conf = smoke.config(fam)
    B = 2
    calls = counts.kernel_calls(conf, B, S)
    attn = sum(counts.k2_call(*c)[0] for c in calls["k2"])
    scan = sum(counts.k3_call(*c)[0] for c in calls["k3"])
    unembed = 2 * B * conf["hidden_size"] * conf["vocab_size"]
    linear = counts.prefill_flops(conf, B, S) - attn - scan - unembed
    assert linear == B * S * _matrix_flops(conf, fam)


def test_decode_flops_by_hand():
    conf = smoke.config("hybrid")
    m = family(conf).hybrid_dims(conf)
    # one more position attended: per site and head the scores and the
    # context over it, 2 · 2 · hd
    step = counts.decode_flops(conf, 3, 4) - counts.decode_flops(conf, 3, 3)
    assert step == 3 * m["sites"] * 2 * 2 * m["H"] * m["hd"]
    # at pos 0 a step is the prefill of one token, bar the scan's chunk form
    pre = counts.prefill_flops(conf, 3, 1) - sum(
        counts.k3_call(*c)[0] for c in counts.kernel_calls(conf, 3, 1)["k3"])
    assert counts.decode_flops(conf, 3, 0) - m["L"] * 3 * 4 * m["Hs"] * m["N"] * m["P"] == pre


def test_model_configs_of_the_cells():
    spec = Spec()
    for c in spec.data["configs"]:
        conf = spec.config(c["name"])
        cfg = family(conf).model_config(conf)
        assert (cfg.arch, cfg.family) == (c["name"], conf["family"])
    conf = spec.config("zamba2-1.2b")
    z = family(conf).model_config(conf)
    assert (z.n_layers, z.d_model, z.head_dim, z.ssm_state, z.ssm_headdim) == (38, 2048, 64, 64, 64)
    assert z.shared_sites() == [0, 6, 12, 18, 24, 30, 36]


def test_zamba2_counts_are_pinned():
    """The counts that every reader of the zamba2 cells rests on, exactly."""
    conf = Spec().config("zamba2-1.2b")
    assert [counts.prefill_flops(conf, B, S) for B, S in
            ((8, 4096), (8, 3400), (64, 1024), (1, 32))] == [
        104798653251584.0, 86438411239424.0, 203831161913344.0, 97787445248.0]
    assert counts.decode_flops(conf, 64, 1055) == 206858878976
    assert counts.decode_flops(conf, 8, 4099) == 27253800960
    assert counts.kernel_calls(conf, 8, 4096) == {"k2": [(8, 4096, 32, 64, 64)] * 7,
                                                  "k3": [(8, 4096, 64, 64, 64, 128)] * 38}


def test_smoke_weights_are_pinned():
    """The weights the benchmark draws for the smoke hybrid from a large
    seed: every leaf's fp32 sum, in the model's order, hashed."""
    _, w = weights.build(smoke.config("hybrid"), 2**31 + 3, "cpu")
    fp = weights.fingerprint(w)
    assert fp.shape == (66,)
    assert hashlib.sha256(fp.numpy().tobytes()).hexdigest() == (
        "937bf0d09c8c04afdd50dbb3c3c20b13563c8fc27cdbe57267526d547a7aae55")


def _synthetic_run(conf):
    run = types.SimpleNamespace(conf=conf, t_open=0.0, t_close=10.0)
    run.window_prefills = lambda: [(0.0, 0.5, 2, 8, 12, 0)]
    run.window_decodes = lambda: [(0.5, 0.6, 2, 8, 0), (0.6, 0.7, 2, 9, 0)]
    return run


def test_step_mfu_reader():
    conf = smoke.config("hybrid")
    run = _synthetic_run(conf)
    want = (counts.prefill_flops(conf, 2, 8) + counts.decode_flops(conf, 2, 8)
            + counts.decode_flops(conf, 2, 9)) / (0.7 * 1e12) * 100
    assert readers.step_mfu(run, 1e12) == pytest.approx(want)


def test_roofline_reader():
    conf = smoke.config("hybrid")
    run = _synthetic_run(conf)
    run.profiled_prefills = [(0.0, 0.5, 2, 8, 12, 0)]
    run.trace = {"by_name": {"ssd_sm90_chunk_scan": 30.0, "ssd_sm90_state_pass": 10.0,
                             "flash_fwd_sm90<64>": 5.0, "other": 100.0}}
    shapes = counts.kernel_calls(conf, 2, 8)["k3"]
    bound = sum(counts.bound_ms(counts.k3_call(*s)[1], counts.k3_call(*s)[0], "tfloat32")[0]
                for s in shapes)
    got = readers.roofline(run, "k3", ("ssd_sm90_chunk_scan", "ssd_sm90_state_pass"),
                           "tfloat32")
    assert got == pytest.approx(100 * bound / 0.040)
    run.trace = None
    assert readers.roofline(run, "k3", ("ssd_sm90_",), "tfloat32") is None


def test_cells_have_their_files():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    s = Spec()
    for cell in spec["workloads"]:
        s.config(cell["config"]), s.mix(cell["traffic"])
        limits = s.settings(cell["name"])["limits"]
        assert limits and all(isinstance(v, float) and v > 0 for v in limits.values())
        for m in s.per_layer(cell["name"]):
            assert callable(s.reader(m["name"]).read)
    assert not math.isnan(counts.PEAK_OPS_S["bfloat16"])
