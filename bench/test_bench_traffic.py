"""The traffic generator: deterministic by seed, independent draws, and as
its mix file says."""
import json
import math

import numpy as np
import pytest

from benchlib.spec import BENCH
from benchlib.traffic import CHUNK, Traffic, draw_lengths, seed_key

MIXES = ["chat", "longprompt"]


def due(t, n):
    return np.cumsum([t.gap(i) for i in range(n)])


def mix(name):
    return json.loads((BENCH / "mixes" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_traffic(name):
    m = mix(name)
    a, b = Traffic(m, 2**31 + 11, 32000), Traffic(m, 2**31 + 11, 32000)
    assert [a.prompt_len(i) for i in range(300)] == [b.prompt_len(i) for i in range(300)]
    assert a.prompt(17) == b.prompt(17)
    if m["loop"] == "open":
        assert np.array_equal(due(a, 200), due(b, 200))


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_other_draws(name):
    # every seed draws its own lengths and arrivals: not a reordering of
    # one set, so the work offered varies from seed to seed
    m = mix(name)
    a, b = Traffic(m, 1, 32000), Traffic(m, 2, 32000)
    la = [a.prompt_len(i) for i in range(256)]
    lb = [b.prompt_len(i) for i in range(256)]
    assert sorted(la) != sorted(lb)
    if m["loop"] == "open":
        assert sorted(a.gap(i) for i in range(64)) != sorted(b.gap(i) for i in range(64))


@pytest.mark.parametrize("name", MIXES)
def test_lengths_follow_the_file(name):
    m = mix(name)
    t = Traffic(m, seed_key(-5), 32000)
    n = 2 * CHUNK + 100                          # across chunk boundaries
    lens = np.array([t.prompt_len(i) for i in range(n)])
    p = m["prompt"]
    assert lens.min() >= p["min"] and lens.max() <= p["max"]
    if p["dist"] == "lognormal":
        # below min and above max the draws are clipped, not redrawn
        assert np.median(lens) == pytest.approx(p["median"], rel=0.08)
        z = (math.log(p["max"] / p["median"])) / p["sigma"]
        above = 0.5 * math.erfc(z / math.sqrt(2))
        assert np.mean(lens == p["max"]) == pytest.approx(above, abs=0.015)
    else:
        logs = np.log(lens / p["min"]) / math.log(p["max"] / p["min"])
        assert np.mean(logs) == pytest.approx(0.5, abs=0.03)
    prompt = t.prompt(3)
    assert len(prompt) == t.prompt_len(3) and 1 <= min(prompt) and max(prompt) < 32000


def test_open_loop_is_poisson_at_the_files_rate():
    m = mix("chat")
    t = Traffic(m, 7, 32000)
    n = 4000
    gaps = np.array([t.gap(i) for i in range(n)])
    assert np.all(gaps > 0)
    assert n / gaps.sum() == pytest.approx(m["rate_per_s"], rel=0.05)
    # exponential gaps: the coefficient of variation is 1, and the time to
    # fill a batch of 64 varies from batch to batch by about 1/8
    assert gaps.std() / gaps.mean() == pytest.approx(1.0, abs=0.08)
    fill = gaps[:64 * 60].reshape(60, 64).sum(1)
    assert fill.std() / fill.mean() == pytest.approx(1 / 8, rel=0.35)


def test_draw_lengths_refuses_an_unknown_distribution():
    rng = np.random.default_rng(0)
    assert draw_lengths({"dist": "loguniform", "min": 5, "max": 5}, rng, 3).tolist() == [5] * 3
    with pytest.raises(ValueError):
        draw_lengths({"dist": "pareto", "min": 1, "max": 2}, rng, 3)
