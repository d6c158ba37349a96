"""The traffic generators: deterministic by seed, every seed the same set of
sizes and arrivals in another order, and the lengths the cells' files
state."""

import json
import statistics
from pathlib import Path

import numpy as np
import pytest

from perfbench.harness.traffic import lengths, load_kind, quantile

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"


def mix(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


def closed(seed, n_blocks=3):
    gen = load_kind("closed_loop")(mix("long-decode"), seed, 49152, 30.0)
    first = gen.initial()
    later = []
    for _ in range(n_blocks):
        for r in first:
            later += gen.finished(r, 1.0)
    return first, later


def poisson(seed, seconds=51.0):
    gen = load_kind("poisson")(mix("chat-short"), seed, 49155, seconds)
    return gen.due(1e9)


def key(reqs):
    return [(r.prompt.tolist(), r.max_new, r.due) for r in reqs]


def test_same_seed_same_requests():
    assert key(closed(7)[0] + closed(7)[1]) == \
        key(closed(7)[0] + closed(7)[1])
    assert key(poisson(2 ** 31 + 5)) == key(poisson(2 ** 31 + 5))
    assert key(poisson(1)) != key(poisson(2))


def rows(reqs):
    return [(len(r.prompt), r.max_new) for r in reqs]


def is_rotation(a, b):
    return len(a) == len(b) and any(a[k:] + a[:k] == b for k in range(len(a)))


def test_seeds_take_one_sequence_in_another_order():
    # the open loop: the same (gap, prompt, output) rows, rotated
    a, b = poisson(12), poisson(4_000_000_123)
    ga = list(zip(np.diff([r.due for r in a]).round(9), rows(a)))
    gb = list(zip(np.diff([r.due for r in b]).round(9), rows(b)))
    assert ga != gb
    assert sorted(rows(a)) == sorted(rows(b))
    assert is_rotation(rows(a), rows(b))
    assert len(set(ga) & set(gb)) >= len(ga) - 1
    # the closed loop: the first block rotated among the clients, the
    # later requests from one cycle, entered elsewhere
    (fa, la), (fb, lb) = closed(12), closed(4_000_000_123)
    assert rows(fa) != rows(fb) and is_rotation(rows(fa), rows(fb))
    assert rows(la) != rows(lb) and set(rows(la)) <= set(
        map(tuple, closed_cycle()))


def closed_cycle():
    gen = load_kind("closed_loop")(mix("long-decode"), 0, 49152, 30.0)
    return gen.later.tolist()


def test_poisson_gaps_are_one_set():
    from perfbench.traffic.poisson import gaps

    a = gaps(1.2, 61, np.random.default_rng(1))
    b = gaps(1.2, 61, np.random.default_rng(2))
    assert np.array_equal(np.sort(a), np.sort(b))
    assert not np.array_equal(a, b)
    assert abs(a.sum() - 61 / 1.2) < 1e-9


def test_closed_loop_lengths():
    first, later = closed(3, n_blocks=4)
    m = mix("long-decode")
    assert len(first) == m["clients"]
    outs = [r.max_new for r in first]
    assert 1 <= min(outs) and max(outs) <= 2048
    # the residual life: spread over 1..2048, stratified
    assert abs(statistics.median(outs) - 1024) < 64
    assert all(1024 <= r.max_new <= 2048 for r in later)
    assert all(64 <= len(r.prompt) <= 512 for r in first + later)
    assert {r.client for r in later} == set(range(m["clients"]))
    assert all(r.due == 1.0 for r in later)


def test_poisson_arrivals_and_lengths():
    m = mix("chat-short")
    reqs = poisson(9, seconds=50.0)
    assert len(reqs) == round(m["rate"] * 50.0)
    dues = [r.due for r in reqs]
    assert dues[0] == 0.0 and dues == sorted(dues) and dues[-1] < 50.0
    gaps = np.diff(dues)
    assert abs(np.mean(gaps) - 1 / m["rate"]) < 0.1 / m["rate"]
    # exponential: the coefficient of variation is about 1
    assert 0.8 < np.std(gaps) / np.mean(gaps) < 1.2
    plen = [len(r.prompt) for r in reqs]
    assert 32 <= min(plen) and max(plen) <= 1024
    assert abs(statistics.median(plen) - 256) <= 16
    assert all(32 <= r.max_new <= 256 for r in reqs)


def test_quantiles():
    u = {"dist": "uniform", "lo": 1, "hi": 4}
    assert sorted(lengths(u, 4, np.random.default_rng(0))) == [1, 2, 3, 4]
    ln = {"dist": "lognormal", "median": 256, "sigma": 0.8, "lo": 32,
          "hi": 1024}
    assert quantile(ln, 0.5) == 256
    assert quantile(ln, 1e-9) == 32 and quantile(ln, 1 - 1e-9) == 1024
    with pytest.raises(ValueError):
        quantile({"dist": "zipf", "lo": 1, "hi": 2}, 0.5)
