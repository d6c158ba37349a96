"""The window's arithmetic on the client's stamps: a stall inside the window
lowers ``decode_tok_s`` and raises the tails; a request is timed from when
it was due; the trace's busy time and idle gaps."""

import numpy as np
import pytest

from perfbench.harness import endtoend
from perfbench.harness.trace import Slice
from perfbench.harness.traffic import Req


def steady(n_req=4, steps=100, dt=0.05, stall_at=None, stall=0.0):
    """``n_req`` requests each delivered one token a step of ``dt`` s; with
    ``stall`` s added before step ``stall_at``."""
    reqs = [Req(prompt=np.zeros(4, np.int32), max_new=steps, due=0.0)
            for _ in range(n_req)]
    t = 0.0
    for i in range(steps):
        t += dt + (stall if i == stall_at else 0.0)
        for r in reqs:
            r.stamps.append((t, 1))
    return reqs, t


def test_stall_lowers_rate_and_raises_tails():
    base, _ = steady()
    stalled, _ = steady(stall_at=50, stall=1.0)
    close = 5.0
    assert endtoend.decode_tok_s(base, 0.0, close) == pytest.approx(
        4 * 100 / 5.0)
    assert endtoend.decode_tok_s(stalled, 0.0, close) < \
        endtoend.decode_tok_s(base, 0.0, close)
    assert endtoend.tpot_p95_ms(base, 0.0, close) == pytest.approx(50.0)
    # one gap of 1.05 s in each of 4 requests' 79 gaps inside the window:
    # below the 95th percentile's rank, so the tail moves only when more do
    many, _ = steady(stall_at=None)
    for k in range(0, 100, 10):
        for r in many:
            r.stamps[k:] = [(t + 0.5, n) for t, n in r.stamps[k:]]
    assert endtoend.tpot_p95_ms(many, 0.0, 10.0) > 500.0
    # the 99th percentile sees a stall in one gap of 100 or more
    assert endtoend.tpot_p99_ms(base, 0.0, close) == pytest.approx(50.0)
    assert endtoend.tpot_p99_ms(stalled, 0.0, close) > 500.0


def test_only_the_window_counts():
    reqs, _ = steady(steps=100, dt=0.1)     # 10 s of tokens
    assert endtoend.decode_tok_s(reqs, 2.0, 4.0) == pytest.approx(4 * 10)
    assert len(endtoend.token_gaps(reqs, 2.0, 4.0)) == 4 * 20


def test_ttft_from_due():
    r1 = Req(prompt=np.zeros(2, np.int32), max_new=2, due=1.0)
    r1.stamps = [(13.5, 2)]                 # window from 10: due at 11
    r2 = Req(prompt=np.zeros(2, np.int32), max_new=2, due=2.0)   # never
    r3 = Req(prompt=np.zeros(2, np.int32), max_new=2, due=None)  # set-up
    r3.stamps = [(10.1, 1)]
    assert endtoend.ttfts([r1, r2, r3], 10.0, 30.0) == [2.5, float("inf")]
    r4 = Req(prompt=np.zeros(2, np.int32), max_new=2, due=31.0)
    r4.stamps = [(41.2, 1)]                 # due after the window
    assert endtoend.ttfts([r1, r4], 10.0, 30.0) == [2.5]
    # the metrics by name: a percentile of every request due in the window
    r5 = Req(prompt=np.zeros(2, np.int32), max_new=2, due=3.0)
    r5.stamps = [(13.5, 1)]
    got = endtoend.compute(["ttft_p50_ms", "tpot_p99_ms", "setup_s"],
                           [r1, r4, r5], 10.0, 40.0, 7.0)
    assert got["ttft_p50_ms"] == pytest.approx(1500.0)
    assert got["setup_s"] == 7.0
    with pytest.raises(KeyError):
        endtoend.compute(["ttft_mean_ms"], [r1], 10.0, 40.0, 7.0)


def test_ttft_reader_is_the_median_of_due_requests():
    from types import SimpleNamespace

    from perfbench.harness.cell import _load_reader
    from perfbench.harness.spec import ROOT

    read = _load_reader(ROOT / "perfbench/metrics/ttft_p50_ms.chat.py")
    reqs = []
    for due, first in ((1.0, 13.5), (2.0, 12.5), (3.0, 13.4), (31.0, 41.2)):
        r = Req(prompt=np.zeros(2, np.int32), max_new=2, due=due)
        r.stamps = [(first, 1)]
        reqs.append(r)
    view = SimpleNamespace(requests=reqs, origin=10.0, seconds=30.0)
    assert read(view) == pytest.approx(500.0)   # 2.5, 0.5, 0.4 s
    reqs[1].stamps = []                         # never served
    assert read(view) == pytest.approx(2500.0)
    assert endtoend.percentile([0.4, 2.5, 3.0, float("inf")], 50) == \
        pytest.approx(2.75)
    assert endtoend.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 99) == \
        pytest.approx(float(np.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 99)))
    assert read(SimpleNamespace(requests=reqs[3:], origin=10.0,
                                seconds=30.0)) is None


def test_two_tokens_of_one_step_are_one_delivery():
    r = Req(prompt=np.zeros(2, np.int32), max_new=4, due=0.0)
    r.stamps = [(1.0, 2), (1.1, 1), (1.2, 1)]
    assert endtoend.token_gaps([r], 0.0, 2.0) == pytest.approx([0.1, 0.1])
    assert endtoend.decode_tok_s([r], 0.0, 2.0) == pytest.approx(2.0)


def test_trace_busy_and_gaps():
    sl = Slice(start=0, end=100,
               device=[("a", 10, 30), ("b", 20, 40), ("a", 60, 70),
                       ("c", 95, 120)],
               iterations=[(0, 50), (50, 100)],
               host=[("feedback", 40, 60), ("pick", 70, 95)])
    assert sl.busy_intervals() == [(10, 40), (60, 70), (95, 100)]
    assert sl.busy_s == pytest.approx(45e-9)
    assert sl.window_s == pytest.approx(100e-9)
    gaps = dict((k, v) for k, v in sl.idle_gaps())
    assert gaps == {"harness": pytest.approx(10e-9),
                    "feedback": pytest.approx(20e-9),
                    "pick": pytest.approx(25e-9)}
    ops = sl.by_iteration()
    assert [len(o) for o in ops] == [2, 2]
    assert sl.device_ops(1) == [["a", pytest.approx(30e-9)]]
