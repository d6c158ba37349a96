"""Open loop: Poisson arrivals at ``rate`` requests a second from
independent users, sent on schedule whatever the engine's progress.

Parameters: ``rate``; ``prompt`` and ``output`` length distributions;
``sequence_seed``; the engine's ``slots``, ``prefill_chunk`` and
``prefill_lanes``.  A window of ``seconds`` holds ``round(rate * seconds)``
arrivals.  Their gaps are the exponential distribution's stratified
quantiles, scaled so that they add up to the window; gaps and lengths go
in one order drawn from ``sequence_seed``; a run takes that sequence
rotated to start where its seed says, the first arrival at the window's
start.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from perfbench.harness.traffic import Req, lengths, prompt_ids, rotation


def gaps(rate: float, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` exponential gaps of mean ``1 / rate`` at stratified
    quantiles, rescaled to sum to ``n / rate``, in an order from ``rng``."""
    q = np.array([-math.log(1.0 - (i + 0.5) / n) for i in range(n)])
    q *= n / rate / q.sum()
    return q[rng.permutation(n)]


class Traffic:
    open_loop = True

    def __init__(self, params: dict, seed: int, vocab_size: int,
                 seconds: float):
        rate = float(params["rate"])
        n = max(1, int(round(rate * seconds)))
        seq = np.random.default_rng(int(params["sequence_seed"]))
        rows = np.stack([gaps(rate, n, seq), lengths(params["prompt"], n, seq),
                         lengths(params["output"], n, seq)], axis=1)
        rows = np.roll(rows, -rotation(seed, n), axis=0)
        due = np.concatenate([[0.0], np.cumsum(rows[:-1, 0])])
        ids = np.random.default_rng(seed)
        self.pending: List[Req] = [
            Req(prompt=prompt_ids(ids, int(s0), vocab_size), max_new=int(o),
                due=float(t), client=i)
            for i, (t, (_, s0, o)) in enumerate(zip(due, rows))]
        self.pending.reverse()       # pop() from the end: earliest first

    def initial(self) -> List[Req]:
        return []

    def due(self, t: float) -> List[Req]:
        """Every request due by window second ``t``, earliest first."""
        out = []
        while self.pending and self.pending[-1].due <= t:
            out.append(self.pending.pop())
        return out

    def next_due(self):
        return self.pending[-1].due if self.pending else None

    def finished(self, req: Req, t) -> List[Req]:
        return []
