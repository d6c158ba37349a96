"""Deterministic open-loop traffic generation (seeded Poisson arrivals).

Open-loop means arrival times are drawn independently of service progress
(the "millions of users" regime: clients do not wait for each other), so
the same seed always produces the same trace — the property the serving
benchmark and CI smoke runs rely on.
"""

# lint: virtual-clock-module
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .request import Request

__all__ = ["poisson_requests"]


def poisson_requests(n: int, *, rate: float, vocab_size: int,
                     prompt_len: int | Sequence[int],
                     max_new_tokens: int | Sequence[int],
                     seed: int = 0,
                     stop_token: Optional[int] = None) -> List[Request]:
    """``n`` requests with exponential inter-arrival gaps at ``rate`` req/s
    (``rate <= 0``: everything arrives at t=0).  ``prompt_len`` /
    ``max_new_tokens`` may be scalars or ``(lo, hi)`` ranges sampled
    uniformly per request.  Fully determined by ``seed``."""
    if n < 1:
        raise ValueError("need at least one request")
    rng = np.random.default_rng(seed)
    gaps = (rng.exponential(1.0 / rate, size=n) if rate > 0
            else np.zeros(n))
    gaps[0] = 0.0  # first request arrives at t=0
    arrivals = np.cumsum(gaps)

    def draw(spec) -> int:
        if isinstance(spec, (int, np.integer)):
            return int(spec)
        lo, hi = spec
        return int(rng.integers(lo, hi + 1))

    out = []
    for i in range(n):
        s0 = draw(prompt_len)
        out.append(Request(
            prompt=rng.integers(0, vocab_size, size=s0, dtype=np.int32),
            max_new_tokens=draw(max_new_tokens),
            arrival_time=float(arrivals[i]),
            stop_token=stop_token,
        ))
    return out
