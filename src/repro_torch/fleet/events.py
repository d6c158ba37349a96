# lint: virtual-clock-module
"""Fleet traffic and node lifecycle events (open loop, fully seeded).

Cluster-scale serving sees traffic the single-engine generator
(:func:`repro_torch.serving.traffic.poisson_requests`) does not model:

* **Heavy-tailed prompt lengths** — most prompts are short, a few are
  very long (the classic production length distribution).  Lengths are
  drawn from a clipped Pareto tail over ``prompt_len=(lo, hi)``.
* **Diurnal rate swings** — the arrival rate is a seeded schedule
  ``rate(t) = base * (1 + swing * sin(2*pi*t/period))``, realized as a
  non-homogeneous Poisson process via thinning, so load crests and
  troughs sweep across the run.
* **Node failure / recovery** — :class:`NodeEvent` entries interleaved
  with arrivals drain a node mid-run and later return it, forcing the
  fleet router's ratio table to re-converge twice.

Everything is determined by ``seed`` — the property every CI assertion
in this repository leans on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving import Request

__all__ = ["diurnal_rate", "fleet_requests", "NodeEvent", "failure_window"]


def diurnal_rate(base_rate: float, swing: float = 0.5,
                 period: float = 60.0):
    """The seeded rate schedule ``rate(t)`` for :func:`fleet_requests`:
    a sinusoidal swing of amplitude ``swing * base_rate`` around
    ``base_rate`` with the given ``period`` (virtual seconds).  Returned
    as a plain callable so tests can probe it directly."""
    if base_rate <= 0:
        raise ValueError("base_rate must be > 0")
    if not 0 <= swing < 1:
        raise ValueError("swing must be in [0, 1)")

    def rate(t: float) -> float:
        return base_rate * (1.0 + swing * np.sin(2.0 * np.pi * t / period))

    return rate


def fleet_requests(n: int, *, base_rate: float, vocab_size: int,
                   prompt_len: Tuple[int, int],
                   max_new_tokens: int | Tuple[int, int],
                   swing: float = 0.5, period: float = 60.0,
                   tail: float = 2.0, seed: int = 0,
                   stop_token: Optional[int] = None) -> List[Request]:
    """``n`` open-loop requests under a diurnal rate schedule with
    heavy-tailed prompt lengths.

    Arrivals realize the non-homogeneous Poisson process of
    :func:`diurnal_rate` by thinning: candidate gaps are exponential at
    the peak rate ``base_rate * (1 + swing)`` and each candidate is
    accepted with probability ``rate(t) / peak`` — exact, and fully
    determined by ``seed``.

    Prompt lengths are ``lo + round(X * scale)`` clipped to ``hi`` where
    ``X ~ Pareto(tail)``: the bulk sits near ``lo`` with a tail reaching
    ``hi`` (smaller ``tail`` = heavier tail).  ``max_new_tokens`` may be
    a scalar or a uniform ``(lo, hi)`` range.
    """
    if n < 1:
        raise ValueError("need at least one request")
    lo, hi = prompt_len
    if not 1 <= lo <= hi:
        raise ValueError("prompt_len must satisfy 1 <= lo <= hi")
    rng = np.random.default_rng(seed)
    rate = diurnal_rate(base_rate, swing, period)
    peak = base_rate * (1.0 + swing)

    arrivals, t = [], 0.0
    while len(arrivals) < n:
        t += rng.exponential(1.0 / peak)
        if rng.uniform() <= rate(t) / peak:
            arrivals.append(t)

    # heavy-tailed lengths: Pareto tail scaled so the 8x-median ballpark
    # lands inside the range, then clipped to hi
    scale = max((hi - lo) / 8.0, 1.0)

    def draw_len() -> int:
        return min(hi, lo + int(round(rng.pareto(tail) * scale)))

    def draw_new() -> int:
        if isinstance(max_new_tokens, (int, np.integer)):
            return int(max_new_tokens)
        a, b = max_new_tokens
        return int(rng.integers(a, b + 1))

    out = []
    for i in range(n):
        s0 = draw_len()
        out.append(Request(
            prompt=rng.integers(0, vocab_size, size=s0, dtype=np.int32),
            max_new_tokens=draw_new(),
            arrival_time=float(arrivals[i]),
            stop_token=stop_token,
        ))
    return out


@dataclass(frozen=True)
class NodeEvent:
    """One node lifecycle event on the fleet timeline.

    ``kind="fail"`` drains the node: its queued (still-WAITING) requests
    are rerouted to surviving nodes, admitted work is aborted, and the
    node stops contributing feedback.  ``kind="recover"`` returns it to
    service (the router's table then re-learns its share).
    """

    time: float
    node: str
    kind: str  # "fail" | "recover"

    def __post_init__(self) -> None:
        if self.kind not in ("fail", "recover"):
            raise ValueError(f"unknown event kind {self.kind!r}")


def failure_window(node: str, fail_at: float,
                   recover_at: Optional[float] = None) -> List[NodeEvent]:
    """A fail event, plus the matching recovery when ``recover_at`` is
    given — the bench's mid-run outage in one call."""
    out = [NodeEvent(time=fail_at, node=node, kind="fail")]
    if recover_at is not None:
        if recover_at <= fail_at:
            raise ValueError("recover_at must be after fail_at")
        out.append(NodeEvent(time=recover_at, node=node, kind="recover"))
    return out
