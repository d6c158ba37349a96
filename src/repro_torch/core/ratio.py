"""Performance-ratio mathematics of the paper (Eqs. 1-3) plus the EMA filter.

The paper ("A dynamic parallel method for performance optimization on hybrid
CPUs", CS.DC 2024) models a parallel problem of size ``K`` solved by ``N``
workers with (unknown, drifting) throughputs.  Worker ``i`` holds a
*performance ratio* ``pr_i``; the scheduler assigns it a share

    s_i = pr_i / sum_j(pr_j) * s                                   (Eq. 3)

of the parallel dimension ``s``, which is makespan-optimal when the ratios
equal the true relative throughputs (Eq. 1).  After every parallel region the
observed per-worker times ``t_i`` update the table via

    pr_i' = pr_i / (t_i * sum_j(pr_j / t_j))                       (Eq. 2)

(i.e. the normalized *observed speed* ``(pr_i/t_i) / sum_j(pr_j/t_j)``),
followed by an exponential filter ``pr_i <- alpha*pr_i + (1-alpha)*pr_i'``.

Normalization note: Eq. 2 as printed normalizes the ratios to sum to 1,
while the paper initializes every ratio to 1 (sum = N) and Fig. 4 plots a
P-core ratio stabilizing near 3.5 on a 14-core part — both only consistent
with a *mean*-normalized table (sum = N).  Since Eq. 3 is scale-invariant,
the two conventions are behaviourally identical; we default to ``"mean"``
so that a homogeneous machine keeps the paper's all-ones table and Fig. 4
magnitudes reproduce, and keep ``"sum"`` available for the literal form.
"""

# lint: virtual-clock-module
from __future__ import annotations

import numpy as np

__all__ = [
    "optimal_shares",
    "observed_ratios",
    "ema_update",
    "proportional_partition",
    "partition_ranges",
    "makespan",
]


def optimal_shares(ratios: np.ndarray) -> np.ndarray:
    """Eq. 1: the makespan-minimizing fractional shares ``theta_i``."""
    ratios = np.asarray(ratios, dtype=np.float64)
    if np.any(ratios < 0):
        raise ValueError("performance ratios must be non-negative")
    total = ratios.sum()
    if total <= 0:
        # Degenerate: nothing is known to be able to work; split evenly.
        return np.full_like(ratios, 1.0 / len(ratios))
    return ratios / total


def observed_ratios(
    ratios: np.ndarray, times: np.ndarray, *, normalize: str = "mean"
) -> np.ndarray:
    """Eq. 2: new ratios from the previous table and observed times.

    ``pr_i' = (pr_i / t_i) / sum_j (pr_j / t_j)`` — the speed each worker
    *demonstrated* this round (its assigned share was proportional to
    ``pr_i``, it took ``t_i``, hence speed ``pr_i/t_i``), renormalized.

    Workers that received no work report ``t_i == 0`` (or NaN); their ratio
    is carried over unchanged (renormalized with the rest).  A round in
    which only *one* of several workers was measured is also carried over
    whole: a singleton observation has no relative information, and
    normalizing it (to 1.0 under "mean") would erase whatever
    heterogeneity the table has already learned.
    """
    ratios = np.asarray(ratios, dtype=np.float64)
    times = np.asarray(times, dtype=np.float64)
    if ratios.shape != times.shape:
        raise ValueError("ratios and times must have the same shape")
    n = len(ratios)
    valid = np.isfinite(times) & (times > 0) & (ratios > 0)
    if not np.any(valid) or (n > 1 and valid.sum() == 1):
        return ratios.copy()
    if normalize not in ("mean", "sum"):
        raise ValueError("normalize must be 'mean' or 'sum'")
    speed = np.zeros_like(ratios)
    speed[valid] = ratios[valid] / times[valid]
    denom = speed[valid].sum()
    new = np.array(ratios, copy=True)
    if denom > 0:
        scale = float(valid.sum()) if normalize == "mean" else 1.0
        new[valid] = speed[valid] / denom * scale
    return new


def ema_update(
    ratios: np.ndarray, new_ratios: np.ndarray, alpha: float = 0.3
) -> np.ndarray:
    """The paper's constant-gain filter: ``alpha*pr + (1-alpha)*pr'``."""
    if not 0.0 <= alpha <= 1.0:
        raise ValueError("alpha must be in [0, 1]")
    ratios = np.asarray(ratios, dtype=np.float64)
    new_ratios = np.asarray(new_ratios, dtype=np.float64)
    return alpha * ratios + (1.0 - alpha) * new_ratios


def proportional_partition(
    s: int, ratios: np.ndarray, granularity: int = 1
) -> np.ndarray:
    """Eq. 3 with integer/tile constraints: split ``s`` units into per-worker
    counts ``s_i`` such that

      * ``sum(s_i) == s``,
      * each ``s_i`` is a multiple of ``granularity`` (except that the
        largest-share worker absorbs the non-divisible remainder),
      * ``s_i`` is (largest-remainder) rounded from the ideal real share
        ``pr_i / sum(pr) * s``.

    Returns an int64 array of length ``len(ratios)``.
    """
    if s < 0:
        raise ValueError("s must be non-negative")
    if granularity < 1:
        raise ValueError("granularity must be >= 1")
    ratios = np.asarray(ratios, dtype=np.float64)
    n = len(ratios)
    if n == 0:
        raise ValueError("need at least one worker")
    shares = optimal_shares(ratios)

    tiles, rem = divmod(s, granularity)
    # Floor of the ideal share, then makespan-aware greedy for the remainder:
    # each leftover tile goes to the worker whose completion time after
    # receiving it is smallest (LPT-style).  This is Eq. 3 up to integer
    # rounding and strictly dominates largest-remainder rounding when tiles
    # are coarse relative to slow workers' shares.
    ideal = shares * tiles
    base = np.floor(ideal).astype(np.int64)
    short = int(tiles - base.sum())
    if short > 0:
        pos = ratios > 0
        if not pos.any():
            pos = np.ones(n, dtype=bool)
        safe_pr = np.where(pos, np.where(ratios > 0, ratios, 1.0), 1.0)
        for _ in range(short):
            t_after = np.where(pos, (base + 1) / safe_pr, np.inf)
            base[int(np.argmin(t_after))] += 1
    counts = base * granularity
    if rem:
        # The non-divisible tail goes to the fastest worker (it hurts least).
        counts[int(np.argmax(ratios))] += rem
    assert counts.sum() == s
    return counts


def partition_ranges(
    s: int, ratios: np.ndarray, granularity: int = 1
) -> list[tuple[int, int]]:
    """Contiguous ``[start, end)`` ranges per worker (the paper splits along
    one dimension into contiguous blocks, preserving cache locality)."""
    counts = proportional_partition(s, ratios, granularity)
    out, cursor = [], 0
    for c in counts:
        out.append((cursor, cursor + int(c)))
        cursor += int(c)
    return out


def makespan(counts: np.ndarray, true_throughput: np.ndarray) -> float:
    """T = max_i (s_i / throughput_i) — the quantity Eq. 1 minimizes."""
    counts = np.asarray(counts, dtype=np.float64)
    tp = np.asarray(true_throughput, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(counts > 0, counts / tp, 0.0)
    return float(np.max(t))
