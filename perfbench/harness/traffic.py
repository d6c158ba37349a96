"""The general part of traffic generation: the request record, stratified
length draws, and the lookup of a generator kind by name.

Every seed gets the same sizes and arrivals, in another order: a length
distribution is sampled at the quantiles ``(i + 0.5) / n`` of a block of
``n`` requests, put in one order drawn from the mix's own
``sequence_seed``, and the run's seed only chooses where in that sequence
(a rotation) the run starts, and draws the token ids.  A free shuffle per
seed would change the work: how requests bunch up sets the queue, and so
the tails (a 51 s open-loop window at 1.2 requests a second spreads its
ttft_p95 by a third from seed to seed, shuffled).

A kind is a module ``perfbench/traffic/<kind>.py`` with a class
``Traffic(params, seed, vocab_size, seconds)``; see
``perfbench/traffic/closed_loop.py`` and ``perfbench/traffic/poisson.py``.
"""

from __future__ import annotations

import importlib
import math
from dataclasses import dataclass, field
from statistics import NormalDist
from typing import List, Optional, Tuple

import numpy as np


@dataclass(eq=False)
class Req:
    """One request as the client sees it.  ``due`` is the window-relative
    second it was due to be sent (None for one sent during set-up);
    ``stamps`` are (wall second, tokens delivered) after each step that
    delivered tokens to it."""

    prompt: np.ndarray
    max_new: int
    due: Optional[float] = None
    client: int = -1
    request: object = None          # the program's Request once submitted
    submitted: Optional[float] = None
    first_chunk: Optional[float] = None
    stamps: List[Tuple[float, int]] = field(default_factory=list)
    n_seen: int = 0
    prefill_seen: int = 0
    done: Optional[float] = None

    @property
    def first_token(self) -> Optional[float]:
        return self.stamps[0][0] if self.stamps else None


def quantile(spec: dict, u: float) -> int:
    """The ``u`` quantile of a length distribution: ``uniform`` integers
    in [lo, hi], or ``lognormal`` (``median``, ``sigma``) rounded and
    clipped to [lo, hi]."""
    lo, hi = int(spec["lo"]), int(spec["hi"])
    if spec["dist"] == "uniform":
        return min(hi, lo + int(math.floor(u * (hi - lo + 1))))
    if spec["dist"] == "lognormal":
        z = NormalDist().inv_cdf(u)
        v = float(spec["median"]) * math.exp(float(spec["sigma"]) * z)
        return int(min(hi, max(lo, round(v))))
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` lengths at the block's stratified quantiles, in an order drawn
    from ``rng`` (the mix's sequence generator)."""
    vals = np.array([quantile(spec, (i + 0.5) / n) for i in range(n)],
                    dtype=np.int64)
    return vals[rng.permutation(n)]


def rotation(seed: int, n: int) -> int:
    """Where a run of ``seed`` starts in a sequence of ``n``."""
    return int(np.random.default_rng([seed, 1]).integers(n))


def prompt_ids(rng: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    return rng.integers(0, vocab, size=int(n), dtype=np.int32)


def load_kind(kind: str):
    """The generator class of ``perfbench/traffic/<kind>.py``."""
    if not kind.replace("_", "").isalnum():
        raise ValueError(f"bad traffic kind {kind!r}")
    return importlib.import_module(f"perfbench.traffic.{kind}").Traffic
