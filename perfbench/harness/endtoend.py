"""The end-to-end metrics, from the client's stamps on the wall clock.

* ``decode_tok_s``: every token delivered in the window over its seconds;
* ``tpot_p95_ms``, ``tpot_p99_ms``: the 95th and 99th percentiles of
  every gap between consecutive deliveries to a request that ends in the
  window (two tokens delivered by one step are one delivery, as a
  streaming client gets them);
* ``ttft_p<N>_ms``: the ``N``th percentile, over every request due in the
  window, of its first token minus its due time (a request that never got
  one counts as infinitely late); ``tpot_p<N>_ms`` likewise of the gaps;
* ``setup_s``: process start to the window's start.

Percentiles interpolate linearly between order statistics (numpy's
default), as the port's ``serving/metrics.py`` ``percentiles`` does.
"""

from __future__ import annotations

import math
import re
from typing import List, Sequence

import numpy as np


def percentile(values: Sequence[float], p: float) -> float:
    """numpy's linear percentile, but an order statistic that the rank hits
    exactly is taken as it is, so that an infinitely late request above it
    gives no NaN."""
    if len(values) == 0:
        return float("nan")
    a = np.sort(np.asarray(values, dtype=np.float64))
    pos = p / 100.0 * (len(a) - 1)
    lo = int(math.floor(pos))
    frac = pos - lo
    if frac == 0.0:
        return float(a[lo])
    return float(a[lo] + (a[lo + 1] - a[lo]) * frac)


def decode_tok_s(reqs, origin: float, close: float) -> float:
    n = sum(k for r in reqs for t, k in r.stamps if origin < t <= close)
    return n / (close - origin)


def token_gaps(reqs, origin: float, close: float) -> List[float]:
    out = []
    for r in reqs:
        for (a, _), (b, _) in zip(r.stamps, r.stamps[1:]):
            if origin < b <= close:
                out.append(b - a)
    return out


def tpot_p95_ms(reqs, origin: float, close: float) -> float:
    return 1e3 * percentile(token_gaps(reqs, origin, close), 95)


def tpot_p99_ms(reqs, origin: float, close: float) -> float:
    return 1e3 * percentile(token_gaps(reqs, origin, close), 99)


def ttfts(reqs, origin: float, seconds: float) -> List[float]:
    out = []
    for r in reqs:
        if r.due is None or not 0.0 <= r.due < seconds:
            continue
        ft = r.first_token
        out.append(math.inf if ft is None else ft - (origin + r.due))
    return out


def summary(reqs, origin: float, close: float) -> str:
    """Every statistic of the window on one line, for the run's log."""
    seconds = close - origin
    gaps = token_gaps(reqs, origin, close)
    tt = ttfts(reqs, origin, seconds)
    parts = [f"decode_tok_s={decode_tok_s(reqs, origin, close):.4f}",
             f"gaps={len(gaps)}"]
    for p in (50, 90, 95, 99):
        parts.append(f"tpot_p{p}_ms={1e3 * percentile(gaps, p):.3f}")
    parts.append(f"due={len(tt)}")
    for p in (50, 83, 90, 95):
        parts.append(f"ttft_p{p}_ms={1e3 * percentile(tt, p):.3f}")
    return " ".join(parts)


def compute(names, reqs, origin: float, close: float,
            setup_s: float) -> dict:
    seconds = close - origin
    out = {}
    for n in names:
        tail = re.fullmatch(r"(tpot|ttft)_p(\d+)_ms", n)
        if n == "decode_tok_s":
            out[n] = decode_tok_s(reqs, origin, close)
        elif n == "setup_s":
            out[n] = setup_s
        elif tail and tail[1] == "tpot":
            out[n] = 1e3 * percentile(token_gaps(reqs, origin, close),
                                      int(tail[2]))
        elif tail:
            out[n] = 1e3 * percentile(ttfts(reqs, origin, seconds),
                                      int(tail[2]))
        else:
            raise KeyError(f"no end-to-end metric {n!r}")
    return out
