"""Runtime invariant contracts for the balancing stack.

The paper's loop only works if a handful of numeric invariants hold at every
step; this module turns them into toggleable contracts checked *inside* the
hot paths:

* **IV001 — EMA boundedness.** ``RatioTable.observe`` must produce a convex
  combination: every updated ratio lies in the elementwise envelope of the
  previous ratio and the observation, and stays finite and positive.
* **IV002 — observation normalization.** A normalized observation fed into
  the EMA must satisfy the table's ``normalize`` convention (mean 1 over the
  valid workers for ``"mean"``, sum 1 for ``"sum"``).
* **IV003 — offset boundaries.** ``OffsetSnapshot`` boundaries are monotone
  *non-decreasing* (not strictly increasing) int32 cumsums starting at 0 and
  ending at exactly ``N`` — the device-side guarantee that compiled shards
  tile ``[0, N)``.  Equal adjacent boundaries are legal and meaningful:
  ``b[w] == b[w + 1]`` is worker ``w``'s zero-width shard, the fixed-shape
  encoding of a parked core under an elastic-capacity mask.
* **IV004 — plan partition.** Every shard plan's counts are non-negative and
  sum to exactly ``N``: contiguous shards partition the N-dim with no gap
  and no overlap.
* **IV005 — bytes conservation.** In two-level dispatch, the bytes a region
  adds to the aggregate accounting equal the bytes added across the
  per-socket dispatchers.

Contracts are **off by default** (the checks cost a cached-flag test).
Enable with ``REPRO_ANALYSIS_CONTRACTS=1`` in the environment (read once at
import), or programmatically / in tests::

    from repro_torch.analysis import invariants
    with invariants.contracts():
        engine.run(...)

A violated contract raises :class:`ContractViolation` (an ``AssertionError``
subclass, so ``pytest`` reports it as a failure, not an error), after asking
an installed flight recorder (:mod:`repro.obs.recorder`) to dump its decision
ring.  This module imports only numpy and the stdlib-only events shim so
instrumented call sites stay cheap to import.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

import numpy as np

from repro_torch.core import events as _ev

from .findings import Finding

__all__ = [
    "RULES",
    "ContractViolation",
    "contracts_enabled",
    "enable",
    "disable",
    "contracts",
    "check_ema_step",
    "check_observation",
    "check_offset_boundaries",
    "check_plan_partition",
    "check_bytes_conserved",
    "run_pass",
]

RULES = {
    "IV001": "RatioTable EMA update left the [prev, observed] envelope or "
             "produced a non-finite/non-positive ratio",
    "IV002": "normalized observation violates the table's normalize "
             "convention (mean/sum over valid workers)",
    "IV003": "OffsetSnapshot boundaries are not a monotone int32 cumsum "
             "covering [0, N) exactly",
    "IV004": "shard plan does not partition the N-dim (negative count or "
             "counts do not sum to N)",
    "IV005": "bytes-moved accounting not conserved across socket/aggregate "
             "levels",
}

_ENV = os.environ.get("REPRO_ANALYSIS_CONTRACTS", "").strip().lower() in (
    "1", "true", "yes", "on")
_FORCED = None  # tri-state test/CLI override: None = follow env


class ContractViolation(AssertionError):
    """A runtime invariant contract failed."""

    def __init__(self, rule: str, message: str):
        self.rule = rule
        super().__init__(f"[{rule}] {message}")


def contracts_enabled() -> bool:
    """True when contract checks should run (env var or explicit override)."""
    if _FORCED is not None:
        return _FORCED
    return _ENV


def enable() -> None:
    global _FORCED
    _FORCED = True


def disable() -> None:
    global _FORCED
    _FORCED = False


@contextmanager
def contracts(on: bool = True):
    """Force contracts on (or off) within a block, restoring the previous
    override on exit."""
    global _FORCED
    prev = _FORCED
    _FORCED = on
    try:
        yield
    finally:
        _FORCED = prev


def _fail(rule: str, message: str):
    # A tripped contract is exactly the anomaly the flight recorder exists
    # for: dump the decision ring before raising so the violation ships with
    # the balancer decisions that led up to it.
    rec = _ev.RECORDER
    if rec is not None:
        trip = getattr(rec, "trip", None)
        if trip is not None:
            trip(f"contract {rule}: {message}")
    raise ContractViolation(rule, message)


# ----------------------------------------------------------------- checks --
# Checks are unconditional when called; call sites gate on
# ``contracts_enabled()`` so the disabled path never builds arrays.

def check_ema_step(prev, observed, updated, *, where: str = "RatioTable.observe") -> None:
    """IV001: ``updated`` is a convex combination of ``prev`` and ``observed``."""
    prev = np.asarray(prev, dtype=np.float64)
    observed = np.asarray(observed, dtype=np.float64)
    updated = np.asarray(updated, dtype=np.float64)
    if not np.all(np.isfinite(updated)):
        _fail("IV001", f"{where}: non-finite ratio after EMA: {updated}")
    if np.any(updated <= 0):
        _fail("IV001", f"{where}: non-positive ratio after EMA: {updated}")
    lo = np.minimum(prev, observed)
    hi = np.maximum(prev, observed)
    eps = 1e-9 + 1e-9 * np.maximum(np.abs(lo), np.abs(hi))
    if np.any(updated < lo - eps) or np.any(updated > hi + eps):
        _fail("IV001",
              f"{where}: EMA left the [prev, observed] envelope: "
              f"prev={prev} observed={observed} updated={updated}")


def check_observation(observed, valid, normalize: str, *,
                      where: str = "RatioTable.update") -> None:
    """IV002: the observation respects the table's normalize convention over
    the valid workers (only meaningful when >= 2 workers were measured)."""
    observed = np.asarray(observed, dtype=np.float64)
    valid = np.asarray(valid, dtype=bool)
    n_valid = int(valid.sum())
    if n_valid < 2:
        return  # singleton/empty measurements carry previous ratios over
    part = observed[valid]
    if not np.all(np.isfinite(part)) or np.any(part <= 0):
        _fail("IV002", f"{where}: invalid observed shares: {observed}")
    if normalize == "mean":
        stat, want = float(part.mean()), 1.0
    else:  # "sum"
        stat, want = float(part.sum()), 1.0
    if abs(stat - want) > 1e-6 * max(1.0, abs(want)):
        _fail("IV002",
              f"{where}: observation not normalized ({normalize} over "
              f"{n_valid} valid workers = {stat:.9f}, want {want})")


def check_offset_boundaries(bounds, total: int, *,
                            where: str = "OffsetSnapshot.refresh") -> None:
    """IV003: boundaries are a monotone non-decreasing int32 cumsum covering
    [0, total).  Equal adjacent entries (zero-width shards — parked cores)
    are legal; only a *decrease* violates the tiling."""
    bounds = np.asarray(bounds)
    if bounds.dtype != np.int32:
        _fail("IV003", f"{where}: boundaries dtype {bounds.dtype}, want int32")
    if bounds.ndim != 1 or bounds.size < 2:
        _fail("IV003", f"{where}: boundaries must be 1-D with >= 2 entries, "
                       f"got shape {bounds.shape}")
    if int(bounds[0]) != 0:
        _fail("IV003", f"{where}: boundaries start at {int(bounds[0])}, want 0")
    if int(bounds[-1]) != int(total):
        _fail("IV003", f"{where}: boundaries end at {int(bounds[-1])}, "
                       f"want N={int(total)}")
    if np.any(np.diff(bounds) < 0):
        _fail("IV003", f"{where}: boundaries decrease (zero-width shards "
                       f"are legal, negative ones are not): {bounds.tolist()}")


def check_plan_partition(counts, total: int, *, where: str = "Balancer.plan") -> None:
    """IV004: counts are non-negative and sum to exactly ``total``."""
    counts = np.asarray(counts)
    if np.any(counts < 0):
        _fail("IV004", f"{where}: negative shard count: {counts.tolist()}")
    got = int(np.asarray(counts, dtype=np.int64).sum())
    if got != int(total):
        _fail("IV004", f"{where}: shard counts sum to {got}, want N={int(total)} "
                       f"(gap/overlap in the partition): {counts.tolist()}")


def check_bytes_conserved(moved: float, inner_delta: float, *,
                          where: str = "TopologyDispatcher") -> None:
    """IV005: the bytes added to the aggregate level this region equal the
    bytes added across the per-socket dispatchers."""
    moved = float(moved)
    inner_delta = float(inner_delta)
    tol = 1e-6 * max(1.0, abs(moved))
    if abs(moved - inner_delta) > tol:
        _fail("IV005",
              f"{where}: aggregate accounted {moved:.6g} bytes this region "
              f"but socket dispatchers accounted {inner_delta:.6g}")


# --------------------------------------------------------------- CLI pass --
def run_pass(log=None) -> list:
    """Exercise the live stack with contracts force-enabled and report any
    violation as a Finding.  Used by ``python -m repro.analysis invariants``."""
    log = log or (lambda s: None)
    findings: list = []

    def _guard(name, fn):
        try:
            with contracts(True):
                fn()
            log(f"invariants: {name}: ok")
        except ContractViolation as e:
            findings.append(Finding(
                rule=e.rule, severity="error",
                location=f"contract:{name}",
                message=str(e)))

    def _ratio_table():
        from repro_torch.runtime import RatioTable
        rng = np.random.default_rng(0)
        for normalize in ("mean", "sum"):
            table = RatioTable(4, alpha=0.3, normalize=normalize)
            key = "membw/attn_proj"  # lint: allow(RL002) self-exercise fixture
            for _ in range(32):
                times = rng.uniform(0.5, 2.0, size=4)
                table.update(key, times)
                table.update(key, times, units=rng.integers(1, 64, size=4))
            # degenerate shapes the loop must survive
            table.update(key, np.array([np.nan, 1.0, np.inf, 0.0]))
            table.update(key, np.array([1.0, 0.0, 0.0, 0.0]))

    def _offsets_and_plans():
        from repro_torch.runtime import (Balancer, OffsetSpec, OffsetSnapshot,
                                   ProportionalPolicy, RatioTable)
        table = RatioTable(4, alpha=0.3)
        key = "membw/attn_proj"  # lint: allow(RL002) self-exercise fixture

        def counts(spec):
            policy = ProportionalPolicy(table, key=key,
                                        granularity=spec.granularity)
            return Balancer(policy, keep_stats=False).plan(spec.total).counts

        snap = OffsetSnapshot(counts, device="cpu")
        rng = np.random.default_rng(1)
        for i, total in enumerate((64, 96, 128)):
            snap.register(OffsetSpec(name=f"k{i}", total=total, granularity=8))
        for _ in range(8):
            snap.refresh()
            table.update(key, rng.uniform(0.5, 2.0, size=4))

    def _flat_dispatch():
        from repro_torch.kernels.dispatch import GEMV_ISA, HybridKernelDispatcher
        from repro_torch.runtime import KernelSpec
        d = HybridKernelDispatcher.virtual("ultra-125h")
        try:
            spec = KernelSpec(name="gemv", isa=GEMV_ISA)
            for _ in range(6):
                d.dispatch(spec, 4096, bytes_per_unit=2048.0)
        finally:
            d.close()

    def _topology_dispatch():
        from repro_torch.kernels.dispatch import GEMV_ISA
        from repro_torch.runtime import KernelSpec
        from repro_torch.topology.dispatch import TopologyDispatcher
        topo = TopologyDispatcher("dual-125h", execute=False)
        try:
            spec = KernelSpec(name="gemv", isa=GEMV_ISA)
            for _ in range(6):
                topo.dispatch(spec, 4096, bytes_per_unit=2048.0)
        finally:
            topo.close()

    _guard("ratio-table EMA/normalization", _ratio_table)
    _guard("offset snapshots + shard plans", _offsets_and_plans)
    _guard("flat dispatch loop", _flat_dispatch)
    _guard("two-level dispatch bytes conservation", _topology_dispatch)
    return findings
