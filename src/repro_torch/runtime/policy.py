"""Balance policies: how a total amount of parallel work becomes a plan.

A :class:`BalancePolicy` owns the two halves of the paper's control loop —

    plan(total)         -> Plan      (Eq. 3: proportional split)
    report(plan, times) -> ratios    (Eq. 2 + EMA feedback)

— over whatever domain the policy is configured for.  Policies are pure
host-side objects (numpy in / numpy out); the :class:`~repro_torch.runtime.
balancer.Balancer` facade adds timing, telemetry, and the context-manager
lifecycle on top.
"""

# lint: virtual-clock-module
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.core.ratio import proportional_partition

from .table import RatioTable

__all__ = [
    "Plan",
    "BalancePolicy",
    "ProportionalPolicy",
    "EvenPolicy",
    "RecursivePolicy",
    "clamp_to_capacity",
]


@dataclass(frozen=True)
class Plan:
    """One round's work assignment: per-worker counts along the parallel
    dimension, plus the key it was planned under."""

    counts: np.ndarray
    key: str = ""
    granularity: int = 1

    @property
    def n_workers(self) -> int:
        return len(self.counts)

    @property
    def total(self) -> int:
        return int(np.asarray(self.counts).sum())

    @property
    def weights(self) -> np.ndarray:
        """Fractional shares — e.g. the gradient-combine weights for uneven
        data parallelism (``sum_i w_i g_i`` equals the plain average over
        all ``total`` microbatches)."""
        return np.asarray(self.counts, dtype=np.float64) / max(self.total, 1)

    @property
    def ranges(self) -> list:
        """Contiguous ``[start, end)`` per worker (the paper splits one
        dimension into contiguous blocks, preserving cache locality)."""
        out, cursor = [], 0
        for c in self.counts:
            out.append((cursor, cursor + int(c)))
            cursor += int(c)
        return out


@runtime_checkable
class BalancePolicy(Protocol):
    """The plan/report lifecycle every balancing domain implements."""

    def plan(self, total: int) -> Plan: ...

    def report(self, plan: Plan, times) -> np.ndarray: ...


@dataclass
class ProportionalPolicy:
    """The paper's policy: split ``total`` proportionally to ``table``'s
    current ratios for ``key`` (Eq. 3), feed observed times back (Eq. 2).

    ``min_per_worker >= 1`` keeps every worker participating (a zero-count
    worker loses its throughput measurement; the paper keeps even LP-E
    cores in the table).  ``feedback`` selects the Eq.-2 variant:
    ``"times"`` assumes this round's work was proportional to the current
    table; ``"units"`` reports the realized per-worker counts so the update
    holds even when the plan was clamped or floored.

    ``active`` is an optional zero-argument probe returning a boolean
    per-worker mask (e.g. ``machine.active_mask`` at the pool clock).
    Masked-out workers get zero counts — and, because the table's
    ``units > 0`` rule already treats zero-count workers as unmeasured,
    their learned ratio is carried over unchanged through EMA feedback:
    a parked core resumes at its last known speed when it returns.  The
    plan keeps full width (fixed shapes downstream: no retrace, the
    compiled path just emits zero-width shard slices).  An all-False mask
    degenerates to all-active (the caller has nothing else to run on).
    """

    table: RatioTable
    key: str
    granularity: int = 1
    min_per_worker: int = 0
    feedback: str = "times"
    active: "Callable[[], np.ndarray] | None" = None

    def __post_init__(self) -> None:
        if self.feedback not in ("times", "units"):
            raise ValueError("feedback must be 'times' or 'units'")

    @property
    def n_workers(self) -> int:
        return self.table.n_workers

    def _mask(self) -> "np.ndarray | None":
        if self.active is None:
            return None
        mask = np.asarray(self.active(), dtype=bool)
        if mask.shape != (self.table.n_workers,):
            raise ValueError(
                f"active mask shape {mask.shape} != ({self.table.n_workers},)")
        if not mask.any():
            return None  # nothing else to run on: plan over everyone
        return mask

    def plan(self, total: int) -> Plan:
        n = self.table.n_workers
        mask = self._mask()
        if mask is None or mask.all():
            floor = self.min_per_worker * n
            if total < floor:
                raise ValueError(
                    f"need >= {floor} units for {n} workers "
                    f"(min_per_worker={self.min_per_worker})")
            counts = np.full(n, self.min_per_worker, dtype=np.int64)
            counts += proportional_partition(total - floor,
                                             self.table.ratios(self.key),
                                             self.granularity)
            return Plan(counts=counts, key=self.key,
                        granularity=self.granularity)
        # masked plan: floor only active workers, zero ratio elsewhere
        # (proportional_partition assigns nothing to zero-ratio workers)
        n_active = int(mask.sum())
        floor = self.min_per_worker * n_active
        if total < floor:
            raise ValueError(
                f"need >= {floor} units for {n_active} active workers "
                f"(min_per_worker={self.min_per_worker})")
        counts = np.where(mask, self.min_per_worker, 0).astype(np.int64)
        ratios = np.where(mask, self.table.ratios(self.key), 0.0)
        counts += proportional_partition(total - floor, ratios,
                                         self.granularity)
        return Plan(counts=counts, key=self.key, granularity=self.granularity)

    def report(self, plan: Plan, times) -> np.ndarray:
        units = np.asarray(plan.counts) if self.feedback == "units" else None
        return self.table.update(self.key, times, units=units)


@dataclass
class RecursivePolicy:
    """Eq. 2/3 over workers that are themselves balancing domains.

    The recursive hierarchy (fleet -> machine -> socket -> core) runs the
    same control law at every level; what changes at an inner node is only
    that each "worker" of its table is a whole Balancer-backed dispatcher
    with its own table underneath.  Planning and feedback are exactly
    :class:`ProportionalPolicy` (``units=`` feedback by default — realized
    per-worker work, robust to clamped plans); the recursion shows up in
    telemetry: ``collect_children()`` snapshots each child domain's latest
    own :class:`~repro_torch.runtime.balancer.RegionStats`, which
    :meth:`~repro_torch.runtime.balancer.Balancer.report` attaches to the
    emitted record (``RegionStats.children``), so one report at the top
    carries the ratio state of every level below it.

    ``children`` is a sequence of zero-argument callables, one per worker,
    each returning that worker's latest ``RegionStats`` (or ``None`` when
    it has not reported yet — those are simply omitted).
    """

    table: RatioTable
    key: str
    children: Sequence[Callable[[], object]] = ()
    granularity: int = 1
    min_per_worker: int = 0
    feedback: str = "units"
    active: "Callable[[], np.ndarray] | None" = None

    def __post_init__(self) -> None:
        self._inner = ProportionalPolicy(
            self.table, key=self.key, granularity=self.granularity,
            min_per_worker=self.min_per_worker, feedback=self.feedback,
            active=self.active)
        if self.children and len(self.children) != self.table.n_workers:
            raise ValueError(
                f"{len(self.children)} children for "
                f"{self.table.n_workers} workers")

    @property
    def n_workers(self) -> int:
        return self.table.n_workers

    def plan(self, total: int) -> Plan:
        return self._inner.plan(total)

    def report(self, plan: Plan, times) -> np.ndarray:
        return self._inner.report(plan, times)

    def collect_children(self) -> list:
        """Latest per-worker child RegionStats (non-reporting children are
        dropped; order follows the worker order of those that reported)."""
        out = []
        for probe in self.children:
            st = probe()
            if st is not None:
                out.append(st)
        return out


@dataclass
class EvenPolicy:
    """The static (OpenMP balanced parallel-for) baseline: equal shares,
    no feedback."""

    n_workers: int
    granularity: int = 1
    key: str = "static"

    def plan(self, total: int) -> Plan:
        counts = proportional_partition(total, np.ones(self.n_workers),
                                        self.granularity)
        return Plan(counts=counts, key=self.key, granularity=self.granularity)

    def report(self, plan: Plan, times) -> np.ndarray:
        return np.ones(self.n_workers)


def clamp_to_capacity(counts, capacities) -> np.ndarray:
    """Clamp a plan's counts to per-worker capacities, redistributing the
    overflow to workers with headroom (largest headroom first).

    Raises ``ValueError`` when the total exceeds the aggregate capacity —
    no single-round assignment can serve it.
    """
    counts = np.asarray(counts, dtype=np.int64).copy()
    caps = np.asarray(capacities, dtype=np.int64)
    if counts.shape != caps.shape:
        raise ValueError("counts and capacities must have the same shape")
    total = int(counts.sum())
    if total > int(caps.sum()):
        raise ValueError(
            f"total work {total} exceeds aggregate capacity {int(caps.sum())}")
    counts = np.minimum(counts, caps)
    excess = total - int(counts.sum())
    while excess > 0:
        headroom = caps - counts
        i = int(np.argmax(headroom))
        take = min(excess, int(headroom[i]))
        counts[i] += take
        excess -= take
    return counts
