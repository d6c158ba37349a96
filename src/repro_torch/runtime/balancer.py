"""The Balancer facade: one object per balancing domain, uniform telemetry.

``Balancer`` wraps a :class:`~repro_torch.runtime.policy.BalancePolicy` and runs
the paper's loop for its callers:

    plan -> execute (caller) -> report -> RegionStats -> sink

``balanced_region(total)`` is the highest-level entry point: it plans the
split, hands the caller a :class:`Region` whose ``timed(worker)`` context
records per-worker wall times, and feeds the times back automatically on
exit — the paper's "track the execution time of each thread during
executing kernels" as a context manager.

Telemetry is uniform across domains: every round emits one
:class:`RegionStats` (makespan, imbalance, ratio trace) to a pluggable
:class:`StatsSink`.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.analysis import invariants as _contracts
from repro_torch.core import events as _ev

from .policy import BalancePolicy, Plan

__all__ = [
    "RegionStats",
    "StatsSink",
    "ListSink",
    "Region",
    "Balancer",
]


@dataclass
class RegionStats:
    """Telemetry for one balanced parallel region (any domain).

    ``children`` makes the record recursive: when the region's workers are
    themselves balancing domains (a fleet routing over machines routing
    over sockets routing over cores), each worker's latest own
    :class:`RegionStats` is attached, so one emitted record carries the
    whole hierarchy's state for that round.  Flat domains leave it empty.
    """

    key: str
    counts: np.ndarray
    times: np.ndarray
    ratios: Optional[np.ndarray] = None  # table state after feedback
    bytes: float = 0.0                   # bytes moved by the region (0 = n/a)
    children: tuple = ()                 # per-worker child RegionStats

    @property
    def kernel(self) -> str:  # seed-era alias (RegionStats.kernel)
        return self.key

    @property
    def measured(self) -> np.ndarray:
        """Workers that both received work and reported a time this round.
        Zero-count workers never enter the timed region; their ``t == 0``
        (or an injected phantom time) is *absence of measurement*, not a
        measurement, and must not leak into telemetry or EMA updates."""
        times = np.asarray(self.times, dtype=np.float64)
        counts = np.asarray(self.counts)
        return (counts > 0) & np.isfinite(times) & (times > 0)

    @property
    def makespan(self) -> float:
        times = np.asarray(self.times, dtype=np.float64)
        return float(times[self.measured].max(initial=0.0))

    @property
    def imbalance(self) -> float:
        """max(t)/mean(t) over measured workers — 1.0 is perfectly
        balanced."""
        times = np.asarray(self.times, dtype=np.float64)
        active = times[self.measured]
        if active.size == 0:
            return 1.0
        return float(active.max() / active.mean())

    @property
    def bandwidth(self) -> float:
        """Achieved bytes/s over the region (bytes moved / makespan) — the
        numerator of the paper's achieved-bandwidth fraction.  0 when the
        region recorded no byte accounting or no time."""
        mk = self.makespan
        if self.bytes <= 0 or mk <= 0:
            return 0.0
        return self.bytes / mk


@runtime_checkable
class StatsSink(Protocol):
    """Anything that accepts per-region telemetry (logger, CSV writer,
    metrics exporter)."""

    def emit(self, stats: RegionStats) -> None: ...


@dataclass
class ListSink:
    """In-memory sink (the default for tests and benchmarks)."""

    records: list = field(default_factory=list)

    def emit(self, stats: RegionStats) -> None:
        self.records.append(stats)


class Region:
    """One in-flight balanced region: the plan plus a per-worker stopwatch."""

    def __init__(self, plan: Plan):
        self.plan = plan
        self.times = np.zeros(plan.n_workers)

    @property
    def counts(self) -> np.ndarray:
        return self.plan.counts

    @property
    def ranges(self) -> list:
        return self.plan.ranges

    @contextmanager
    def timed(self, worker: int):
        """Time one worker's slice; accumulates so a worker may run several
        chunks within the region."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[worker] += time.perf_counter() - t0

    def record(self, worker: int, seconds: float) -> None:
        """Record an externally measured time (simulators, device events)."""
        self.times[worker] += float(seconds)


class Balancer:
    """Facade tying a policy to telemetry.  All four seed balancing loops
    (CPU kernels, uneven DP, MoE capacity, replica routing) are instances
    of this one object with different policies."""

    def __init__(self, policy: BalancePolicy, sink: Optional[StatsSink] = None,
                 keep_stats: bool = True):
        self.policy = policy
        self.sink = sink
        self.keep_stats = keep_stats
        self.stats: list = []

    def plan(self, total: int) -> Plan:
        plan = self.policy.plan(total)
        if _contracts.contracts_enabled():
            _contracts.check_plan_partition(
                plan.counts, total,
                where=f"Balancer.plan[{plan.key}]")
        return plan

    def report(self, plan: Plan, times, *, update: bool = True,
               label: Optional[str] = None,
               bytes_moved: float = 0.0) -> RegionStats:
        """Feed observed times back through the policy and emit telemetry.
        ``label`` overrides the stats key (e.g. kernel name vs. ISA key);
        ``bytes_moved`` records the region's byte traffic for bandwidth
        accounting."""
        times = np.asarray(times, dtype=np.float64)
        ratios = self.policy.report(plan, times) if update else None
        # Recursive domains (policies with a collect_children hook, e.g.
        # RecursivePolicy) attach each worker's own latest RegionStats so
        # the emitted record spans the whole hierarchy.
        collect = getattr(self.policy, "collect_children", None)
        st = RegionStats(key=label or plan.key, counts=plan.counts,
                         times=times,
                         ratios=None if ratios is None else ratios.copy(),
                         bytes=float(bytes_moved),
                         children=() if collect is None else tuple(collect()))
        if self.keep_stats:
            self.stats.append(st)
        if self.sink is not None:
            self.sink.emit(st)
        if _ev.RECORDER is not None:
            _ev.record(
                "ratio", st.key,
                makespan=st.makespan,
                imbalance=round(st.imbalance, 6),
                counts=np.asarray(st.counts).tolist(),
                ratios=(None if st.ratios is None
                        else np.round(st.ratios, 6).tolist()))
        return st

    @contextmanager
    def balanced_region(self, total: Optional[int] = None, *,
                        plan: Optional[Plan] = None, update: bool = True,
                        label: Optional[str] = None):
        """Plan a region, let the caller execute + time it, feed back on
        exit::

            with balancer.balanced_region(len(batch)) as region:
                for w, (lo, hi) in enumerate(region.ranges):
                    with region.timed(w):
                        work(batch[lo:hi])
            # times fed back; stats emitted

        Pass ``plan=`` instead of ``total`` to run an externally adjusted
        plan (e.g. one clamped to per-worker capacity).  After exit
        ``region.stats`` holds the emitted :class:`RegionStats`; nothing is
        fed back if the body raises.
        """
        if plan is None:
            if total is None:
                raise TypeError("balanced_region needs total= or plan=")
            plan = self.plan(total)
        region = Region(plan)
        region.stats = None
        yield region
        region.stats = self.report(region.plan, region.times, update=update,
                                   label=label)
