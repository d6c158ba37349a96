"""Kernel-level schedulers (paper §2.1–2.2) as thin policies over the
unified runtime.

``CPURuntime`` is the paper's per-ISA ratio table — now literally a
:class:`~repro_torch.runtime.table.RatioTable` whose keys are primary ISAs.
``DynamicScheduler`` composes one :class:`~repro_torch.runtime.balancer.Balancer`
per (ISA, granularity) over that table and dispatches kernel parallel
regions through it; ``StaticScheduler`` is the same dispatch over
:class:`~repro_torch.runtime.policy.EvenPolicy` (the OpenMP-balanced baseline of
the paper's experiments, no feedback).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.core.pool import SubTask

from .balancer import Balancer, RegionStats, StatsSink
from .policy import EvenPolicy, Plan, ProportionalPolicy
from .table import RatioTable

__all__ = ["KernelSpec", "CPURuntime", "DynamicScheduler", "StaticScheduler"]


@dataclass(frozen=True)
class KernelSpec:
    """A parallel kernel as the scheduler sees it.

    ``work_per_unit`` converts one unit of the parallel dimension into
    abstract work (FLOPs / bytes) — used only by the virtual-time pool.
    ``key`` optionally separates the ratio-table key from the execution
    ISA: balanced-trunk dispatch learns one table per (ISA, layer kind)
    — e.g. ``"membw/attn_proj"`` — while the pool/machine still executes
    under the plain ISA.
    """

    name: str
    isa: str  # primary ISA, e.g. "avx_vnni", "avx2", "membw"
    granularity: int = 1  # tile size along the parallel dim
    work_per_unit: float = 1.0
    key: Optional[str] = None  # ratio-table key override (defaults to isa)

    @property
    def table_key(self) -> str:
        return self.key if self.key is not None else self.isa


class CPURuntime(RatioTable):
    """Per-core performance ratios, one table per ISA (paper §2.1).

    The paper found that kernels sharing a primary ISA share ratios, so
    tables are keyed by ISA and every kernel declares its primary ISA.
    """


def run_plan(pool, plan: Plan, fn: Optional[Callable[[int, int], None]],
             work_per_unit: float = 1.0) -> np.ndarray:
    """Execute one planned region on a worker pool; per-worker times."""
    subtasks = [
        SubTask(worker=w, start=lo, size=hi - lo,
                work=float(hi - lo) * work_per_unit, fn=fn)
        for w, (lo, hi) in enumerate(plan.ranges)
    ]
    return pool.run(subtasks)


class _PooledScheduler:
    """Shared dispatch machinery: a Balancer per (isa, granularity)."""

    def __init__(self, pool, sink: Optional[StatsSink] = None):
        self.pool = pool
        self.sink = sink
        self.stats: list = []
        self._balancers: Dict[tuple, Balancer] = {}

    def _policy(self, kernel: KernelSpec):
        raise NotImplementedError

    def balancer(self, kernel: KernelSpec) -> Balancer:
        key = (kernel.table_key, kernel.granularity)
        if key not in self._balancers:
            self._balancers[key] = Balancer(self._policy(kernel),
                                            sink=self.sink,
                                            keep_stats=False)
        return self._balancers[key]

    def partition(self, kernel: KernelSpec, s: int) -> np.ndarray:
        return self.balancer(kernel).plan(s).counts

    def dispatch(
        self,
        kernel: KernelSpec,
        s: int,
        fn: Optional[Callable[[int, int], None]] = None,
        *,
        update: bool = True,
    ) -> RegionStats:
        """Run one parallel region of size ``s`` along the kernel's dim."""
        bal = self.balancer(kernel)
        plan = bal.plan(s)
        times = run_plan(self.pool, plan, fn, kernel.work_per_unit)
        st = bal.report(plan, times, update=update, label=kernel.name)
        self.stats.append(st)
        return st


class DynamicScheduler(_PooledScheduler):
    """Paper §2.2: proportional dispatch + feedback (the contribution)."""

    def __init__(self, runtime: RatioTable, pool,
                 sink: Optional[StatsSink] = None):
        super().__init__(pool, sink=sink)
        self.runtime = runtime

    def _policy(self, kernel: KernelSpec) -> ProportionalPolicy:
        return ProportionalPolicy(self.runtime, key=kernel.table_key,
                                  granularity=kernel.granularity)


class StaticScheduler(_PooledScheduler):
    """OpenMP-style balanced dispatch: every worker gets an equal slice.

    This is the baseline of the paper's Fig. 2/3 ("OpenMP here uses the
    balanced work dispatch algorithm. Each thread computes the same size of
    sub-matrix").
    """

    def _policy(self, kernel: KernelSpec) -> EvenPolicy:
        return EvenPolicy(self.pool.n_workers, granularity=kernel.granularity)

    def dispatch(self, kernel, s, fn=None, *, update: bool = False):
        return super().dispatch(kernel, s, fn, update=update)
