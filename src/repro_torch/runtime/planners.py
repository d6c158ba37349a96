"""Pod/MoE/serving planners re-expressed as thin policies over the unified
runtime (the reference's ``repro.core.balance``, minus its private EMA loops).

The heterogeneous "cores" of the paper become heterogeneous *mesh slices*
(pods / hosts / replicas): thermal throttling, co-tenant interference,
failing-slow HBM, or mixed hardware generations produce exactly the
imbalance the paper measures on P/E cores.  Each planner below is the same
three-step loop — measure, EMA the ratio table, split proportionally — at a
different layer:

* :class:`UnevenBatchPlanner` — per-pod gradient-accumulation trip counts
  (worker ``i`` runs ``k_i ∝ pr_i`` local steps; one weighted all-reduce
  joins pods, so unequal trip counts cannot deadlock SPMD collectives).
* :class:`ExpertCapacityPlanner` — per-expert buffer capacity tracking the
  realized routing distribution at fixed total compute.
* :class:`ReplicaRouter` — request-to-replica routing proportional to
  measured replica throughput.

All planners are pure (numpy in / numpy out) and satisfy the
:class:`~repro_torch.runtime.policy.BalancePolicy` lifecycle, so any of them can
sit behind a :class:`~repro_torch.runtime.balancer.Balancer`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.ratio import proportional_partition

from .policy import Plan, ProportionalPolicy
from .table import RatioTable

__all__ = [
    "DeviceRuntime",
    "MicrobatchPlan",
    "UnevenBatchPlanner",
    "ExpertCapacityPlanner",
    "ReplicaRouter",
]


class DeviceRuntime(RatioTable):
    """Per-slice performance table, keyed by program name (≈ the paper's
    per-ISA tables keyed by kernel).  Times come from host-side step timing
    (``block_until_ready`` around the local accumulation loop)."""

    def __init__(self, n_slices: int, alpha: float = 0.3, **kwargs):
        super().__init__(n_slices, alpha=alpha, **kwargs)

    @property
    def n_slices(self) -> int:
        return self.n_workers


# The per-pod microbatch plan is just a Plan; the name survives because the
# training stack reads ``plan.weights`` as gradient-combine weights.
MicrobatchPlan = Plan


class UnevenBatchPlanner(ProportionalPolicy):
    """Plan per-pod gradient-accumulation trip counts ∝ measured throughput.

    ``min_per_slice >= 1`` keeps every pod participating (a zero-count pod
    would contribute a zero-weight gradient but still must enter the final
    all-reduce; giving it at least one microbatch also keeps its throughput
    measurement alive — the paper keeps even the LP-E cores in the table).
    """

    def __init__(self, runtime: RatioTable, program: str = "train_step",
                 min_per_slice: int = 1):
        super().__init__(table=runtime, key=program,
                         min_per_worker=min_per_slice, feedback="units")

    @property
    def runtime(self) -> RatioTable:
        return self.table

    @property
    def program(self) -> str:
        return self.key

    @property
    def min_per_slice(self) -> int:
        return self.min_per_worker


class ReplicaRouter(ProportionalPolicy):
    """Serving-side Eq. 3: route request batches across model replicas
    proportionally to their measured decode throughput."""

    def __init__(self, runtime: RatioTable, program: str = "serve_step"):
        super().__init__(table=runtime, key=program, feedback="units")

    @property
    def runtime(self) -> RatioTable:
        return self.table

    @property
    def program(self) -> str:
        return self.key

    def split(self, batch_size: int) -> np.ndarray:
        return self.plan(batch_size).counts

    def report(self, plan, times) -> np.ndarray:
        """Accepts either a :class:`Plan` or a raw counts array (the realized
        split may differ from the planned one after capacity clamping)."""
        if not isinstance(plan, Plan):
            plan = Plan(counts=np.asarray(plan, dtype=np.int64), key=self.key)
        return super().report(plan, times)


class ExpertCapacityPlanner:
    """Eq. 3 applied to MoE expert buffers.

    A uniform capacity factor provisions every expert for the *average* load;
    hot experts then drop tokens while cold experts waste compute — the MoE
    incarnation of "P-cores waiting for E-cores".  This planner keeps an EMA
    of realized expert load *fractions* in a sum-normalized
    :class:`RatioTable` and assigns per-expert capacity proportionally,
    holding the *total* buffer (= compute cost) fixed.

    Capacities are quantized to ``granularity`` (MXU-friendly multiples) and
    floored at ``min_capacity`` so an expert can recover from a cold spell.
    """

    KEY = "expert_load"

    def __init__(self, n_experts: int, total_capacity: int, alpha: float = 0.3,
                 min_capacity: int = 8, granularity: int = 8,
                 table: Optional[RatioTable] = None):
        if min_capacity * n_experts > total_capacity:
            raise ValueError("min_capacity * n_experts exceeds total capacity")
        self.n_experts = n_experts
        self.total_capacity = total_capacity
        self.alpha = alpha
        self.min_capacity = min_capacity
        self.granularity = granularity
        self.table = table or RatioTable(
            n_experts, alpha=alpha, init_ratio=1.0 / n_experts,
            normalize="sum")

    @property
    def load_ema(self) -> np.ndarray:
        return self.table.ratios(self.KEY)

    def observe(self, expert_counts) -> None:
        counts = np.asarray(expert_counts, dtype=np.float64)
        total = counts.sum()
        if total <= 0:
            return
        self.table.observe(self.KEY, counts / total)

    def capacities(self) -> np.ndarray:
        floor = self.min_capacity * self.n_experts
        if floor > self.total_capacity:
            raise ValueError("min_capacity * n_experts exceeds total capacity")
        extra = proportional_partition(
            self.total_capacity - floor, self.load_ema, self.granularity
        )
        return np.full(self.n_experts, self.min_capacity, dtype=np.int64) + extra

    # ------------------------------------------ BalancePolicy lifecycle --
    def plan(self, total: Optional[int] = None) -> Plan:
        """Plan the capacity split (``total`` defaults to the fixed buffer;
        any other value is split with the same load EMA)."""
        if total is None or total == self.total_capacity:
            counts = self.capacities()
        else:
            floor = self.min_capacity * self.n_experts
            if total < floor:
                raise ValueError(f"need >= {floor} total capacity")
            counts = np.full(self.n_experts, self.min_capacity, dtype=np.int64)
            counts += proportional_partition(total - floor, self.load_ema,
                                             self.granularity)
        return Plan(counts=counts, key=self.KEY,
                    granularity=self.granularity)

    def report(self, plan: Plan, loads) -> np.ndarray:
        """Feedback for this domain is the realized expert-load vector (the
        'times' of MoE dispatch: tokens routed per expert this round)."""
        self.observe(loads)
        return self.load_ema
