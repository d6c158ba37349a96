"""repro_torch.runtime — the single home of the paper's dynamic parallel method.

One stack, four layers of callers::

    RatioTable / RatioStore      keyed EMA ratio tables (Eq. 2), persisted
        |
    BalancePolicy (plan/report)  proportional split (Eq. 3) + feedback
        |
    Balancer / balanced_region   timing, automatic feedback, RegionStats
        |
    domain frontends             DynamicScheduler (CPU kernels),
                                 UnevenBatchPlanner (uneven DP),
                                 ExpertCapacityPlanner (MoE capacity),
                                 ReplicaRouter (serving)

Copied from ``repro.runtime``; :mod:`.offsets` holds its boundaries as
torch tensors.
"""

from .table import RatioTable, RatioStore
from .offsets import OffsetSpec, OffsetSnapshot
from .policy import (
    Plan,
    BalancePolicy,
    ProportionalPolicy,
    EvenPolicy,
    RecursivePolicy,
    clamp_to_capacity,
)
from .balancer import RegionStats, StatsSink, ListSink, Region, Balancer
from .scheduler import (
    KernelSpec,
    CPURuntime,
    DynamicScheduler,
    StaticScheduler,
    run_plan,
)
from .planners import (
    DeviceRuntime,
    MicrobatchPlan,
    UnevenBatchPlanner,
    ExpertCapacityPlanner,
    ReplicaRouter,
)

__all__ = [
    "RatioTable",
    "RatioStore",
    "OffsetSpec",
    "OffsetSnapshot",
    "Plan",
    "BalancePolicy",
    "ProportionalPolicy",
    "EvenPolicy",
    "RecursivePolicy",
    "clamp_to_capacity",
    "RegionStats",
    "StatsSink",
    "ListSink",
    "Region",
    "Balancer",
    "KernelSpec",
    "CPURuntime",
    "DynamicScheduler",
    "StaticScheduler",
    "run_plan",
    "DeviceRuntime",
    "MicrobatchPlan",
    "UnevenBatchPlanner",
    "ExpertCapacityPlanner",
    "ReplicaRouter",
]
