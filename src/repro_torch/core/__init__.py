"""Core of the port: ratio math, worker pools, machine models, tuner and
the pipeline-stage planner — copies of ``repro.core``'s numpy-only modules.

The balancing loops themselves (ratio tables, schedulers, planners) live in
:mod:`repro_torch.runtime`; :mod:`scheduler` and :mod:`balance` are the
reference's deprecation shims re-exporting from there, and this package
lazily re-exports the same names, as ``repro.core`` does.
"""

from .ratio import (
    optimal_shares,
    observed_ratios,
    ema_update,
    proportional_partition,
    partition_ranges,
    makespan,
)
from .pool import SubTask, ThreadWorkerPool, VirtualWorkerPool
from .hybrid_sim import (
    CapacityEvent,
    CoreSpec,
    SimulatedHybridCPU,
    make_machine,
    MACHINES,
)
from .tuner import KernelTuner, TunerStore, shape_class
from .pipeline import (
    PipelinePlan,
    plan_stages,
    choose_microbatches,
    layer_costs_from_config,
)

# Names that moved to repro_torch.runtime, resolved lazily (PEP 562) so
# importing repro_torch.core does not circularly import repro_torch.runtime
# (whose modules build on repro_torch.core.ratio / repro_torch.core.pool).
_MOVED_TO_RUNTIME = (
    "KernelSpec",
    "CPURuntime",
    "DynamicScheduler",
    "StaticScheduler",
    "DeviceRuntime",
    "MicrobatchPlan",
    "UnevenBatchPlanner",
    "ExpertCapacityPlanner",
    "ReplicaRouter",
)


def __getattr__(name):
    if name in _MOVED_TO_RUNTIME:
        import repro_torch.runtime as _runtime

        return getattr(_runtime, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "optimal_shares",
    "observed_ratios",
    "ema_update",
    "proportional_partition",
    "partition_ranges",
    "makespan",
    "SubTask",
    "ThreadWorkerPool",
    "VirtualWorkerPool",
    "CapacityEvent",
    "CoreSpec",
    "SimulatedHybridCPU",
    "make_machine",
    "MACHINES",
    "KernelTuner",
    "TunerStore",
    "shape_class",
    "PipelinePlan",
    "plan_stages",
    "choose_microbatches",
    "layer_costs_from_config",
    *_MOVED_TO_RUNTIME,
]
