"""Core of the port: ratio math, worker pools, machine models, tuner —
copies of ``repro.core``'s numpy-only modules."""

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
]
