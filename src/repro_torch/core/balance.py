"""Deprecated shim — the pod/MoE/serving planners moved to
:mod:`repro_torch.runtime`.

``repro.core.balance`` was the seed's TPU-scale adaptation of the paper's
method, with its own private EMA loop (``DeviceRuntime``).  The
implementation now lives in :mod:`repro_torch.runtime.planners`, where
``DeviceRuntime`` is a keyed :class:`repro_torch.runtime.RatioTable` and every
planner is a thin :class:`repro_torch.runtime.BalancePolicy`.  Import from
``repro_torch.runtime`` — this module re-exports for one release and will then
be removed.
"""

from __future__ import annotations

from repro_torch.runtime.planners import (
    DeviceRuntime,
    MicrobatchPlan,
    UnevenBatchPlanner,
    ExpertCapacityPlanner,
    ReplicaRouter,
)

__all__ = [
    "DeviceRuntime",
    "MicrobatchPlan",
    "UnevenBatchPlanner",
    "ExpertCapacityPlanner",
    "ReplicaRouter",
]
