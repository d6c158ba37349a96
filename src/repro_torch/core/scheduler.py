"""Deprecated shim — the schedulers moved to :mod:`repro_torch.runtime`.

``repro.core.scheduler`` was the seed's home of the paper's CPU runtime
(§2.1) and thread scheduler (§2.2).  The implementation now lives in
:mod:`repro_torch.runtime.scheduler` (``CPURuntime`` is a keyed
:class:`repro_torch.runtime.RatioTable`; the schedulers are thin policies over
:class:`repro_torch.runtime.Balancer`).  Import from ``repro_torch.runtime`` — this
module re-exports for one release and will then be removed.
"""

from __future__ import annotations

from repro_torch.runtime.balancer import RegionStats
from repro_torch.runtime.scheduler import (
    KernelSpec,
    CPURuntime,
    DynamicScheduler,
    StaticScheduler,
)

__all__ = ["KernelSpec", "CPURuntime", "DynamicScheduler", "StaticScheduler",
           "RegionStats"]
