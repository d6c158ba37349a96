"""Serving substrate of the port: request-level continuous batching on the
unified Balancer, with per-phase ("prefill"/"decode") ratio learning.

Layering::

    Request / RequestState / FinishReason      (request.py)
        |
    IterationScheduler  +  SlotCacheManager    (scheduler.py, slots.py)
        |
    ContinuousBatchingEngine                   (engine.py; its decode
        |                                       step a CUDA graph, step_graph.py)
    InflightDispatcher  --- per-phase RatioTable ---  HybridPhaseCost
    (replica routing, dispatch.py)                    (core dispatch, phases.py)
"""

from .engine import (
    ContinuousBatchingEngine,
    GenerationResult,
    RoutedServer,
    ServeEngine,
)
from .dispatch import InflightDispatcher
from .phases import (
    DECODE,
    HybridPhaseCost,
    LinearPhaseCost,
    PhaseCostModel,
    PHASE_ISA,
    PREFILL,
    TRUNK_KINDS,
    phase_kernel_key,
)
from .metrics import LatencyReport, percentiles, slo_met
from .request import FinishReason, Request, RequestState
from .scheduler import IterationScheduler, IterationStats, PrefillChunk
from .slots import SlotCacheManager
from .traffic import poisson_requests

__all__ = [
    "ContinuousBatchingEngine",
    "GenerationResult",
    "RoutedServer",
    "ServeEngine",
    "InflightDispatcher",
    "Request",
    "RequestState",
    "FinishReason",
    "IterationScheduler",
    "IterationStats",
    "PrefillChunk",
    "SlotCacheManager",
    "LatencyReport",
    "percentiles",
    "slo_met",
    "poisson_requests",
    "PREFILL",
    "DECODE",
    "PHASE_ISA",
    "TRUNK_KINDS",
    "phase_kernel_key",
    "PhaseCostModel",
    "HybridPhaseCost",
    "LinearPhaseCost",
]
