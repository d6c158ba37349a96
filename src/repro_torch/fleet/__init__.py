# lint: virtual-clock-module
"""Fleet-scale serving: the paper's balancing loop, applied recursively.

The single-machine story is a two-level hierarchy — per-core ratio
tables inside each socket's cost model, a per-socket
:class:`~repro_torch.serving.InflightDispatcher` above them.  This package
adds the third level: a :class:`Cluster` of named heterogeneous nodes
(multi-socket, flat, throttled), a :class:`FleetRouter` whose policy is
a :class:`~repro_torch.runtime.RecursivePolicy` — a node-level
:class:`~repro_torch.runtime.RatioTable` whose workers are themselves
Balancer-backed dispatchers — and an :class:`AdmissionController`
shedding or degrading what the fleet cannot finish within its SLOs.

Everything runs on the shared virtual clock, so fleet runs (traffic,
failures, routing decisions) are exactly reproducible from a seed.
"""

from .admission import AdmissionController
from .cluster import Cluster, Node, NodeSpec
from .events import NodeEvent, diurnal_rate, failure_window, fleet_requests
from .router import FleetRouter, run_fleet

__all__ = [
    "AdmissionController",
    "Cluster",
    "Node",
    "NodeSpec",
    "NodeEvent",
    "diurnal_rate",
    "failure_window",
    "fleet_requests",
    "FleetRouter",
    "run_fleet",
]
