# lint: virtual-clock-module
"""repro_torch.topology — NUMA/multi-socket machine model and two-level dispatch.

Layers (bottom up):

* :mod:`machine` — :class:`SocketSpec`/:class:`BandwidthDomain`/
  :class:`MachineTopology`: N sockets, each its own bandwidth pool and
  seeded jitter stream, plus the cross-socket transfer penalty and the
  socket-oblivious flattened view.  The flat hybrid CPU is the 1-socket
  special case.
* :mod:`dispatch` — :class:`TopologyDispatcher`: the paper's Eq. 2/3 loop
  per socket (one flat dispatcher per bandwidth domain) under a
  socket-level proportional split learned with ``units=`` feedback; or
  the socket-oblivious baseline over the flattened machine.
* :mod:`placement` — NUMA-aware weight placement for balanced trunks:
  column ranges pinned to the socket that streams them, with per-domain
  resident-byte accounting.
"""

from .machine import (
    BandwidthDomain,
    MachineTopology,
    SocketSpec,
    TOPOLOGIES,
    make_2s_12900k,
    make_dual_125h,
    make_topology,
)
from .dispatch import TopologyDispatcher
from .placement import TrunkPlacement, place_rows, place_trunk

__all__ = [
    "BandwidthDomain",
    "SocketSpec",
    "MachineTopology",
    "TOPOLOGIES",
    "make_dual_125h",
    "make_2s_12900k",
    "make_topology",
    "TopologyDispatcher",
    "TrunkPlacement",
    "place_rows",
    "place_trunk",
]
