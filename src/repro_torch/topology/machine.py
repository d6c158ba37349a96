# lint: virtual-clock-module
"""NUMA / multi-socket machine model: per-socket bandwidth domains.

The flat :class:`~repro_torch.core.hybrid_sim.SimulatedHybridCPU` models one
socket whose cores share one memory-bandwidth pool — the machine the
paper's dynamic ratio loop was written for.  Real AIPC-class deployments
increasingly span multiple sockets (or tiles/clusters) where bandwidth
contention is *per-socket*: a core streams its local DRAM at full speed
but pays a fabric transfer penalty (UPI/IF-style) for bytes resident on
another socket, and each socket's pool is contended only by the work
assigned to *that* socket.

:class:`MachineTopology` composes one :class:`SimulatedHybridCPU` per
socket (each with its own seeded jitter stream and background-load list),
so the existing virtual-time pools, ratio tables, and dispatchers all
apply unchanged *within* a socket.  What the topology adds:

* :class:`BandwidthDomain` views — name, cores, streaming bandwidth — the
  per-domain denominators of the achieved-bandwidth fraction;
* ``cross_socket_penalty`` — the multiplicative wall-time cost of
  streaming one remote byte relative to a local one (typical 2-socket
  boards: remote sustained bandwidth ~55-65% of local, so ~1.8);
* ``flattened()`` — the socket-oblivious view: every core in one flat
  machine, which is what a NUMA-unaware dispatcher sees.  With
  interleaved (first-touch-oblivious) page placement each core streams
  ``(S-1)/S`` of its bytes remotely, captured by ``oblivious_blend``.

The flat machine is exactly the 1-socket special case: a
``MachineTopology`` with one socket has blend 1.0, zero remote traffic,
and ``aggregate_bandwidth == socket_bandwidth``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List

import numpy as np

from repro_torch.core.hybrid_sim import (
    CoreSpec,
    SimulatedHybridCPU,
    make_12900k,
    make_ultra_125h,
)
from repro_torch.core.ratio import proportional_partition

__all__ = [
    "BandwidthDomain",
    "SocketSpec",
    "MachineTopology",
    "make_dual_125h",
    "make_2s_12900k",
    "TOPOLOGIES",
    "make_topology",
    "place_rows",
]

MEMBW = "membw"


def place_rows(n: int, shares, granularity: int = 1) -> tuple:
    """Contiguous per-socket ``(lo, hi)`` ranges of ``n`` rows proportional
    to ``shares`` — the single counts-to-ranges conversion both the
    dispatch-side default placement and :func:`~repro_torch.topology.placement.
    place_trunk` pin weights with (one implementation, so the fabric
    penalty can never see two different notions of "resident")."""
    counts = proportional_partition(n, np.asarray(shares, dtype=np.float64),
                                    granularity)
    out, cursor = [], 0
    for c in counts:
        out.append((cursor, cursor + int(c)))
        cursor += int(c)
    return tuple(out)


@dataclass(frozen=True)
class SocketSpec:
    """One socket (bandwidth domain) of a multi-socket machine: a name and
    the cores that contend for its local memory pool."""

    name: str
    cores: List[CoreSpec]

    @property
    def n_cores(self) -> int:
        return len(self.cores)

    @property
    def bandwidth(self) -> float:
        """Streaming bandwidth of this socket's pool (sum of its cores'
        sustainable draws — the per-socket MLC analogue)."""
        return float(sum(c.throughput[MEMBW] for c in self.cores))


@dataclass(frozen=True)
class BandwidthDomain:
    """Read-only view of one socket as a bandwidth domain: the unit the
    two-level balancer's outer split operates over."""

    index: int
    name: str
    bandwidth: float       # bytes/s, local streaming
    core_start: int        # global core index range [core_start, core_end)
    core_end: int

    @property
    def n_cores(self) -> int:
        return self.core_end - self.core_start


@dataclass
class MachineTopology:
    """N sockets, each its own bandwidth pool; cross-socket transfer pays a
    multiplicative penalty.

    Each socket is materialized as a flat :class:`SimulatedHybridCPU` (its
    cores, its jitter stream seeded ``seed + socket_index``, its own
    ``background`` throttle list), available via :attr:`machines` — the
    object per-socket worker pools and dispatchers run on.
    """

    sockets: List[SocketSpec]
    cross_socket_penalty: float = 1.8
    seed: int = 0
    name: str = ""
    machines: List[SimulatedHybridCPU] = field(init=False)

    def __post_init__(self) -> None:
        if not self.sockets:
            raise ValueError("topology needs at least one socket")
        if self.cross_socket_penalty < 1.0:
            raise ValueError("cross_socket_penalty must be >= 1")
        self.machines = [
            SimulatedHybridCPU(cores=list(s.cores), seed=self.seed + i)
            for i, s in enumerate(self.sockets)
        ]

    # ------------------------------------------------------------- shape ---
    @property
    def n_sockets(self) -> int:
        return len(self.sockets)

    @property
    def n_cores(self) -> int:
        return sum(s.n_cores for s in self.sockets)

    def socket_of(self, core: int) -> int:
        """Socket index owning global core index ``core``."""
        for d in self.domains():
            if d.core_start <= core < d.core_end:
                return d.index
        raise IndexError(f"core {core} out of range for {self.n_cores} cores")

    def domains(self) -> List[BandwidthDomain]:
        out, start = [], 0
        for i, s in enumerate(self.sockets):
            out.append(BandwidthDomain(
                index=i, name=s.name, bandwidth=s.bandwidth,
                core_start=start, core_end=start + s.n_cores))
            start += s.n_cores
        return out

    # --------------------------------------------------------- bandwidth ---
    def socket_bandwidth(self, socket: int) -> float:
        return self.sockets[socket].bandwidth

    @property
    def aggregate_bandwidth(self) -> float:
        """Sum of per-socket streaming bandwidths — the denominator of the
        *aggregate* achieved-bandwidth fraction (every pool saturated by
        local traffic; no machine can exceed it)."""
        return float(sum(s.bandwidth for s in self.sockets))

    def bandwidth_shares(self) -> np.ndarray:
        """Per-socket fraction of aggregate bandwidth — the NUMA placement
        prior (bytes live where they can be streamed fastest)."""
        bw = np.array([s.bandwidth for s in self.sockets], dtype=np.float64)
        return bw / bw.sum()

    # ---------------------------------------------------------- capacity ---
    def park_core(self, core: int, t_start: float = 0.0,
                  t_end: float = float("inf")) -> None:
        """Park global core index ``core`` (routed to its socket machine)."""
        s = self.socket_of(core)
        local = core - self.domains()[s].core_start
        self.machines[s].park(local, t_start, t_end)

    def unpark_core(self, core: int) -> None:
        s = self.socket_of(core)
        local = core - self.domains()[s].core_start
        self.machines[s].unpark(local)

    def park_socket(self, socket: int, t_start: float = 0.0,
                    t_end: float = float("inf")) -> None:
        """Park every core of ``socket`` — a socket's worth of capacity
        gone (thermal trip, foreground app pinned to one tile)."""
        m = self.machines[socket]
        for local in range(m.n_cores):
            m.park(local, t_start, t_end)

    def unpark_socket(self, socket: int) -> None:
        m = self.machines[socket]
        for local in range(m.n_cores):
            m.unpark(local)

    def active_mask(self, now: float = 0.0) -> np.ndarray:
        """Global-core boolean mask: concatenation of per-socket masks."""
        return np.concatenate([m.active_mask(now) for m in self.machines])

    def active_bandwidth(self, now: float = 0.0) -> float:
        """Aggregate streaming bandwidth of *active* cores only — what
        ``Node.nominal_capacity`` re-plans to when a capacity event fires."""
        total = 0.0
        for m in self.machines:
            mask = m.active_mask(now)
            total += float(m.true_throughput(MEMBW)[mask].sum())
        return total

    # ------------------------------------------------- oblivious baseline --
    @property
    def oblivious_blend(self) -> float:
        """Effective per-byte wall-time multiplier of socket-oblivious
        streaming: with interleaved (NUMA-unaware) page placement a core
        finds ``(S-1)/S`` of its bytes on remote sockets, each costing
        ``cross_socket_penalty`` relative to a local byte."""
        s = self.n_sockets
        if s <= 1:
            return 1.0
        remote = (s - 1) / s
        return 1.0 + (self.cross_socket_penalty - 1.0) * remote

    def flattened(self, seed_offset: int = 0) -> SimulatedHybridCPU:
        """All cores as one flat machine — the socket-oblivious view (also
        the clock source for phase cost models that only need total
        compute).  Bandwidth pools are *not* merged: the flat machine's
        ``socket_bandwidth`` equals :attr:`aggregate_bandwidth`, and
        NUMA-oblivious callers must additionally pay
        :attr:`oblivious_blend` per streamed byte."""
        cores: List[CoreSpec] = []
        for s in self.sockets:
            cores.extend(s.cores)
        return SimulatedHybridCPU(cores=cores, seed=self.seed + seed_offset)


# ----------------------------------------------------------- constructors --
def _renamed(cores: List[CoreSpec], socket: int) -> List[CoreSpec]:
    return [CoreSpec(name=f"s{socket}.{c.name}", kind=c.kind,
                     throughput=dict(c.throughput), jitter=c.jitter)
            for c in cores]


def _dual(flat_factory: Callable[..., SimulatedHybridCPU], name: str,
          seed: int, penalty: float) -> MachineTopology:
    sockets = [
        SocketSpec(name=f"socket{i}",
                   cores=_renamed(flat_factory(seed=0).cores, i))
        for i in range(2)
    ]
    return MachineTopology(sockets=sockets, cross_socket_penalty=penalty,
                           seed=seed, name=name)


def make_dual_125h(seed: int = 0) -> MachineTopology:
    """Two Ultra-7-125H clusters behind a fabric: the AIPC scale-out
    configuration — each cluster keeps its own LPDDR5x pool (~89.6 GB/s),
    remote streaming sustains ~55% of local (penalty 1.8)."""
    return _dual(make_ultra_125h, "dual-125h", seed, penalty=1.8)


def make_2s_12900k(seed: int = 0) -> MachineTopology:
    """Dual-socket 12900K-class board: per-socket DDR5-4800 dual channel
    (~76.8 GB/s each), UPI-style interconnect (penalty 1.8)."""
    return _dual(make_12900k, "2s-12900k", seed, penalty=1.8)


TOPOLOGIES: Dict[str, Callable[..., MachineTopology]] = {
    "dual-125h": make_dual_125h,
    "2s-12900k": make_2s_12900k,
}


def make_topology(name: str, seed: int = 0) -> MachineTopology:
    """Resolve ``name`` to a :class:`MachineTopology`.  Flat machine names
    (see :data:`repro_torch.core.hybrid_sim.MACHINES`) are wrapped as their
    1-socket special case, so every machine in the repository is a valid
    topology."""
    from repro_torch.core.hybrid_sim import MACHINES

    if name in TOPOLOGIES:
        return TOPOLOGIES[name](seed=seed)
    if name in MACHINES:
        flat = MACHINES[name](seed)
        return MachineTopology(
            sockets=[SocketSpec(name="socket0", cores=list(flat.cores))],
            cross_socket_penalty=1.0, seed=seed, name=name)
    raise KeyError(
        f"unknown machine {name!r}; known: {sorted(MACHINES)}; "
        f"topology machines: {sorted(TOPOLOGIES)}")
