"""Deterministic virtual-time model of a hybrid CPU.

This container exposes a single physical core, so the paper's hardware
(Core i9-12900K: 8 P + 8 E cores; Core Ultra 7 125H: 4 P + 8 E + 2 LP-E)
cannot be exercised with real threads.  Instead we model each core's
throughput per ISA and let the :class:`repro_torch.core.pool.VirtualWorkerPool`
convert assigned work into per-core times:

    t = work / (throughput(isa) * jitter * background_slowdown(now))

Throughput numbers below are calibrated to public microbenchmark ratios:
 * Golden Cove P-cores sustain roughly 3-4x the VNNI throughput of a
   Gracemont E-core (2x wider VNNI ports * ~1.5-1.7x frequency), and ~2-3x
   for plain AVX2 float work.
 * Memory-bound work (GEMV) is limited by the *shared* bandwidth, so per-core
   "throughput" ratios compress toward 1.5-2x — matching the paper's Fig. 4
   observation that decode-phase ratios are smaller than prefill-phase ones.

The model includes multiplicative log-normal jitter (frequency/dvfs noise)
and optional background-load intervals that throttle specific cores, which
is what the EMA filter (alpha = 0.3) is for.
"""

# lint: virtual-clock-module
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core import events as _ev

__all__ = ["CoreSpec", "CapacityEvent", "SimulatedHybridCPU", "make_machine",
           "MACHINES"]


@dataclass(frozen=True)
class CoreSpec:
    name: str
    kind: str  # "P" | "E" | "LP"
    # work-units per second, per ISA.  Work units are kernel-defined
    # (e.g. MACs for GEMM, bytes for GEMV).
    throughput: Dict[str, float]
    jitter: float = 0.02  # lognormal sigma of per-task noise


@dataclass(frozen=True)
class CapacityEvent:
    """A scheduled capacity change on one core's virtual timeline.

    ``kind="park"``: the OS parks the core for ``[t_start, t_end)`` — work
    still *assigned* there crawls at the machine's ``park_slowdown`` (its
    thread is time-sliced onto a sibling), and :meth:`SimulatedHybridCPU.
    active_mask` reports the core inactive so planners stop assigning to
    it.  ``kind="scale"``: DVFS/thermal frequency scaling — throughput is
    divided by ``factor`` for the window but the core stays *active*
    (planners keep using it; the ratio loop re-learns its share).

    Unlike the ``background`` throttle list (which models *interference*
    the planner must learn around), capacity events are *observable*: the
    dispatcher may read ``active_mask`` the way a runtime reads
    ``sched_getaffinity``.
    """

    t_start: float
    t_end: float
    core: int
    kind: str = "park"  # "park" | "scale"
    factor: float = 1.0  # for "scale": throughput divisor (> 1 slows)

    def __post_init__(self) -> None:
        if self.kind not in ("park", "scale"):
            raise ValueError(f"unknown capacity event kind {self.kind!r}")
        if self.kind == "scale" and self.factor <= 0:
            raise ValueError("scale factor must be positive")


@dataclass
class SimulatedHybridCPU:
    cores: List[CoreSpec]
    seed: int = 0
    # background load: (t_start, t_end, core_index, slowdown_factor>1)
    background: List[Tuple[float, float, int, float]] = field(default_factory=list)
    # scheduled capacity changes (core parking / DVFS) — see CapacityEvent
    capacity: List[CapacityEvent] = field(default_factory=list)
    # effective slowdown of work left on a parked core: its thread is
    # time-sliced onto a sibling, so it crawls rather than stalls forever
    # (static planners that ignore active_mask still terminate)
    park_slowdown: float = 32.0

    def __post_init__(self) -> None:
        self._rng = np.random.default_rng(self.seed)

    @property
    def n_cores(self) -> int:
        return len(self.cores)

    def true_throughput(self, isa: str) -> np.ndarray:
        return np.array([c.throughput[isa] for c in self.cores])

    # -------------------------------------------------- capacity schedule --
    def park(self, core: int, t_start: float = 0.0,
             t_end: float = float("inf")) -> None:
        """Park ``core`` for ``[t_start, t_end)`` (default: from now on,
        forever — the drift-test idiom that is valid on every pool timeline
        regardless of clock skew)."""
        self.capacity.append(CapacityEvent(t_start, t_end, core, "park"))
        if _ev.RECORDER is not None:
            _ev.record("capacity", f"core{core}", t=t_start, action="park",
                       t_end=None if t_end == float("inf") else t_end)

    def unpark(self, core: int) -> None:
        """Drop every park event for ``core`` (scale events stay)."""
        self.capacity = [ev for ev in self.capacity
                         if not (ev.kind == "park" and ev.core == core)]
        if _ev.RECORDER is not None:
            _ev.record("capacity", f"core{core}", action="unpark")

    def set_freq_scale(self, core: int, factor: float, t_start: float = 0.0,
                       t_end: float = float("inf")) -> None:
        """DVFS: divide ``core``'s throughput by ``factor`` over the window.
        The core stays active — planners keep it and re-learn its ratio."""
        self.capacity.append(CapacityEvent(t_start, t_end, core, "scale",
                                           factor))
        if _ev.RECORDER is not None:
            _ev.record("capacity", f"core{core}", t=t_start, action="scale",
                       factor=factor,
                       t_end=None if t_end == float("inf") else t_end)

    def clear_capacity(self, core: "int | None" = None) -> None:
        """Drop all capacity events (or just ``core``'s)."""
        if core is None:
            self.capacity = []
        else:
            self.capacity = [ev for ev in self.capacity if ev.core != core]

    def active_mask(self, now: float = 0.0) -> np.ndarray:
        """Boolean per-core mask: True where the core is *not* parked at
        ``now``.  This is the observable signal dispatchers probe at plan
        time; scale events do not deactivate a core."""
        mask = np.ones(self.n_cores, dtype=bool)
        for ev in self.capacity:
            if ev.kind == "park" and ev.t_start <= now < ev.t_end:
                mask[ev.core] = False
        return mask

    def capacity_slowdown(self, core: int, now: float) -> float:
        """Multiplicative slowdown from capacity events covering ``now``."""
        s = 1.0
        for ev in self.capacity:
            if ev.core == core and ev.t_start <= now < ev.t_end:
                s *= self.park_slowdown if ev.kind == "park" else ev.factor
        return s

    def background_slowdown(self, core: int, now: float) -> float:
        s = 1.0
        for t0, t1, idx, factor in self.background:
            if idx == core and t0 <= now < t1:
                s *= factor
        return s

    def _slowdown(self, core: int, now: float) -> float:
        s = self.background_slowdown(core, now)
        if self.capacity:
            s *= self.capacity_slowdown(core, now)
        return s

    def task_wall_time(self, core: int, start: float, base_seconds: float) -> float:
        """Wall seconds to complete ``base_seconds`` of unthrottled execution
        starting at virtual time ``start``, integrating the (piecewise-
        constant) slowdown — background throttles *and* capacity events —
        over the task's own interval rather than sampling it once at
        ``start``: an interval that begins or ends mid-task is applied
        exactly for the portion it overlaps.
        """
        if base_seconds <= 0:
            return 0.0
        boundaries = sorted(
            {t for t0, t1, idx, _ in self.background
             if idx == core for t in (t0, t1) if t > start}
            | {t for ev in self.capacity if ev.core == core
               for t in (ev.t_start, ev.t_end) if t > start})
        t, remaining = start, base_seconds
        for b in boundaries:
            s = self._slowdown(core, t)
            capacity = (b - t) / s  # base-seconds executable before b
            if remaining <= capacity:
                return (t + remaining * s) - start
            remaining -= capacity
            t = b
        return (t + remaining * self._slowdown(core, t)) - start

    def task_time(self, worker: int, isa: str, work: float, now: float) -> float:
        if work <= 0:
            return 0.0
        spec = self.cores[worker]
        tp = spec.throughput.get(isa)
        if tp is None:
            raise KeyError(f"core {spec.name} has no throughput entry for ISA {isa!r}")
        jitter = float(np.exp(self._rng.normal(0.0, spec.jitter)))
        return self.task_wall_time(worker, now, work / (tp * jitter))

    def optimal_makespan(self, isa: str, total_work: float) -> float:
        """Lower bound: all cores busy until the same instant (no jitter)."""
        return total_work / self.true_throughput(isa).sum()

    @property
    def socket_bandwidth(self) -> float:
        """Aggregate streaming bandwidth (bytes/s) when every core draws its
        sustainable share — the MLC-measured number the paper's >90% achieved-
        bandwidth claim is a fraction of."""
        return float(self.true_throughput("membw").sum())


def _core(name: str, kind: str, ghz: float, vnni_lanes: float, mem_share: float,
          jitter: float) -> CoreSpec:
    """Build a core's per-ISA throughput table from simple first principles.

    * ``avx_vnni`` (int8 MACs/s): lanes/cycle * freq — compute bound.
    * ``avx2`` (fp32 FLOPs/s): half the int8 lane width.
    * ``membw`` (bytes/s): share of socket bandwidth this core can draw when
      all cores stream (hybrid E-cores draw nearly as much as P-cores, which
      compresses decode-phase ratios — see paper Fig. 4).
    """
    return CoreSpec(
        name=name,
        kind=kind,
        throughput={
            "avx_vnni": vnni_lanes * ghz * 1e9,
            "avx2": vnni_lanes * 0.5 * ghz * 1e9,
            "membw": mem_share,
        },
        jitter=jitter,
    )


def make_ultra_125h(seed: int = 0) -> SimulatedHybridCPU:
    """Core Ultra 7 125H: 4 P (Redwood Cove) + 8 E (Crestmont) + 2 LP-E.

    Compute calibration (effective, within a VNNI GEMM micro-kernel):
    P ~ 64 int8 MAC/cycle @ 4.5 GHz = 288 GMAC/s; E-cores land at ~45% of a
    P-core (narrower VNNI ports, smaller L2 slice), LP-E at ~36%.  This puts
    the machine's static-partition penalty (= mean/min throughput, what an
    equal OpenMP split loses) at ~1.65, matching the paper's 65% GEMM
    improvement on this part.

    Memory calibration: socket ~89.6 GB/s (LPDDR5x-7467).  Bandwidth is a
    *shared* resource; what differs per core is the sustainable per-core
    draw (queue depth / fabric position), which is only mildly hybrid:
    P 7.2, E 6.0, LP-E 5.2 GB/s (sums to ~87 GB/s).  This reproduces the
    paper's small-but-real decode-phase gains (9-22%) and the Fig. 4
    observation that decode-phase ratios compress toward 1.
    """
    cores: list[CoreSpec] = []
    for i in range(4):
        cores.append(_core(f"P{i}", "P", 4.5, 64.0, 7.6e9, 0.03))
    for i in range(8):
        cores.append(_core(f"E{i}", "E", 4.05, 32.0, 6.0e9, 0.02))
    for i in range(2):
        cores.append(_core(f"LP{i}", "LP", 3.0, 32.0, 5.0e9, 0.02))
    return SimulatedHybridCPU(cores=cores, seed=seed)


def make_12900k(seed: int = 0) -> SimulatedHybridCPU:
    """Core i9-12900K: 8 P (Golden Cove ~4.9 GHz) + 8 E (Gracemont ~3.7 GHz).

    Effective GEMM throughput ratio P/E ~ 2.7 => static penalty
    (8*2.7+8)/16/1 ~ 1.85, matching the paper's 85% GEMM improvement.
    DDR5-4800 dual channel ~76.8 GB/s shared; per-core draws P 5.4 / E 4.4.
    """
    cores: list[CoreSpec] = []
    for i in range(8):
        cores.append(_core(f"P{i}", "P", 4.9, 64.0, 5.7e9, 0.03))
    for i in range(8):
        cores.append(_core(f"E{i}", "E", 3.7, 28.6, 4.1e9, 0.02))
    return SimulatedHybridCPU(cores=cores, seed=seed)


def make_homogeneous(n: int = 8, seed: int = 0) -> SimulatedHybridCPU:
    """Non-hybrid reference (server-like): dynamic == static expected."""
    cores = [_core(f"C{i}", "P", 3.0, 32.0, 9e9, 0.01) for i in range(n)]
    return SimulatedHybridCPU(cores=cores, seed=seed)


MACHINES = {
    "ultra-125h": make_ultra_125h,
    "core-12900k": make_12900k,
    "homogeneous-8": lambda seed=0: make_homogeneous(n=8, seed=seed),
}


def make_machine(name: str, seed: int = 0):
    """Resolve a machine name: flat hybrid CPUs from :data:`MACHINES`, or a
    multi-socket :class:`~repro_torch.topology.machine.MachineTopology`
    from :data:`~repro_torch.topology.machine.TOPOLOGIES` (lazily imported
    — the topology package builds on this module).  ``seed`` is forwarded
    to whichever constructor matches."""
    if name in MACHINES:
        return MACHINES[name](seed)
    from repro_torch.topology.machine import make_topology

    # make_topology owns the topology registry and the unknown-name error
    # (which lists both registries)
    return make_topology(name, seed=seed)
