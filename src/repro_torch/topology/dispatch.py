# lint: virtual-clock-module
"""Two-level balanced dispatch over a NUMA topology.

:class:`TopologyDispatcher` generalizes the flat
:class:`~repro_torch.kernels.dispatch.HybridKernelDispatcher` to a
:class:`~repro_torch.topology.machine.MachineTopology`:

* **inner level** — one flat dispatcher per socket, each owning its own
  per-core :class:`~repro_torch.runtime.RatioTable` and virtual worker
  pools over that socket's
  :class:`~repro_torch.core.hybrid_sim.SimulatedHybridCPU`.  The paper's
  Eq. 2/3 loop runs unchanged *within* each bandwidth domain, which is
  exactly where its shared-pool assumption holds.
* **outer level** — a socket-level :class:`~repro_torch.runtime.RatioTable`
  (one entry per socket, ``units=`` feedback since granularity rounding
  makes realized counts differ from the proportional plan) splits every
  GEMM/GEMV's N dimension into one contiguous column range per socket.
  Sockets execute concurrently: the region's wall time is the max of the
  per-socket makespans, and the feedback converges the split to the point
  where all domains finish together.

NUMA placement closes the loop: each weight's column ranges are pinned to
sockets (see :mod:`repro_torch.topology.placement`; default: proportional
to socket bandwidth).  A socket assigned columns outside its resident
range streams them across the fabric at ``cross_socket_penalty`` wall time
per byte — modelled by inflating the region's work (never its bytes: a
remote byte is still one byte of traffic, it just takes longer), so the
learned split is pulled toward the placement and the achieved-bandwidth
fraction honestly reflects any mismatch.  The sockets and their resident
ranges exist only in this machine model: on a GPU nothing is pinned or
moved, and the kernels read the weights where they are.

``socket_local=False`` is the **socket-oblivious baseline**: one flat
dispatcher over all cores with interleaved (NUMA-unaware) page placement,
paying :attr:`~repro_torch.topology.machine.MachineTopology.oblivious_blend`
per streamed byte.  Same execution path, so socket-local vs oblivious
comparisons isolate exactly the topology contribution — the dual-socket
analogue of the dispatcher's ``dynamic=False`` OpenMP baseline.

Kernel entry points (``q4_matmul`` / ``int8_gemm`` / ``f32_matmul``)
keep the flat dispatcher's signatures, so
:class:`~repro_torch.models.balanced.BalancedTrunk` and the balanced
layers bind to a :class:`TopologyDispatcher` unchanged.  Eagerly, each
socket runs one kernel launch per non-empty core shard of its column
range, and the per-socket outputs are concatenated along N.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis import invariants as _contracts
from repro_torch.core import events as _ev
from repro_torch.core.tuner import KernelTuner
from repro_torch.kernels.dispatch import GEMV_ISA, HybridKernelDispatcher
from repro_torch.quant.q4 import BYTES_PER_ELEM, QuantizedLinear
from repro_torch.runtime import (
    Balancer,
    EvenPolicy,
    KernelSpec,
    ProportionalPolicy,
    RatioTable,
    RegionStats,
    StatsSink,
)

from .machine import MachineTopology, make_topology, place_rows

__all__ = ["TopologyDispatcher"]

Ranges = Tuple[Tuple[int, int], ...]


class TopologyDispatcher:
    """Socket-local balanced dispatch (or its socket-oblivious baseline)
    over a multi-socket machine.

    One instance owns one socket-level ratio table, one flat
    :class:`HybridKernelDispatcher` per socket, a placement registry
    pinning weights' column ranges to sockets, one :class:`KernelTuner`
    that every socket's shards share (``tuner=``), and aggregate
    bytes/busy accounting on top of the per-socket accounting the inner
    dispatchers already keep.  ``execute=True`` runs the real kernel shards (the eager
    trunk); the compiled trunk only replays plans through the pools.
    """

    def __init__(self, topology: MachineTopology | str, *,
                 dynamic: bool = True, socket_local: bool = True,
                 execute: bool = False, alpha: float = 0.3, seed: int = 0,
                 table: Optional[RatioTable] = None,
                 tuner: Optional[KernelTuner] = None,
                 sink: Optional[StatsSink] = None, keep_stats: bool = True):
        if isinstance(topology, str):
            topology = make_topology(topology, seed=seed)
        self.topology = topology
        self.dynamic = dynamic
        self.socket_local = socket_local
        self.sink = sink
        self.keep_stats = keep_stats
        self.stats: list = []
        # one tuner for every socket's shards: a variant's time depends on
        # the shard's shape, not on the simulated socket it is charged to
        self.tuner = tuner or KernelTuner()
        sub_kwargs = dict(dynamic=dynamic, execute=execute, alpha=alpha,
                          tuner=self.tuner, sink=sink, keep_stats=False)
        if socket_local:
            self.socket_dispatchers = [
                HybridKernelDispatcher.virtual(m, **sub_kwargs)
                for m in topology.machines
            ]
            self.flat = None
            self.table = table or RatioTable(topology.n_sockets, alpha=alpha)
            if self.table.n_workers != topology.n_sockets:
                raise ValueError("table size does not match socket count")
        else:
            self.socket_dispatchers = []
            self.flat = HybridKernelDispatcher.virtual(
                topology.flattened(), **sub_kwargs)
            self.table = None
        self._balancers: Dict[tuple, Balancer] = {}
        self._bytes: Dict[str, float] = {}
        self._busy: Dict[str, float] = {}
        # concurrent shard reports must not interleave the aggregate
        # read-modify-write — the race the analysis pass flags as RC001
        self._acct_lock = threading.Lock()
        # id(weight) -> (weight kept alive, per-socket contiguous ranges)
        self._placement: Dict[int, Tuple[object, Ranges]] = {}
        self._default_ranges: Dict[int, Ranges] = {}

    # ------------------------------------------------------------- shape ---
    @property
    def n_sockets(self) -> int:
        return self.topology.n_sockets

    def close(self) -> None:
        for d in self.socket_dispatchers:
            d.close()
        if self.flat is not None:
            self.flat.close()

    # ---------------------------------------------------------- placement --
    def register_placement(self, weight, ranges) -> None:
        """Pin ``weight``'s N rows to sockets: ``ranges`` is one contiguous
        ``(lo, hi)`` per socket, in socket order, covering ``[0, N)``.  The
        weight object the trunk hands to the kernel entry points is the
        registry key (and is kept alive by the registry, so its ``id``
        cannot be recycled)."""
        ranges = tuple((int(lo), int(hi)) for lo, hi in ranges)
        if len(ranges) != self.n_sockets and self.socket_local:
            raise ValueError("need one range per socket")
        cursor = 0
        for lo, hi in ranges:
            if lo != cursor or hi < lo:
                raise ValueError("placement ranges must be contiguous "
                                 "ascending from 0")
            cursor = hi
        self._placement[id(weight)] = (weight, ranges)

    def placement_for(self, weight, total: int) -> Ranges:
        """The resident column ranges for ``weight`` (its registered
        placement, or the default bandwidth-proportional split of
        ``total``)."""
        if weight is not None and id(weight) in self._placement:
            return self._placement[id(weight)][1]
        if total not in self._default_ranges:
            self._default_ranges[total] = place_rows(
                total, self.topology.bandwidth_shares())
        return self._default_ranges[total]

    def _work_scale(self, isa: str, socket: int, rng: Tuple[int, int],
                    placement: Ranges) -> float:
        """Wall-time multiplier for socket ``socket`` executing columns
        ``rng``: the fraction resident on other sockets pays the fabric
        penalty.  Compute-bound ISAs stream comparatively few bytes, so
        only memory-bound regions are penalized."""
        penalty = self.topology.cross_socket_penalty
        if isa != GEMV_ISA or penalty <= 1.0:
            return 1.0
        lo, hi = rng
        plo, phi = placement[socket]
        local = max(0, min(hi, phi) - max(lo, plo))
        remote_frac = 1.0 - local / (hi - lo)
        return 1.0 + (penalty - 1.0) * remote_frac

    # ------------------------------------------------------------ plumbing --
    def socket_mask(self, isa: str = GEMV_ISA) -> np.ndarray:
        """Per-socket active mask: a socket stays plannable while *any* of
        its cores is active (the inner dispatcher masks the parked ones);
        a fully-parked socket gets a zero-width outer range."""
        return np.array([d.capacity_mask(isa).any()
                         for d in self.socket_dispatchers], dtype=bool)

    def _balancer(self, spec: KernelSpec) -> Balancer:
        key = (spec.table_key, spec.granularity)
        if key not in self._balancers:
            if self.dynamic:
                policy = ProportionalPolicy(
                    self.table, key=spec.table_key,
                    granularity=spec.granularity, feedback="units",
                    active=lambda isa=spec.isa: self.socket_mask(isa))
            else:
                policy = EvenPolicy(self.n_sockets,
                                    granularity=spec.granularity)
            self._balancers[key] = Balancer(policy, sink=self.sink,
                                            keep_stats=False)
        return self._balancers[key]

    def _oblivious_scale(self, isa: str) -> float:
        return (self.topology.oblivious_blend if isa == GEMV_ISA else 1.0)

    def _split(self, spec: KernelSpec, total: int, weight,
               run_socket: Callable[[int, int, int, float], float], *,
               bytes_per_unit: float, update: bool) -> RegionStats:
        """The outer loop: plan the socket split, run each socket's range
        (``run_socket(socket, lo, hi, work_scale) -> makespan seconds``),
        feed socket makespans back with ``units=`` counts, account
        aggregate bytes/busy over the concurrent region."""
        bal = self._balancer(spec)
        plan = bal.plan(total)
        placement = self.placement_for(weight, total)
        check = _contracts.contracts_enabled()
        inner_before = sum(d._bytes.get(spec.isa, 0.0)
                           for d in self.socket_dispatchers) if check else 0.0
        tracing = _ev.TRACER is not None
        times = np.zeros(self.n_sockets)
        for s, (lo, hi) in enumerate(plan.ranges):
            if hi <= lo:
                continue
            scale = self._work_scale(spec.isa, s, (lo, hi), placement)
            if tracing:
                pool = self.socket_dispatchers[s]._pools.get(spec.isa)
                t0 = float(getattr(pool, "clock", 0.0)) if pool else 0.0
            times[s] = run_socket(s, lo, hi, scale)
            if tracing:
                _ev.emit_span(
                    f"socket{s}", f"{spec.name}@{spec.table_key}",
                    t0, times[s], cat="socket",
                    args=lambda s=s, lo=lo, hi=hi: {"socket": s,
                                                    "units": hi - lo})
        moved = float(total) * bytes_per_unit
        st = bal.report(plan, times, update=update and self.dynamic,
                        label=f"{spec.name}@{spec.table_key}",
                        bytes_moved=moved)
        if tracing and self.table is not None:
            now = max((float(getattr(d._pools.get(spec.isa), "clock", 0.0))
                       if d._pools.get(spec.isa) else 0.0
                       for d in self.socket_dispatchers), default=0.0)
            _ev.emit_counter(
                f"ratio:socket:{spec.table_key}", now,
                lambda: {f"s{i}": round(float(r), 5) for i, r in
                         enumerate(self.table.ratios(spec.table_key))})
        # Sockets run concurrently: the region occupies max(times) wall
        # seconds while moving the sum of the per-socket traffic.
        if moved > 0 and st.makespan > 0:
            self._account(spec.isa, moved, st.makespan)
            if check:
                inner_after = sum(d._bytes.get(spec.isa, 0.0)
                                  for d in self.socket_dispatchers)
                _contracts.check_bytes_conserved(
                    moved, inner_after - inner_before,
                    where=f"TopologyDispatcher._split[{spec.name}]")
        if self.keep_stats:
            self.stats.append(st)
        return st

    def _account(self, isa: str, moved: float, busy: float) -> None:
        """Accrue one region's aggregate bytes/busy under the lock."""
        with self._acct_lock:
            if _ev.TRACER is not None:
                where = "TopologyDispatcher._account"
                _ev.emit_acquire(self._acct_lock, where=where)
                _ev.emit_read(self, f"bytes[{isa}]", where=where)
                _ev.emit_write(self, f"bytes[{isa}]", where=where)
            self._bytes[isa] = self._bytes.get(isa, 0.0) + moved
            self._busy[isa] = self._busy.get(isa, 0.0) + busy
            if _ev.TRACER is not None:
                _ev.emit_release(self._acct_lock,
                                 where="TopologyDispatcher._account")

    # ------------------------------------------------------------ dispatch --
    def dispatch(self, spec: KernelSpec, total: int,
                 fn: Optional[Callable[[int, int], None]] = None, *,
                 bytes_per_unit: float = 0.0, update: bool = True,
                 weight=None) -> RegionStats:
        """One balanced region of ``total`` units split socket-first, then
        per-core within each socket (both levels learn).  ``fn(start,
        size)`` receives *global* offsets.  ``weight`` selects a registered
        placement (default: bandwidth-proportional)."""
        if not self.socket_local:
            st = self.flat.dispatch(
                spec, total, fn, bytes_per_unit=bytes_per_unit,
                work_scale=self._oblivious_scale(spec.isa), update=update)
            if self.keep_stats:
                self.stats.append(st)
            return st

        def run_socket(s: int, lo: int, hi: int, scale: float) -> float:
            sub_fn = None if fn is None else (
                lambda start, size, lo=lo: fn(lo + start, size))
            st = self.socket_dispatchers[s].dispatch(
                spec, hi - lo, sub_fn, bytes_per_unit=bytes_per_unit,
                work_scale=scale, update=update)
            return st.makespan

        return self._split(spec, total, weight, run_socket,
                           bytes_per_unit=bytes_per_unit, update=update)

    # ------------------------------------------------------- real kernels --
    def _kernel(self, spec: KernelSpec, n: int, weight,
                run_sub: Callable[[int, int, int, float], torch.Tensor], *,
                bytes_per_unit: float, update: bool) -> torch.Tensor:
        """Shared kernel path: socket split, per-socket sub-kernel on the
        sliced weight rows, outputs concatenated in column order (equal to
        the monolithic kernel — N-row shards never touch a reduction)."""
        if not self.socket_local:
            raise RuntimeError("_kernel is a socket-local path")
        outs: Dict[int, torch.Tensor] = {}

        def run_socket(s: int, lo: int, hi: int, scale: float) -> float:
            outs[s] = run_sub(s, lo, hi, scale)
            return self.socket_dispatchers[s].last_stats.makespan

        self._split(spec, n, weight, run_socket,
                    bytes_per_unit=bytes_per_unit, update=update)
        return torch.cat([outs[s] for s in sorted(outs)], dim=-1)

    def q4_matmul(self, x: torch.Tensor, qw: QuantizedLinear, *,
                  isa: str = GEMV_ISA, key: Optional[str] = None,
                  variant: Optional[tuple] = None, granularity: int = 8,
                  update: bool = True) -> torch.Tensor:
        """Fp32-Int4-Fp32 ``x (M,K) @ Q4_0 (N,K).T``: columns sharded
        socket-first by the outer table, then per-core kernel shards
        within each socket (see :meth:`HybridKernelDispatcher.q4_matmul`);
        each socket's shards are contiguous row ranges of the packed
        weight."""
        if not self.socket_local:
            return self.flat.q4_matmul(
                x, qw, isa=isa, key=key, variant=variant,
                granularity=granularity,
                work_scale=self._oblivious_scale(isa), update=update)
        m, k = x.shape
        bytes_per_row = k * BYTES_PER_ELEM
        work = bytes_per_row if isa == GEMV_ISA else 2.0 * m * k
        spec = KernelSpec("q4_matmul", isa=isa, granularity=granularity,
                          work_per_unit=work, key=key)

        def run_sub(s, lo, hi, scale):
            shard = QuantizedLinear(qw.packed[lo:hi], qw.scales[lo:hi])
            return self.socket_dispatchers[s].q4_matmul(
                x, shard, isa=isa, key=key, variant=variant,
                granularity=granularity, work_scale=scale, update=update)

        return self._kernel(spec, qw.out_features, qw, run_sub,
                            bytes_per_unit=bytes_per_row, update=update)

    def int8_gemm(self, a_u8: torch.Tensor, w_s8: torch.Tensor, *,
                  isa: str = "avx_vnni", key: Optional[str] = None,
                  variant: Optional[tuple] = None, granularity: int = 16,
                  update: bool = True) -> torch.Tensor:
        """u8 x s8 -> s32 GEMM, socket-sharded then core-sharded (s32
        accumulation keeps shard outputs bit-identical)."""
        if not self.socket_local:
            return self.flat.int8_gemm(
                a_u8, w_s8, isa=isa, key=key, variant=variant,
                granularity=granularity,
                work_scale=self._oblivious_scale(isa), update=update)
        m, k = a_u8.shape
        work = 2.0 * m * k if isa != GEMV_ISA else float(k)
        spec = KernelSpec("int8_gemm", isa=isa, granularity=granularity,
                          work_per_unit=work, key=key)

        def run_sub(s, lo, hi, scale):
            return self.socket_dispatchers[s].int8_gemm(
                a_u8, w_s8[lo:hi], isa=isa, key=key, variant=variant,
                granularity=granularity, work_scale=scale, update=update)

        return self._kernel(spec, int(w_s8.shape[0]), w_s8, run_sub,
                            bytes_per_unit=float(k), update=update)

    def f32_matmul(self, x: torch.Tensor, w: torch.Tensor, *,
                   isa: str = GEMV_ISA, key: Optional[str] = None,
                   granularity: int = 1, update: bool = True) -> torch.Tensor:
        """f32 ``x @ W.T``, socket-sharded then core-sharded; the
        precision-reference path of the flat dispatcher."""
        if not self.socket_local:
            return self.flat.f32_matmul(
                x, w, isa=isa, key=key, granularity=granularity,
                work_scale=self._oblivious_scale(isa), update=update)
        m, k = x.shape
        bytes_per_row = 4.0 * k
        work = bytes_per_row if isa == GEMV_ISA else 2.0 * m * k
        spec = KernelSpec("f32_matmul", isa=isa, granularity=granularity,
                          work_per_unit=work, key=key)

        def run_sub(s, lo, hi, scale):
            return self.socket_dispatchers[s].f32_matmul(
                x, w[lo:hi], isa=isa, key=key, granularity=granularity,
                work_scale=scale, update=update)

        return self._kernel(spec, int(w.shape[0]), w, run_sub,
                            bytes_per_unit=bytes_per_row, update=update)

    # ----------------------------------------------------------- telemetry --
    def reset_bandwidth_accounting(self) -> None:
        """Zero aggregate and per-socket bytes/busy counters (steady-state
        measurement windows)."""
        self._bytes.clear()
        self._busy.clear()
        for d in self.socket_dispatchers:
            d.reset_bandwidth_accounting()
        if self.flat is not None:
            self.flat.reset_bandwidth_accounting()

    def achieved_bandwidth(self, isa: str = GEMV_ISA,
                           socket: Optional[int] = None) -> float:
        """Aggregate bytes/s of this dispatcher's ``isa`` regions (total
        bytes over concurrent-region wall time), or one socket's."""
        if socket is not None:
            if not self.socket_local:
                raise ValueError("per-socket bandwidth is undefined for "
                                 "the socket-oblivious baseline")
            return self.socket_dispatchers[socket].achieved_bandwidth(isa)
        if not self.socket_local:
            return self.flat.achieved_bandwidth(isa)
        busy = self._busy.get(isa, 0.0)
        if busy <= 0:
            return 0.0
        return self._bytes.get(isa, 0.0) / busy

    def achieved_bandwidth_fraction(self, isa: str = GEMV_ISA,
                                    socket: Optional[int] = None) -> float:
        """The paper's headline metric at topology scale: aggregate
        achieved bandwidth over the sum of per-socket streaming bandwidths
        (or, with ``socket=``, one domain's fraction of its own pool)."""
        if socket is not None:
            return (self.achieved_bandwidth(isa, socket=socket)
                    / self.topology.socket_bandwidth(socket))
        return self.achieved_bandwidth(isa) / self.topology.aggregate_bandwidth

    def socket_ratios(self, key: str) -> np.ndarray:
        """The outer (socket-level) ratio table for ``key``."""
        if self.table is None:
            raise ValueError("the socket-oblivious baseline has no "
                             "socket-level table")
        return self.table.ratios(key)
