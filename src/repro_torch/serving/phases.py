"""Execution phases and the per-phase hybrid-CPU cost model.

The paper's Fig. 4 observation: balance ratios are *phase dependent* —
prefill is compute-bound (``avx_vnni``; P/E core ratios stay wide, ~2-3x)
while decode is memory-bound (``membw``; shared bandwidth compresses
ratios toward 1).  A single blended ratio table therefore misplans one of
the two phases.  Everything serving-side keys its
:class:`~repro_torch.runtime.RatioTable` entries by phase — :data:`PREFILL` /
:data:`DECODE` — at both levels:

* core dispatch (:class:`HybridPhaseCost`): each serving iteration's
  prefill chunk and decode step are split across the simulated cores by a
  per-phase :class:`~repro_torch.runtime.Balancer`, so the table converges to
  distinct "prefill" and "decode" entries;
* replica routing (:class:`~repro_torch.serving.dispatch.InflightDispatcher`):
  per-replica tokens/s are learned separately per phase.

:class:`HybridPhaseCost` doubles as the engine's deterministic virtual
clock: on this 1-core container the real jitted model supplies *tokens*
while the simulated machine supplies *time*.
"""

# lint: virtual-clock-module
from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.core import events as _ev
from repro_torch.core.hybrid_sim import SimulatedHybridCPU, make_machine
from repro_torch.core.pool import VirtualWorkerPool
from repro_torch.kernels import dispatch as _kernel
from repro_torch.runtime import (
    Balancer,
    EvenPolicy,
    ProportionalPolicy,
    RatioTable,
    StatsSink,
    run_plan,
)

__all__ = ["PREFILL", "DECODE", "PHASES", "PHASE_ISA", "TRUNK_KINDS",
           "phase_kernel_key", "PhaseCostModel", "HybridPhaseCost",
           "LinearPhaseCost", "phase_balancers"]

PREFILL = "prefill"
DECODE = "decode"
PHASES = (PREFILL, DECODE)

# Each phase's primary ISA (paper §2.1: kernels sharing a bottleneck share
# ratio tables): prefill GEMMs are compute-bound VNNI work, decode GEMVs are
# bound by shared memory bandwidth.  Kernel-level dispatch (e.g. a
# :class:`~repro_torch.models.layers.BalancedQuantLinear` head) keys its per-core
# ratio table with this map.
PHASE_ISA = {PREFILL: "avx_vnni", DECODE: "membw"}

# Balanced-trunk dispatch refines the keying to (phase ISA x layer kind):
# every projection family of the decode step owns a ratio vector per phase
# — "membw/attn_proj", "avx_vnni/mlp_up", ... (see repro_torch.kernels.dispatch).
TRUNK_KINDS = _kernel.TRUNK_KINDS


def phase_kernel_key(phase: str, kind: Optional[str] = None) -> str:
    """Ratio-table key for a trunk projection in ``phase``:
    ``"<phase isa>/<kind>"`` (bare phase ISA when ``kind`` is None — the
    PR-3 balanced-head convention)."""
    return _kernel.kernel_key(PHASE_ISA[phase], kind)


def phase_balancers(table: RatioTable, sink: Optional[StatsSink] = None,
                    active=None):
    """One units-feedback Balancer per phase over a shared table — the
    construction both levels of the control loop (core dispatch here,
    replica dispatch in :mod:`repro_torch.serving.dispatch`) run on.

    ``active`` is an optional zero-argument probe returning the current
    boolean worker mask (see :class:`~repro_torch.runtime.ProportionalPolicy`):
    masked workers get zero-width shares and keep their learned ratios."""
    return {
        phase: Balancer(
            ProportionalPolicy(table, key=phase, feedback="units",
                               active=active),
            sink=sink, keep_stats=False)
        for phase in PHASES
    }


@runtime_checkable
class PhaseCostModel(Protocol):
    """Virtual-time source for one serving iteration's two phases."""

    def prefill_seconds(self, n_tokens: int, ctx: int) -> float: ...

    def decode_seconds(self, n_active: int, ctx: int) -> float: ...


class HybridPhaseCost:
    """Paper-faithful per-phase core dispatch on a simulated hybrid CPU.

    Each phase call plans a proportional split of the phase's work across
    the machine's cores (Eq. 3) under the phase's ratio-table key, runs it
    on a :class:`VirtualWorkerPool` with the phase's primary ISA, feeds the
    per-core times back (Eq. 2 + EMA), and returns the region makespan.

    Work-volume defaults model a llama2-7B-class checkpoint (Q4 weights):
    ``prefill_macs_per_token`` int8 MACs per prompt token and
    ``decode_bytes_per_step`` streamed weight bytes per decode step, plus
    ``kv_bytes_per_ctx_token`` per active request per context token.
    """

    def __init__(self, machine: SimulatedHybridCPU | str = "ultra-125h", *,
                 table: Optional[RatioTable] = None, alpha: float = 0.3,
                 seed: int = 0, sink: Optional[StatsSink] = None,
                 prefill_macs_per_token: float = 14e9,
                 decode_bytes_per_step: float = 3.9e9,
                 kv_bytes_per_ctx_token: float = 1e6,
                 decode_units: int = 4096, dynamic: bool = True):
        if isinstance(machine, str):
            machine = make_machine(machine, seed=seed)
        if hasattr(machine, "flattened"):
            # A MachineTopology: the phase cost model only needs total
            # compute and aggregate bandwidth for its virtual clock, so it
            # runs over the flattened view (socket-local kernel timing
            # lives in repro.topology.TopologyDispatcher).
            machine = machine.flattened()
        self.machine = machine
        self.table = table or RatioTable(machine.n_cores, alpha=alpha)
        if self.table.n_workers != machine.n_cores:
            raise ValueError("table size does not match machine core count")
        self.prefill_macs_per_token = prefill_macs_per_token
        self.decode_bytes_per_step = decode_bytes_per_step
        self.kv_bytes_per_ctx_token = kv_bytes_per_ctx_token
        self.decode_units = decode_units
        self.dynamic = dynamic
        self._pools = {phase: VirtualWorkerPool(machine, isa=PHASE_ISA[phase])
                       for phase in PHASES}
        if dynamic:
            # per-phase capacity probe: sample the machine's active mask
            # at *that phase's pool clock* (the instant its next region
            # starts), so a park event mid-serve zeroes the parked cores'
            # shares on the very next iteration with no extra wiring
            self._balancers = {
                phase: Balancer(
                    ProportionalPolicy(
                        self.table, key=phase, feedback="units",
                        active=(lambda p=phase: machine.active_mask(
                            self._pools[p].clock))),
                    sink=sink, keep_stats=False)
                for phase in PHASES
            }
        else:
            # the static (OpenMP balanced parallel-for) clock: equal
            # shares, no feedback, capacity-blind — bench_elastic's
            # baseline arm
            self._balancers = {
                phase: Balancer(EvenPolicy(machine.n_cores),
                                sink=sink, keep_stats=False)
                for phase in PHASES
            }
        # bytes-moved / busy-seconds accounting for the paper's achieved-
        # bandwidth fraction (decode is the bandwidth-bound phase).
        self._bytes = {phase: 0.0 for phase in PHASES}
        self._busy = {phase: 0.0 for phase in PHASES}

    def ratios(self, phase: str) -> np.ndarray:
        return self.table.ratios(phase)

    def _region(self, phase: str, n_units: int, work_per_unit: float,
                bytes_total: float = 0.0) -> float:
        bal = self._balancers[phase]
        pool = self._pools[phase]
        tracing = _ev.TRACER is not None
        t0 = pool.clock
        plan = bal.plan(n_units)
        times = run_plan(pool, plan, None, work_per_unit)
        st = bal.report(plan, times, bytes_moved=bytes_total)
        if bytes_total > 0 and st.makespan > 0:
            self._bytes[phase] += bytes_total
            self._busy[phase] += st.makespan
        if tracing:
            _ev.emit_span(f"phase:{phase}", phase, t0, pool.clock - t0,
                          cat="phase",
                          args=lambda: {"units": int(n_units),
                                        "imbalance": round(st.imbalance, 4)})
            _ev.emit_counter(
                f"ratio:{phase}", pool.clock,
                lambda: {f"w{i}": round(float(r), 5)
                         for i, r in enumerate(self.table.ratios(phase))})
            _ev.emit_counter(
                "capacity", pool.clock,
                lambda: {"active_cores": int(
                    self.machine.active_mask(pool.clock).sum())})
            if bytes_total > 0:
                _ev.emit_counter(
                    f"bw:{phase}", pool.clock,
                    lambda: {"achieved_bw_frac": round(
                        self.achieved_bandwidth_fraction(phase), 5)})
        return float(times.max(initial=0.0))

    def prefill_seconds(self, n_tokens: int, ctx: int) -> float:
        """Compute-bound chunk: split the token dimension across cores."""
        if n_tokens <= 0:
            return 0.0
        return self._region(PREFILL, int(n_tokens), self.prefill_macs_per_token)

    def decode_seconds(self, n_active: int, ctx: int) -> float:
        """Memory-bound step: weights stream once for the whole batch, KV
        reads scale with active requests x context; the split dimension is
        abstract weight-row tiles."""
        if n_active <= 0:
            return 0.0
        total_bytes = (self.decode_bytes_per_step
                       + n_active * max(ctx, 0) * self.kv_bytes_per_ctx_token)
        return self._region(DECODE, self.decode_units,
                            total_bytes / self.decode_units,
                            bytes_total=total_bytes)

    def achieved_bandwidth_fraction(self, phase: str = DECODE) -> float:
        """Achieved bytes/s of the phase's regions so far, as a fraction of
        the machine's streaming (MLC-analogue) socket bandwidth — the
        paper's >90% headline metric.  0 before any bytes moved."""
        busy = self._busy.get(phase, 0.0)
        if busy <= 0:
            return 0.0
        return (self._bytes[phase] / busy) / self.machine.socket_bandwidth


class LinearPhaseCost:
    """Trivial deterministic cost model (tests / heterogeneous-replica
    studies): prefill costs ``prefill_per_token`` per prompt token, decode
    ``decode_per_step`` per iteration plus ``decode_per_active`` per row."""

    def __init__(self, prefill_per_token: float = 1e-3,
                 decode_per_step: float = 1e-3,
                 decode_per_active: float = 0.0):
        self.prefill_per_token = prefill_per_token
        self.decode_per_step = decode_per_step
        self.decode_per_active = decode_per_active

    def prefill_seconds(self, n_tokens: int, ctx: int) -> float:
        return 0.0 if n_tokens <= 0 else self.prefill_per_token * n_tokens

    def decode_seconds(self, n_active: int, ctx: int) -> float:
        if n_active <= 0:
            return 0.0
        return self.decode_per_step + self.decode_per_active * n_active
