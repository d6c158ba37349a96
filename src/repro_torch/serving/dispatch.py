"""In-flight request dispatch across replicas by per-phase throughput.

Replaces the seed's whole-batch barrier (``RoutedServer.serve_batch``):
requests are routed *individually* the moment they arrive, and every
replica keeps decoding while others prefill — the serving analogue of the
paper's proportional core dispatch, but with the ratio table keyed by
execution phase ("prefill" / "decode") because the two phases expose
different relative replica speeds (compute-bound vs memory-bound, paper
Fig. 4).

Routing is load-aware Eq. 3: a new request goes to the replica with the
smallest estimated backlog in ratio-normalized time::

    score_i = (pending_prefill_tokens_i + prompt_len) / pr_i^prefill
            + (running_i + 1) * expected_new / pr_i^decode

Feedback is iteration-level: each :meth:`step` runs one iteration on every
replica and reports (tokens, seconds) per phase through two
:class:`~repro_torch.runtime.Balancer` instances over one shared
:class:`~repro_torch.runtime.RatioTable`, with zero-work replicas masked out of
the EMA (``units=`` feedback).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import events as _ev
from repro_torch.runtime import Plan, RatioTable, RegionStats, StatsSink

from .engine import ContinuousBatchingEngine
from .phases import DECODE, PREFILL, phase_balancers
from .request import Request
from .scheduler import IterationStats

__all__ = ["InflightDispatcher"]


class InflightDispatcher:
    """Route requests across :class:`ContinuousBatchingEngine` replicas by
    measured per-phase throughput; no batch barrier anywhere."""

    def __init__(self, engines: Sequence[ContinuousBatchingEngine], *,
                 table: Optional[RatioTable] = None, alpha: float = 0.3,
                 sink: Optional[StatsSink] = None):
        if not engines:
            raise ValueError("need at least one engine")
        self.engines = list(engines)
        n = len(self.engines)
        self.table = table or RatioTable(n, alpha=alpha)
        if self.table.n_workers != n:
            raise ValueError("table size does not match replica count")
        self._balancers = phase_balancers(self.table, sink)
        # windowed feedback accumulators: (units, seconds) per phase, held
        # until at least two replicas have measurements (see step())
        self._acc = {phase: (np.zeros(n, dtype=np.int64), np.zeros(n))
                     for phase in (PREFILL, DECODE)}
        # replica liveness: deactivated replicas are skipped by routing and
        # stepping and masked out of EMA feedback (see set_active)
        self.active = np.ones(n, dtype=bool)
        # requests that arrived while *every* replica was inactive; held
        # here and flushed the moment one reactivates (see submit)
        self.pending: List[Request] = []
        # latest emitted per-phase RegionStats — the child-telemetry probe
        # a recursive parent balancer snapshots (RegionStats.children)
        self.last_stats: Dict[str, RegionStats] = {}

    # ----------------------------------------------------------- liveness --
    def set_active(self, i: int, active: bool = True) -> None:
        """Mark replica ``i`` failed (or recovered).  Deactivation clears
        the replica's windowed feedback accumulators: a replica that shed
        or died mid-window has *partial* (units, seconds) sums that would
        otherwise ride into a later multi-replica report and EMA-drag its
        ratio via a stale ``units=`` measurement — the same
        absence-of-measurement rule :attr:`~repro_torch.runtime.RegionStats.
        measured` applies to zero-count workers (its entries then sit at
        (0, 0.0) and the table's ``units > 0`` mask carries its ratio
        over unchanged)."""
        if not 0 <= i < len(self.engines):
            raise IndexError(f"replica {i} out of range")
        self.active[i] = bool(active)
        if not active:
            if _ev.TRACER is not None:
                for phase in self._acc:
                    _ev.emit_write(self, f"acc[{phase}]",
                                   where="InflightDispatcher.set_active")
            for acc_u, acc_t in self._acc.values():
                acc_u[i] = 0
                acc_t[i] = 0.0
        elif self.pending:
            # first replica back: flush requests deferred while every
            # replica was down (arrival order preserved)
            pending, self.pending = self.pending, []
            for r in pending:
                self.submit(r)

    # ------------------------------------------------------------ routing --
    def route(self, request: Request) -> int:
        """Pick the replica with the least ratio-normalized backlog, among
        those whose cache can serve the whole request (replicas may be
        heterogeneous in ``max_seq`` too); when no cache fits
        prompt + max_new_tokens, fall back to replicas that at least hold
        the prompt (generation then ends early at the cache edge, the
        engine's LENGTH semantics)."""
        if not self.active.any():
            raise ValueError("no active replica to route to")
        need = request.prompt_len + request.max_new_tokens
        full = [e.max_seq >= need and self.active[i]
                for i, e in enumerate(self.engines)]
        if not any(full):
            full = [e.max_seq >= request.prompt_len + 1 and self.active[i]
                    for i, e in enumerate(self.engines)]
        if not any(full):
            raise ValueError(
                f"prompt of {request.prompt_len} tokens fits no replica "
                f"(max_seq: {[e.max_seq for e in self.engines]})")
        pf = np.maximum(self.table.ratios(PREFILL), 1e-9)
        dec = np.maximum(self.table.ratios(DECODE), 1e-9)
        scores = []
        for i, e in enumerate(self.engines):
            if not full[i]:
                scores.append(np.inf)
                continue
            prefill_backlog = (e.pending_prefill_tokens + request.prompt_len) / pf[i]
            # every outstanding request will decode, whatever lifecycle
            # stage it is in right now (waiting, prefilling, or running)
            outstanding = e.n_running + e.n_prefilling + e.n_waiting + 1
            decode_backlog = outstanding * request.max_new_tokens / dec[i]
            scores.append(prefill_backlog + decode_backlog)
        return int(np.argmin(scores))  # ties -> lowest replica id

    def submit(self, request: Request) -> tuple:
        """Route and enqueue; returns (replica index, request id).

        A request arriving while *every* replica is inactive (a node-wide
        failure or capacity window) is deferred, not crashed on: it waits
        in :attr:`pending` and is resubmitted by the first
        :meth:`set_active` reactivation.  Returns ``(-1, None)`` for a
        deferred request.  :meth:`route` keeps its raise — calling it
        directly with no active replica is a programming error."""
        if not self.active.any():
            self.pending.append(request)
            return -1, None
        i = self.route(request)
        rid = self.engines[i].submit(request)
        return i, rid

    # ------------------------------------------------------------ probes --
    @property
    def pending_prefill_tokens(self) -> int:
        """Aggregate prompt tokens queued across active replicas (the
        fleet router's prefill-pressure signal for this dispatcher)."""
        return sum(e.pending_prefill_tokens
                   for i, e in enumerate(self.engines) if self.active[i])

    @property
    def queue_depth(self) -> int:
        """Outstanding (waiting + prefilling + running) requests across
        active replicas."""
        return sum(e.queue_depth
                   for i, e in enumerate(self.engines) if self.active[i])

    # ------------------------------------------------------------ driving --
    @property
    def has_work(self) -> bool:
        # pending requests are deliberately excluded: they only exist while
        # every replica is inactive, when stepping cannot make progress —
        # the caller must apply the recovery event (set_active) to proceed
        return any(e.has_work
                   for i, e in enumerate(self.engines) if self.active[i])

    @property
    def now(self) -> float:
        """Dispatcher clock = slowest replica clock (replicas run
        concurrently; the fleet is done when the last one is)."""
        return max(e.now for e in self.engines)

    def step(self) -> List[IterationStats]:
        """One iteration on every replica + per-phase ratio feedback.

        Feedback is *windowed*: per-phase (tokens, seconds) accumulate
        across iterations and are reported once at least two replicas have
        measurements — a single replica running alone carries no relative
        information (the table would carry it over anyway), but its solo
        rounds still count toward the next multi-replica comparison, so
        ratios keep learning even when replicas never work in the same
        iteration.  Deactivated replicas are not stepped and contribute
        empty stats (units 0 -> masked out of the update)."""
        tracing = _ev.TRACER is not None
        stats = []
        for i, e in enumerate(self.engines):
            if not self.active[i]:
                stats.append(IterationStats(now=e.now))
                continue
            if tracing:
                # replica scope: the engine's spans (and everything its
                # cost model dispatches) land in this replica's process
                _ev.push_scope(f"replica{i}")
                try:
                    stats.append(e.step())
                finally:
                    _ev.pop_scope()
            else:
                stats.append(e.step())
        for phase, units, times in (
            (PREFILL,
             np.array([s.prefill_tokens for s in stats], dtype=np.int64),
             np.array([s.prefill_seconds for s in stats])),
            (DECODE,
             np.array([s.decode_tokens for s in stats], dtype=np.int64),
             np.array([s.decode_seconds for s in stats])),
        ):
            acc_u, acc_t = self._acc[phase]
            if _ev.TRACER is not None:
                # the windowed accumulators are the dispatcher's shared
                # mutable state: a failure monitor calling set_active()
                # concurrently with step() would race this read-modify-write
                _ev.emit_read(self, f"acc[{phase}]",
                              where="InflightDispatcher.step")
                _ev.emit_write(self, f"acc[{phase}]",
                               where="InflightDispatcher.step")
            acc_u += units
            acc_t += times
            if (np.count_nonzero(acc_u) >= 2
                    or (len(self.engines) == 1 and acc_u.any())):
                self.last_stats[phase] = self._balancers[phase].report(
                    Plan(counts=acc_u.copy(), key=phase), acc_t.copy())
                acc_u[:] = 0
                acc_t[:] = 0.0
        return stats

    def run_until_idle(self, max_steps: Optional[int] = None
                       ) -> List[List[IterationStats]]:
        out = []
        while self.has_work:
            if max_steps is not None and len(out) >= max_steps:
                break
            out.append(self.step())
        return out

    def poll_finished(self) -> List[Request]:
        done: List[Request] = []
        for e in self.engines:
            done.extend(e.poll_finished())
        done.sort(key=lambda r: (r.finish_time, r.arrival_time))
        return done
