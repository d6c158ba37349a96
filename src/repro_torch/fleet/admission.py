# lint: virtual-clock-module
"""SLO-aware admission control at the fleet front door.

Routing alone cannot save an overloaded fleet: once every node's queue
is deep, spreading work merely spreads the lateness.  The
:class:`AdmissionController` sits in front of
:class:`~repro_torch.fleet.router.FleetRouter.submit` and keeps the *admitted*
work finishable:

* **Queue-depth cap** (``queue_cap``) — shed arrivals outright when the
  fleet-wide queue depth (running + prefilling + waiting across active
  nodes) is already at the cap.  Classic load shedding: a request that
  would only wait is cheaper to reject at arrival than to time out
  after holding a slot.
* **Deadline shedding** — a request carrying ``deadline`` is shed when
  the controller's completion estimate (from the router's learned
  per-node tokens/s EWMAs) lands past it.  No estimate yet -> admit
  (cold start must not shed).
* **Graceful degradation** (``degrade_depth``) — between "fine" and
  "shed" there is "shorter": past this depth, ``max_new_tokens`` is
  scaled by ``degrade_factor`` (floor ``min_new_tokens``) and the
  request is marked ``degraded`` so
  :class:`~repro_torch.serving.LatencyReport` accounts for it.

Shed requests are finished on the spot (``FinishReason.SHED``, zero
engine work) and land in the router's ``finished`` list, so goodput
reports see exactly what was sacrificed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core import events as _ev
from repro_torch.serving import DECODE, PREFILL, FinishReason, Request, RequestState

__all__ = ["AdmissionController"]


@dataclass
class AdmissionController:
    """Front-door policy: shed, degrade, or admit.  All thresholds are
    optional — the default-constructed controller admits everything."""

    queue_cap: Optional[int] = None       # fleet queue depth hard cap
    degrade_depth: Optional[int] = None   # start shrinking max_new_tokens
    degrade_factor: float = 0.5
    min_new_tokens: int = 1
    slack: float = 1.0                    # estimate multiplier for deadlines

    def __post_init__(self) -> None:
        if self.queue_cap is not None and self.queue_cap < 1:
            raise ValueError("queue_cap must be >= 1")
        if self.degrade_depth is not None and self.degrade_depth < 0:
            raise ValueError("degrade_depth must be >= 0")
        if not 0 < self.degrade_factor <= 1:
            raise ValueError("degrade_factor must be in (0, 1]")
        if self.min_new_tokens < 1:
            raise ValueError("min_new_tokens must be >= 1")
        self.n_shed = 0
        self.n_degraded = 0

    # ----------------------------------------------------------------- API --
    def consider(self, request: Request, router) -> bool:
        """Mutate-and-verdict: True to route ``request``, False when it was
        shed (already finished with ``FinishReason.SHED``)."""
        depth = self._fleet_depth(router)
        if self.queue_cap is not None and depth >= self.queue_cap:
            self._shed(request, router.now)
            self._note(router, "shed", depth, reason="queue_cap")
            return False
        if request.deadline is not None:
            est = self.estimate_finish(request, router)
            if est is not None and est > request.deadline:
                self._shed(request, router.now)
                self._note(router, "shed", depth, reason="deadline",
                           estimate=round(float(est), 6),
                           deadline=float(request.deadline))
                return False
        if (self.degrade_depth is not None and depth >= self.degrade_depth
                and request.max_new_tokens > self.min_new_tokens):
            request.max_new_tokens = max(
                self.min_new_tokens,
                int(request.max_new_tokens * self.degrade_factor))
            request.degraded = True
            self.n_degraded += 1
            self._note(router, "degrade", depth,
                       max_new_tokens=int(request.max_new_tokens))
        return True

    def estimate_finish(self, request: Request, router) -> Optional[float]:
        """Completion-time estimate against the *best* node's learned
        throughput: queued prefill work plus the new prompt at the node's
        prefill rate, then decode at its per-slot share of the decode
        rate.  ``None`` before the first feedback window (no basis)."""
        pf = router.node_tps(PREFILL)
        dec = router.node_tps(DECODE)
        best: Optional[float] = None
        for i, node in enumerate(router.cluster.nodes):
            if not node.active:
                continue
            if not (np.isfinite(pf[i]) and np.isfinite(dec[i])):
                continue
            ttft = (node.pending_prefill_tokens
                    + request.prompt_len) / max(pf[i], 1e-9)
            # Decode throughput is shared with everything already in the
            # node, but only while those requests still owe tokens: an
            # in-flight request contends for min(its remaining tokens,
            # this request's lifetime).  Degraded admissions (clamped
            # max_new_tokens) therefore shrink the estimate — backlog
            # equals queue_depth * max_new_tokens (the old flat-depth
            # model) only when every in-flight request outlives this one.
            probe = getattr(node, "remaining_decode_tokens", None)
            if callable(probe):
                backlog = probe(cap=request.max_new_tokens)
            else:
                backlog = node.queue_depth * request.max_new_tokens
            est = ttft + (request.max_new_tokens
                          + backlog) / max(dec[i], 1e-9)
            if best is None or est < best:
                best = est
        if best is None:
            return None
        return router.now + self.slack * best

    # ------------------------------------------------------------- helpers --
    @staticmethod
    def _fleet_depth(router) -> int:
        return sum(node.queue_depth for node in router.cluster.nodes
                   if node.active)

    @staticmethod
    def _note(router, decision: str, depth: int, **payload) -> None:
        """Telemetry for a non-default verdict: a trace instant plus a
        flight-recorder record (both no-ops when nothing is installed)."""
        _ev.emit_instant("fleet", f"admission:{decision}", router.now,
                         args=lambda: {"decision": decision,
                                       "depth": int(depth), **payload})
        if _ev.RECORDER is not None:
            _ev.record("admission", decision, t=router.now,
                       depth=int(depth), **payload)

    def _shed(self, request: Request, now: float) -> None:
        request.state = RequestState.FINISHED
        request.finish_reason = FinishReason.SHED
        request.finish_time = now
        self.n_shed += 1
