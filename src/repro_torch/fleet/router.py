# lint: virtual-clock-module
"""Fleet-level request routing: the paper's loop, third level.

:class:`FleetRouter` closes the measure -> normalize -> EMA -> split
loop over *nodes*: per-phase (tokens, seconds) windows aggregated from
every node's iteration stats feed a node-level
:class:`~repro_torch.runtime.RatioTable` via ``units=``, and each arriving
request is routed to the node with the least ratio-normalized backlog,
discounted by that node's TTFT/TPOT headroom against the SLOs.

The balancer is *recursive*: its policy is a
:class:`~repro_torch.runtime.RecursivePolicy` whose children are the nodes'
own :class:`~repro_torch.serving.InflightDispatcher` balancing domains, so
every fleet-level report carries the per-node per-phase
:class:`~repro_torch.runtime.RegionStats` underneath it
(``RegionStats.children``) — one telemetry tree spanning
cluster -> machine -> socket (and, inside each engine's cost model,
-> core).

Round-robin and static-capacity baselines run on the *same* code path
(same stepping, same feedback accounting, same failure handling); only
the argmin differs — so a goodput comparison isolates the routing
decision itself.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import events as _ev
from repro_torch.runtime import Balancer, Plan, RatioTable, RecursivePolicy, StatsSink
from repro_torch.serving import DECODE, PREFILL, Request

from .cluster import Cluster
from .events import NodeEvent

__all__ = ["FleetRouter", "run_fleet"]

PHASES = (PREFILL, DECODE)
EPS = 1e-9


class FleetRouter:
    """Route requests across cluster nodes by learned per-phase throughput
    ratios, backlog, and SLO headroom.

    ``policy`` selects the routing rule:

    * ``"learned"`` — ratio-normalized backlog (Eq. 3 over the node
      table) scaled by per-phase SLO headroom;
    * ``"round_robin"`` — cycle over active nodes;
    * ``"static"`` — weighted round-robin proportional to fixed shares
      (``static_shares``, default the nodes' *nominal* capacities).

    All policies skip failed nodes and share the feedback plumbing, so
    the learned table keeps converging even under a baseline policy (it
    is simply ignored by the argmin).
    """

    POLICIES = ("learned", "round_robin", "static")

    def __init__(self, cluster: Cluster, *, policy: str = "learned",
                 table: Optional[RatioTable] = None, alpha: float = 0.3,
                 static_shares: Optional[Sequence[float]] = None,
                 slo_ttft: Optional[float] = None,
                 slo_tpot: Optional[float] = None,
                 admission=None, sink: Optional[StatsSink] = None):
        if policy not in self.POLICIES:
            raise ValueError(f"policy must be one of {self.POLICIES}")
        self.cluster = cluster
        self.policy = policy
        n = cluster.n_nodes
        self.table = table or RatioTable(n, alpha=alpha)
        if self.table.n_workers != n:
            raise ValueError("table size does not match node count")
        self.slo_ttft = slo_ttft
        self.slo_tpot = slo_tpot
        self.admission = admission
        # the recursive balancer: each phase's policy plans/reports over
        # the node table while snapshotting every node dispatcher's own
        # latest per-phase RegionStats as children
        self._balancers = {
            phase: Balancer(
                RecursivePolicy(
                    self.table, key=phase, feedback="units",
                    children=[
                        (lambda d=node.dispatcher, p=phase:
                         d.last_stats.get(p))
                        for node in cluster.nodes
                    ]),
                sink=sink, keep_stats=False)
            for phase in PHASES
        }
        self.last_stats: Dict[str, object] = {}
        # windowed per-phase (units, seconds) over nodes — same >=2-nodes
        # rule as the replica dispatcher one level down
        self._acc = {phase: (np.zeros(n, dtype=np.int64), np.zeros(n))
                     for phase in PHASES}
        # tokens/s EWMA per node per phase (admission's wait estimator)
        self._tps = {phase: np.full(n, np.nan) for phase in PHASES}
        self._tps_alpha = alpha
        # per-node latency EWMAs (headroom feedback)
        self._ttft_ewma = np.full(n, np.nan)
        self._tpot_ewma = np.full(n, np.nan)
        self._lat_alpha = alpha
        if static_shares is None:
            shares = cluster.nominal_shares()
        else:
            shares = np.asarray(static_shares, dtype=np.float64)
            if shares.shape != (n,) or (shares <= 0).any():
                raise ValueError("static_shares must be n positive weights")
            shares = shares / shares.sum()
        self.static_shares = shares
        self.routed = np.zeros(n, dtype=np.int64)
        self._rr = 0
        self.finished: List[Request] = []
        self.n_requeued = 0
        # requests that arrived while *every* node was failed — held at
        # the router (not crashed on) and flushed on the first recovery
        self._parked: List[Request] = []
        self.n_parked = 0

    # ------------------------------------------------------------- probes --
    @property
    def now(self) -> float:
        return self.cluster.now

    @property
    def has_work(self) -> bool:
        return self.cluster.has_work

    def node_tps(self, phase: str) -> np.ndarray:
        """Per-node observed tokens/s EWMA for ``phase`` (NaN before the
        first window lands)."""
        return self._tps[phase].copy()

    def headroom(self, i: int, phase: str) -> float:
        """SLO headroom of node ``i`` in ``phase``: 1 with full margin,
        shrinking toward the floor as the node's latency EWMA approaches
        (or passes) the SLO.  1.0 when no SLO is set or nothing finished
        on the node yet."""
        slo, ewma = ((self.slo_ttft, self._ttft_ewma) if phase == PREFILL
                     else (self.slo_tpot, self._tpot_ewma))
        if slo is None or not np.isfinite(ewma[i]):
            return 1.0
        return float(np.clip(1.0 - ewma[i] / slo, 0.05, 1.0))

    # ------------------------------------------------------------ routing --
    def route(self, request: Request) -> int:
        active = [i for i, node in enumerate(self.cluster.nodes)
                  if node.active]
        if not active:
            raise ValueError("no active node to route to")
        if self.policy == "round_robin":
            for _ in range(self.cluster.n_nodes):
                i = self._rr % self.cluster.n_nodes
                self._rr += 1
                if self.cluster.nodes[i].active:
                    return i
        if self.policy == "static":
            # deterministic weighted round-robin: the active node furthest
            # behind its share
            lag = [(self.routed[i] + 1) / self.static_shares[i]
                   for i in active]
            return active[int(np.argmin(lag))]
        # learned: ratio-normalized backlog / headroom, per phase (Eq. 3
        # with the node table's learned per-phase speeds)
        pf = np.maximum(self.table.ratios(PREFILL), EPS)
        dec = np.maximum(self.table.ratios(DECODE), EPS)
        scores = []
        for i in active:
            node = self.cluster.nodes[i]
            prefill_backlog = ((node.pending_prefill_tokens
                                + request.prompt_len) / pf[i])
            decode_backlog = ((node.queue_depth + 1)
                              * request.max_new_tokens / dec[i])
            scores.append(
                prefill_backlog / self.headroom(i, PREFILL)
                + decode_backlog / self.headroom(i, DECODE))
        return active[int(np.argmin(scores))]

    def submit(self, request: Request) -> Optional[int]:
        """Admission-check (when configured) then route and enqueue.
        Returns the node index, or None when the request was shed — or
        deferred: a request arriving during a fleet-wide failure window
        (every node down) parks at the router and is resubmitted through
        the full admission + routing path by the first recovery event,
        instead of aborting the run (``route`` keeps its raise for direct
        callers)."""
        if self.admission is not None:
            if not self.admission.consider(request, self):
                self.finished.append(request)
                return None
        if not any(node.active for node in self.cluster.nodes):
            self._parked.append(request)
            self.n_parked += 1
            if _ev.RECORDER is not None:
                _ev.record("admission", "parked", t=self.now,
                           decision="parked",
                           arrival=float(request.arrival_time))
            return None
        i = self.route(request)
        node = self.cluster.nodes[i]
        node.submit(request)
        self.routed[i] += 1
        _ev.emit_instant(
            "fleet", f"route:{node.name}", self.now,
            args=lambda: {"rid": int(request.request_id),
                          "node": node.name, "policy": self.policy,
                          "prompt_len": int(request.prompt_len)})
        if _ev.RECORDER is not None:
            _ev.record("route", node.name, t=self.now,
                       rid=int(request.request_id), policy=self.policy,
                       queue_depth=int(node.queue_depth))
        return i

    # ------------------------------------------------------------ driving --
    def step(self) -> None:
        """One iteration on every active node + fleet-level feedback."""
        cluster = self.cluster
        n = cluster.n_nodes
        units = {phase: np.zeros(n, dtype=np.int64) for phase in PHASES}
        times = {phase: np.zeros(n) for phase in PHASES}
        for i, node in enumerate(cluster.nodes):
            stats = node.step()
            if not stats:
                continue
            # node throughput = aggregate tokens over the slowest
            # replica's wall time (replicas run concurrently)
            units[PREFILL][i] = sum(s.prefill_tokens for s in stats)
            times[PREFILL][i] = max(s.prefill_seconds for s in stats)
            units[DECODE][i] = sum(s.decode_tokens for s in stats)
            times[DECODE][i] = max(s.decode_seconds for s in stats)
        for phase in PHASES:
            acc_u, acc_t = self._acc[phase]
            acc_u += units[phase]
            acc_t += times[phase]
            if (np.count_nonzero(acc_u) >= 2
                    or (n == 1 and acc_u.any())):
                self.last_stats[phase] = self._balancers[phase].report(
                    Plan(counts=acc_u.copy(), key=phase), acc_t.copy())
                self._update_tps(phase, acc_u, acc_t)
                acc_u[:] = 0
                acc_t[:] = 0.0
                _ev.emit_counter(
                    f"ratio:fleet:{phase}", self.now,
                    lambda phase=phase: {
                        f"n{i}": round(float(r), 5)
                        for i, r in enumerate(self.table.ratios(phase))})
        for i, node in enumerate(cluster.nodes):
            for r in node.poll_finished():
                self._observe_latency(i, r)
                self.finished.append(r)

    def _update_tps(self, phase: str, units: np.ndarray,
                    seconds: np.ndarray) -> None:
        tps = self._tps[phase]
        a = self._tps_alpha
        for i in range(len(tps)):
            if units[i] <= 0 or seconds[i] <= 0:
                continue  # absence of measurement, not a measurement
            sample = units[i] / seconds[i]
            tps[i] = sample if not np.isfinite(tps[i]) else (
                (1 - a) * tps[i] + a * sample)

    def _observe_latency(self, i: int, r: Request) -> None:
        if _ev.RECORDER is not None and (r.ttft is not None
                                         or r.tpot is not None):
            _ev.record("latency", self.cluster.nodes[i].name, t=self.now,
                       rid=int(r.request_id),
                       ttft=(None if r.ttft is None else float(r.ttft)),
                       tpot=(None if r.tpot is None else float(r.tpot)))
        a = self._lat_alpha
        if r.ttft is not None:
            e = self._ttft_ewma
            e[i] = r.ttft if not np.isfinite(e[i]) else (
                (1 - a) * e[i] + a * r.ttft)
        if r.tpot is not None:
            e = self._tpot_ewma
            e[i] = r.tpot if not np.isfinite(e[i]) else (
                (1 - a) * e[i] + a * r.tpot)

    # ------------------------------------------------------------- events --
    def apply_event(self, event: NodeEvent) -> None:
        node = self.cluster.by_name[event.node]
        i = self.cluster.nodes.index(node)
        _ev.emit_instant("fleet", f"{event.kind}:{event.node}", self.now,
                         args=lambda: {"node": event.node,
                                       "kind": event.kind})
        if _ev.RECORDER is not None:
            _ev.record("node_event", event.node, t=self.now,
                       event=event.kind)
        if event.kind == "fail":
            requeued = node.fail()
            # mask the dead node out of the feedback window: its partial
            # (units, seconds) sums are stale measurements that would
            # EMA-drag its ratio on the next report (the fleet-level twin
            # of InflightDispatcher.set_active)
            for acc_u, acc_t in self._acc.values():
                acc_u[i] = 0
                acc_t[i] = 0.0
            # collect the aborted ones now so their latency never pollutes
            # the headroom EWMAs of a node that is gone
            self.finished.extend(node.poll_finished())
            self.n_requeued += len(requeued)
            for r in requeued:  # reroute the never-executed queue
                self.submit(r)
        else:
            node.recover()
            if self._parked:
                # first node back: flush requests parked during the
                # fleet-wide outage, in arrival order, through the full
                # admission + routing path
                parked, self._parked = self._parked, []
                for r in parked:
                    self.submit(r)

    def run(self, requests: Sequence[Request],
            events: Sequence[NodeEvent] = ()) -> List[Request]:
        """Open-loop replay of ``requests`` interleaved with ``events`` on
        the fleet timeline; drives the cluster to completion and returns
        every finished request (including shed / aborted)."""
        return run_fleet(self, requests, events)


def run_fleet(router: FleetRouter, requests: Sequence[Request],
              events: Sequence[NodeEvent] = ()) -> List[Request]:
    """Drive a fleet run: progress in-flight work up to each arrival or
    event (so feedback from earlier requests steers later routing — the
    open-loop replay idiom), apply it, then drain."""
    timeline = sorted(
        [(r.arrival_time, 0, r) for r in requests]
        + [(e.time, 1, e) for e in events],
        key=lambda item: (item[0], item[1]))
    for t, kind, item in timeline:
        while router.has_work and router.now < t:
            router.step()
        if kind == 0:
            router.submit(item)
        else:
            router.apply_event(item)
    while router.has_work:
        router.step()
    for i, node in enumerate(router.cluster.nodes):
        for r in node.poll_finished():
            router._observe_latency(i, r)
            router.finished.append(r)
    return router.finished
