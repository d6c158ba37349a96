# lint: virtual-clock-module
"""Cluster model: named heterogeneous nodes under one virtual clock.

A :class:`Node` is one machine of the fleet — a
:class:`~repro_torch.topology.MachineTopology` (multi-socket, flat, or a
throttled box) running one
:class:`~repro_torch.serving.ContinuousBatchingEngine` replica per socket,
each clocked by a :class:`~repro_torch.serving.HybridPhaseCost` over that
socket's simulated cores, and routed internally by an
:class:`~repro_torch.serving.InflightDispatcher`.  A node is therefore itself
a two-level balancing domain (socket -> core); the
:class:`~repro_torch.fleet.router.FleetRouter` adds the third level on top.

The :class:`Cluster` clock is the slowest node's engine clock — nodes
run concurrently, so fleet time is ``max`` over node times, exactly the
dispatcher-over-replicas convention one level down.  All time is virtual
(deterministic), so fleet runs are exactly reproducible.  Every engine of
every node runs its model on the cluster's ``device`` (the card unless the
caller asks for the CPU); the nodes share one copy of the weights and each
engine keeps its own slot caches there.  Failures and capacity events
(:meth:`Node.fail`, :meth:`Node.replan_capacity`) act on the host between
engine steps, never inside one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core import events as _ev
from repro_torch.serving import (
    ContinuousBatchingEngine,
    HybridPhaseCost,
    InflightDispatcher,
    Request,
)
from repro_torch.serving.scheduler import IterationStats
from repro_torch.topology import MachineTopology, make_topology

__all__ = ["NodeSpec", "Node", "Cluster"]

_FOREVER = (0.0, 1e18)


@dataclass(frozen=True)
class NodeSpec:
    """Declarative description of one fleet node.

    ``topology`` is a topology/machine name (``"dual-125h"``,
    ``"2s-12900k"``, ``"ultra-125h"``, ...) or a ready
    :class:`MachineTopology`.  ``throttle > 1`` applies a permanent
    background slowdown to every core — the "throttled box" whose
    *nominal* capacity (what static partitioning sees) stays high while
    its real throughput is ``1/throttle`` of it.
    """

    name: str
    topology: Union[str, MachineTopology]
    max_slots: int = 4
    prefill_chunk: Optional[int] = 8
    prefill_lanes: int = 1
    throttle: float = 1.0

    def __post_init__(self) -> None:
        if self.throttle < 1.0:
            raise ValueError("throttle must be >= 1 (1 = unthrottled)")


class Node:
    """One cluster node: per-socket engine replicas behind an in-node
    dispatcher, plus the liveness switch the fleet's failure events flip."""

    def __init__(self, spec: NodeSpec, cfg, params, *, max_seq: int,
                 seed: int = 0, alpha: float = 0.3, device="cuda"):
        self.spec = spec
        self.name = spec.name
        topo = (make_topology(spec.topology, seed=seed)
                if isinstance(spec.topology, str) else spec.topology)
        self.topology = topo
        if spec.throttle > 1.0:
            # the throttle is background load on the *simulated machines*:
            # both kernel timing and the virtual clock see it, nominal
            # bandwidth numbers do not
            for m in topo.machines:
                for core in range(m.n_cores):
                    m.background.append((*_FOREVER, core, spec.throttle))
        self.engines = [
            ContinuousBatchingEngine(
                cfg, params, max_slots=spec.max_slots, max_seq=max_seq,
                prefill_chunk=spec.prefill_chunk,
                prefill_lanes=spec.prefill_lanes,
                cost_model=HybridPhaseCost(machine), device=device)
            for machine in topo.machines
        ]
        self.dispatcher = InflightDispatcher(self.engines, alpha=alpha)
        self.active = True

    # ------------------------------------------------------------- probes --
    @property
    def now(self) -> float:
        return max(e.now for e in self.engines)

    @property
    def has_work(self) -> bool:
        return self.dispatcher.has_work

    @property
    def pending_prefill_tokens(self) -> int:
        return self.dispatcher.pending_prefill_tokens

    @property
    def queue_depth(self) -> int:
        return self.dispatcher.queue_depth

    def remaining_decode_tokens(self, cap: Optional[int] = None) -> int:
        """Decode tokens still owed to requests the node already owns
        (waiting + prefilling + running), optionally capping each
        request's remainder at ``cap``.  Degraded requests (clamped
        ``max_new_tokens``) owe less — the admission controller's
        deadline estimates read actual backlog instead of assuming every
        in-flight request contends forever."""
        total = 0
        for e in self.engines:
            for r in e.outstanding():
                rem = max(0, r.max_new_tokens - r.n_generated)
                total += min(rem, cap) if cap is not None else rem
        return total

    @property
    def nominal_capacity(self) -> float:
        """Aggregate streaming bandwidth on paper — what a static
        capacity-share partition weights by.  Deliberately blind to
        ``throttle``: nominal numbers don't know about background load
        (that asymmetry is the fleet study's point).  Capacity events are
        different: core parking is *observable* (the OS publishes it), so
        parked cores' bandwidth is subtracted — this is the number
        :meth:`replan_capacity` re-plans when an event fires mid-serve."""
        return self.topology.active_bandwidth(self.now)

    # ------------------------------------------------------------ serving --
    def submit(self, request: Request) -> tuple:
        if not self.active:
            raise ValueError(f"node {self.name!r} is failed")
        return self.dispatcher.submit(request)

    def step(self) -> List[IterationStats]:
        if not self.active:
            return []
        if _ev.TRACER is not None:
            # node scope: one trace process per node (replicas nest inside)
            _ev.push_scope(f"node:{self.name}")
            try:
                return self.dispatcher.step()
            finally:
                _ev.pop_scope()
        return self.dispatcher.step()

    def poll_finished(self) -> List[Request]:
        return self.dispatcher.poll_finished()

    # ------------------------------------------------------------ failure --
    def fail(self) -> List[Request]:
        """Drain the node: still-WAITING requests are extracted (they never
        executed — the retry-able half, returned for resubmission
        elsewhere), admitted requests are aborted (their cache state dies
        with the node).  The node stops stepping and reporting."""
        self.active = False
        requeued: List[Request] = []
        for e in self.engines:
            requeued.extend(e.steal_waiting())
            for r in e.outstanding():   # lanes + decode batch
                e.abort(r)
        requeued.sort(key=lambda r: r.arrival_time)
        return requeued

    def recover(self) -> None:
        self.active = True

    # ----------------------------------------------------------- capacity --
    def replan_capacity(self, now: Optional[float] = None) -> None:
        """Re-plan the node after a capacity event: sample each socket's
        active mask and adjust what the serving stack asks of it.

        * **Partially parked socket** — shrink that engine's soft
          ``slot_budget`` proportionally (floored at 1): fewer concurrent
          requests are admitted while the remaining cores absorb the
          in-flight ones.  No state is evicted, nothing retraces.
        * **Fully parked socket** — deactivate its replica in the
          dispatcher (``set_active``): *admitted* work freezes in place
          and resumes on unpark (deliberately unlike :meth:`fail`, which
          aborts — parked state survives), while still-waiting requests
          are stolen back and resubmitted through routing so live sockets
          pick them up.  If every socket is parked they wait in the
          dispatcher's ``pending`` queue.
        * **Returned socket** — restore the budget and reactivate (which
          also flushes any pending queue).

        ``now`` defaults to the node clock; capacity events applied with
        the from-now-on ``[0, inf)`` idiom are visible on every timeline
        regardless of clock skew.
        """
        t = self.now if now is None else now
        for s, (machine, engine) in enumerate(
                zip(self.topology.machines, self.engines)):
            mask = machine.active_mask(t)
            if not mask.any():
                if self.dispatcher.active[s]:
                    requeued = engine.steal_waiting()
                    self.dispatcher.set_active(s, False)
                    for r in requeued:
                        self.dispatcher.submit(r)
                continue
            frac = float(mask.mean())
            engine.set_slot_budget(int(round(engine.max_slots * frac)))
            if not self.dispatcher.active[s]:
                self.dispatcher.set_active(s, True)


class Cluster:
    """Named nodes under one fleet clock."""

    def __init__(self, nodes: Sequence[Node]):
        if not nodes:
            raise ValueError("need at least one node")
        names = [n.name for n in nodes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate node names: {names}")
        self.nodes = list(nodes)
        self.by_name: Dict[str, Node] = {n.name: n for n in self.nodes}

    @classmethod
    def build(cls, specs: Sequence[NodeSpec], cfg, params, *, max_seq: int,
              seed: int = 0, alpha: float = 0.3,
              device="cuda") -> "Cluster":
        """One shared model (cfg, params) across all nodes, on ``device``.
        Node ``i`` seeds its topology ``seed + i`` (distinct jitter
        streams)."""
        return cls([Node(spec, cfg, params, max_seq=max_seq, seed=seed + i,
                         alpha=alpha, device=device)
                    for i, spec in enumerate(specs)])

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    @property
    def now(self) -> float:
        """Fleet clock: slowest node (nodes run concurrently)."""
        return max(n.now for n in self.nodes)

    @property
    def has_work(self) -> bool:
        return any(n.active and n.has_work for n in self.nodes)

    def nominal_shares(self) -> np.ndarray:
        caps = np.array([n.nominal_capacity for n in self.nodes],
                        dtype=np.float64)
        return caps / caps.sum()
