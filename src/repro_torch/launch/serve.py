"""Serve entry point of the port: request-level continuous batching with
open-loop (seeded Poisson) traffic, phase-aware ratio learning, and dynamic
replica routing — on the card by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
      --preset full --balanced-trunk --trunk-quant q4 --replicas 1

Requests arrive open-loop and are routed to replicas by measured
per-phase throughput; each replica interleaves chunked prefill with its
running decode batch.  ``--machine`` drives a deterministic virtual clock
from the paper's hybrid-CPU model (``--machine wall``: real wall time; a
balanced trunk or head then dispatches over 4 OS threads whose shard
times are measured, and the trunk runs eager: a compiled trunk replays
its cost tape through virtual pools, which a wall clock does not have).
``--balanced-trunk`` runs every trunk projection and the LM head as one
kernel launch each (compiled balanced decode) — the Q4 CUDA kernel, or
with ``--trunk-quant int8`` the u8 x s8 CUDA kernel, or with
``--trunk-quant fp32`` one ``torch.matmul`` — with per-phase x
per-layer-kind ratio tables fed from the step's cost tape.

``--balanced-head`` runs only the LM head as balanced per-core Q4 shards
(one direct-kernel launch per core, outside the decode step);
``--prefill-lanes N`` prefills up to N admitted prompts per iteration in
one batched trunk call; ``--legacy-batch`` runs one round of the seed-era
whole-batch ``RoutedServer.serve_batch``.  On the card the decode step of
a compiled trunk (or of the dense model) runs as one captured CUDA graph.

``--topology`` serves on a NUMA topology of the machine model: the
balanced trunk dispatches socket-local (a socket-level ratio split over
per-socket core splits, NUMA-placed weights) and the virtual clock runs
on the flattened machine; it implies ``--balanced-trunk``.  ``--fleet``
serves a default heterogeneous fleet (NUMA flagship + NUMA desktop + flat
box + throttled box, one engine per socket) behind the recursive
:class:`~repro_torch.fleet.FleetRouter`, under diurnal heavy-tailed
traffic with a mid-run failure window; ``--fleet-policy`` picks learned,
round-robin or static routing and ``--fleet-admission`` adds the SLO-aware
front door.  ``--trace``, ``--metrics`` and ``--flight-recorder`` write a
Perfetto trace, the run's metrics and the decision ring of the virtual
clock.

``--arch`` takes every architecture of the zoo (granite-8b, the default,
as in the reference), the recurrent ones (jamba's mamba layers, xlstm's
mLSTM and sLSTM blocks) included; the embed-input ones (musicgen-medium)
have no token traffic and are refused.  ``--device cpu`` runs the
same path with the kernels' plain torch version.  Every eager shard
takes its launch variant from one kernel tuner that all replicas share;
``--tuner-cache PATH`` warm-starts it from PATH and saves it there after
the run.  The compiled trunk consults no tuner, so a default
``--balanced-trunk`` run saves an empty table.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core import events as _ev
from repro_torch.core.hybrid_sim import MACHINES
from repro_torch.core.tuner import KernelTuner, TunerStore
from repro_torch.device import resolve_device
from repro_torch.kernels import (
    GEMV_ISA,
    TRUNK_KINDS,
    HybridKernelDispatcher,
    kernel_key,
)
from repro_torch.models import BalancedTrunk, balanced_lm_head, init_params
from repro_torch.runtime import RatioStore, RatioTable
from repro_torch.serving import (
    DECODE,
    PREFILL,
    ContinuousBatchingEngine,
    HybridPhaseCost,
    InflightDispatcher,
    LatencyReport,
    Request,
    RoutedServer,
    ServeEngine,
    poisson_requests,
)
from repro_torch.topology import TOPOLOGIES, TopologyDispatcher

# threads of a balanced dispatcher on the wall clock (the reference's)
WALL_WORKERS = 4
# the fleet's SLOs (the reference's), also those the flight recorder burns on
FLEET_SLO_TTFT, FLEET_SLO_TPOT = 2.0, 0.25


def replica_slot_counts(batch: int, replicas: int) -> list:
    """Split a total concurrent-request budget across replicas: ``per``
    slots each plus the remainder spread over the first replicas (every
    replica gets at least one slot)."""
    if replicas < 1:
        raise ValueError("need at least one replica")
    base, rem = divmod(batch, replicas)
    return [max(1, base + (1 if i < rem else 0)) for i in range(replicas)]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--preset", choices=["tiny", "full"], default="tiny")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the model runs (cpu: the kernels' plain "
                         "torch version)")
    ap.add_argument("--batch", type=int, default=4,
                    help="total concurrent-request slots across replicas")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=32,
                    help="max new tokens per request")
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=50.0,
                    help="open-loop Poisson arrival rate, req/s (0: all at t=0)")
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="prompt tokens prefilled per iteration (0: one-shot)")
    ap.add_argument("--prefill-lanes", type=int, default=1,
                    help="admitted prompts prefilled together, one batched "
                         "trunk call per iteration")
    ap.add_argument("--machine", default=None,
                    choices=sorted(MACHINES) + ["wall"],
                    help="virtual hybrid-CPU clock (default ultra-125h), "
                         "or 'wall' for real time")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ratios", default=None,
                    help="JSON path to warm-start/persist replica ratios")
    ap.add_argument("--balanced-trunk", action="store_true",
                    help="run EVERY trunk projection (q/k/v/o, MLP "
                         "up/gate/down, head) as one kernel launch with "
                         "per-core splits replayed into per-phase x "
                         "per-layer-kind ratio tables")
    ap.add_argument("--trunk-quant", choices=["q4", "int8", "fp32"],
                    default="q4",
                    help="balanced-trunk weight path: Q4_0 CUDA GEMV, "
                         "dynamic-u8 x s8 CUDA GEMM, or fp32 torch.matmul")
    ap.add_argument("--legacy-batch", action="store_true",
                    help="run the seed-era whole-batch serve_batch path")
    ap.add_argument("--topology", default=None,
                    choices=sorted(TOPOLOGIES) + sorted(MACHINES),
                    help="serve on a NUMA topology: the balanced trunk "
                         "dispatches socket-local (two-level ratio split, "
                         "NUMA-placed weights) and the virtual clock runs "
                         "on the flattened machine; implies "
                         "--balanced-trunk (flat machine names are the "
                         "1-socket special case)")
    ap.add_argument("--fleet", action="store_true",
                    help="serve on the default heterogeneous 4-node fleet "
                         "through the recursive FleetRouter (diurnal "
                         "traffic + mid-run failure window)")
    ap.add_argument("--fleet-policy", default="learned",
                    choices=["learned", "round_robin", "static"],
                    help="fleet routing policy (with --fleet)")
    ap.add_argument("--fleet-admission", action="store_true",
                    help="enable SLO-aware admission control (queue cap, "
                         "graceful degradation) in front of the fleet")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace_event JSON of the "
                         "run: spans on the virtual clock at every "
                         "balancing level plus ratio / bandwidth / "
                         "capacity counter tracks")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="write run metrics (TTFT/TPOT histograms, "
                         "goodput): Prometheus text exposition, or a JSON "
                         "dump when PATH ends in .json")
    ap.add_argument("--flight-recorder", default=None, metavar="PATH",
                    help="record balancer decisions (ratio reports, offset "
                         "refreshes, capacity/admission events) in a "
                         "bounded ring dumped to PATH; auto-dumps on SLO "
                         "burn or contract trip")
    ap.add_argument("--balanced-head", action="store_true",
                    help="run the LM head as balanced per-core Q4 kernel "
                         "shards (hybrid kernel dispatch) instead of inside "
                         "the decode step")
    ap.add_argument("--tuner-cache", default=None,
                    help="JSON path to warm-start/persist the kernel "
                         "tuner's launch-variant tables (shared across "
                         "replicas, like --ratios for ratio tables)")
    return ap


def check_flags(args) -> None:
    """Apply the reference's flag rules (``--topology`` implies
    ``--balanced-trunk`` and excludes ``--machine`` and ``--balanced-head``;
    ``--fleet`` is a standalone mode), raising SystemExit where they
    refuse."""
    if args.topology:
        if args.balanced_head:
            raise SystemExit("--topology dispatches the whole trunk; "
                             "drop --balanced-head")
        if args.machine is not None:
            raise SystemExit(
                "--topology provides the virtual clock (the topology's "
                "flattened machine); drop --machine")
        args.balanced_trunk = True
    if args.balanced_head and args.balanced_trunk:
        raise SystemExit("--balanced-trunk already includes the head; "
                         "drop --balanced-head")
    if args.fleet and (args.legacy_batch or args.balanced_head
                       or args.balanced_trunk or args.topology):
        raise SystemExit("--fleet is a standalone mode: the fleet owns "
                         "its topologies and cost models")


@dataclass
class ServeRun:
    """What one serving run produced (the printout reads it)."""

    cfg: object
    device: torch.device
    engines: List[ContinuousBatchingEngine]
    dispatchers: list     # HybridKernelDispatcher or TopologyDispatcher
    inflight: InflightDispatcher
    requests: List[Request]
    routed: np.ndarray
    slot_counts: list
    clock: str
    report: LatencyReport
    iterations: list      # IterationStats of every engine step, in order
    tuner: KernelTuner    # shared by every replica's dispatcher
    tuner_warm: bool      # loaded from --tuner-cache


def build_engines(args, cfg, params, device, *,
                  double_buffer: bool = True, cuda_graph: bool = True,
                  tuner: Optional[KernelTuner] = None) -> tuple:
    """One continuous-batching engine (and, with ``--balanced-trunk`` or
    ``--balanced-head``, one kernel dispatcher) per replica: on a virtual
    clock; with ``--topology`` a socket-local
    :class:`~repro_torch.topology.TopologyDispatcher`, the clock running
    on the topology's flattened machine; with ``--machine wall`` a
    threaded dispatcher of 4 workers, its trunk eager.  Every dispatcher
    takes its launch variants from ``tuner``.  ``double_buffer=False``
    lowers a Q4 trunk onto the direct kernel instead of the
    double-buffered one; ``cuda_graph=False`` runs the decode step
    uncaptured on the card."""
    chunk = args.prefill_chunk if args.prefill_chunk > 0 else None
    max_seq = args.prompt_len + args.steps + 8
    engines, dispatchers = [], []
    clock = args.topology or args.machine
    wall = args.machine == "wall"
    for i, n_slots in enumerate(replica_slot_counts(args.batch,
                                                    args.replicas)):
        cost = None if wall else HybridPhaseCost(clock, seed=args.seed + i)
        head, trunk = None, None
        if args.balanced_trunk or args.balanced_head:
            if args.topology:
                disp = TopologyDispatcher(args.topology, seed=args.seed + i,
                                          keep_stats=False, tuner=tuner)
            elif wall:
                disp = HybridKernelDispatcher.threaded(
                    WALL_WORKERS, keep_stats=False, tuner=tuner)
            else:
                disp = HybridKernelDispatcher.virtual(
                    args.machine, seed=args.seed + i,
                    execute=True, keep_stats=False,
                    tuner=tuner)
            dispatchers.append(disp)
        if args.balanced_trunk:
            trunk = BalancedTrunk.from_params(
                cfg, params, disp, quant=args.trunk_quant,
                mode="eager" if wall else "compiled",
                double_buffer=double_buffer, device=device)
        elif args.balanced_head:
            head = balanced_lm_head(cfg, params, disp, device=device)
        engines.append(ContinuousBatchingEngine(
            cfg, params, max_slots=n_slots, max_seq=max_seq,
            prefill_chunk=chunk, prefill_lanes=args.prefill_lanes,
            cost_model=cost, balanced_head=head, balanced_trunk=trunk,
            device=device, cuda_graph=cuda_graph))
    return engines, dispatchers


def setup(args, params: Optional[dict] = None, cfg=None) -> tuple:
    """Check the requested modes and resolve (config, device, params) for
    ``args``: ``params`` (the port's layout, on the device) replaces the
    seeded random weights, ``cfg`` the ``--arch`` / ``--preset`` one."""
    check_flags(args)
    if not args.topology:   # a topology is its own clock
        args.machine = args.machine or "ultra-125h"
    device = resolve_device(args.device)
    if cfg is None:
        cfg = (get_config(args.arch) if args.preset == "full"
               else reduced_config(args.arch))
    if cfg.embed_input:
        raise SystemExit("use examples/ for stub-frontend archs")
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_params(cfg, gen, device=device)
    return cfg, device, params


def serve(args, params: Optional[dict] = None, *, cfg=None,
          double_buffer: bool = True, cuda_graph: bool = True) -> ServeRun:
    """Build the model and replicas for ``args`` and serve its Poisson
    traffic to completion.  ``params`` and ``cfg`` are those of
    :func:`setup`; ``double_buffer`` and ``cuda_graph`` are passed to
    :func:`build_engines`."""
    cfg, device, params = setup(args, params, cfg)
    # one kernel tuner shared by every replica's dispatcher, so a single
    # --tuner-cache file accumulates all launch-variant measurements
    tuner = KernelTuner()
    store = TunerStore(args.tuner_cache) if args.tuner_cache else None
    warm = store is not None and store.load_into(tuner)
    engines, dispatchers = build_engines(args, cfg, params, device,
                                         double_buffer=double_buffer,
                                         cuda_graph=cuda_graph, tuner=tuner)

    table = RatioTable(args.replicas, alpha=0.3)
    if args.ratios:
        RatioStore(args.ratios).load_into(table)
    inflight = InflightDispatcher(engines, table=table)
    requests = poisson_requests(
        args.requests, rate=args.rate, vocab_size=cfg.vocab_size,
        prompt_len=args.prompt_len, max_new_tokens=args.steps,
        seed=args.seed)
    routed = np.zeros(args.replicas, dtype=np.int64)
    iterations = []
    t_wall = time.perf_counter()
    for r in requests:
        # let in-flight work progress up to this arrival so per-phase
        # throughput feedback steers later routing (open loop)
        while inflight.has_work and inflight.now < r.arrival_time:
            iterations += inflight.step()
        i, _ = inflight.submit(r)
        routed[i] += 1
    for stats in inflight.run_until_idle():
        iterations += stats
    clock = "virtual" if args.machine != "wall" else "wall"
    report = LatencyReport.from_requests(
        requests, clock=clock, wall_duration=time.perf_counter() - t_wall)
    if args.ratios:
        RatioStore(args.ratios).save(table)
    if store is not None:
        store.save(tuner)
    return ServeRun(cfg=cfg, device=device, engines=engines,
                    dispatchers=dispatchers, inflight=inflight,
                    requests=requests, routed=routed,
                    slot_counts=replica_slot_counts(args.batch,
                                                    args.replicas),
                    clock=clock, report=report, iterations=iterations,
                    tuner=tuner, tuner_warm=warm)


@dataclass
class LegacyRun:
    """What one ``--legacy-batch`` round produced."""

    server: RoutedServer
    tokens: np.ndarray    # (batch, prompt_len + steps)
    counts: np.ndarray    # requests per replica
    times: np.ndarray     # seconds per replica, fed back to the router


def serve_legacy(args, params: Optional[dict] = None, *,
                 cfg=None) -> LegacyRun:
    """``--legacy-batch``: one seed-era ``RoutedServer.serve_batch`` round
    of ``args.batch`` seeded random prompts over one static-batch engine
    per replica.  ``params`` and ``cfg`` are those of :func:`setup`."""
    cfg, device, params = setup(args, params, cfg)
    max_seq = args.prompt_len + args.steps + 8
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, size=(args.batch, args.prompt_len),
        dtype=np.int32)
    server = RoutedServer([
        ServeEngine(cfg, params, batch_size=n, max_seq=max_seq,
                    device=device)
        for n in replica_slot_counts(args.batch, args.replicas)])
    tokens, counts, times = server.serve_batch(prompts, args.steps)
    return LegacyRun(server=server, tokens=tokens, counts=counts,
                     times=times)


def legacy_lines(run: LegacyRun) -> list:
    """The printout of a ``--legacy-batch`` round (the reference's)."""
    return [f"[serve] legacy routed counts={run.counts.tolist()} "
            f"times={run.times.round(3).tolist()}",
            f"[serve] generated shape={run.tokens.shape}"]


def report_lines(args, run: ServeRun) -> list:
    """The printout of a run (the reference's lines)."""
    lines = []
    if run.tuner_warm:
        lines.append(f"[serve] warm-started kernel tuner from "
                     f"{args.tuner_cache}")
    lines.append(f"[serve] {args.replicas} replica(s), "
                 f"slots={run.slot_counts}, routed={run.routed.tolist()} "
                 f"({run.clock} clock) on {run.device}")
    lines += run.report.lines()
    table = run.inflight.table
    lines.append(f"[serve] replica prefill ratios: "
                 f"{np.round(table.ratios(PREFILL), 3).tolist()}")
    lines.append(f"[serve] replica decode  ratios: "
                 f"{np.round(table.ratios(DECODE), 3).tolist()}")
    if run.clock == "virtual":
        core = run.engines[0].cost_model.table
        lines.append(
            f"[serve] core ratio spread (replica 0): "
            f"prefill={core.ratios(PREFILL).max() / core.ratios(PREFILL).min():.2f}x "
            f"decode={core.ratios(DECODE).max() / core.ratios(DECODE).min():.2f}x")
        lines.append(
            f"[serve] decode achieved-bandwidth fraction (replica 0): "
            f"{run.engines[0].cost_model.achieved_bandwidth_fraction():.2f}")
    if args.balanced_head and run.clock == "virtual":
        d0 = run.dispatchers[0]
        kt = d0.table.ratios(GEMV_ISA)
        lines.append(f"[serve] balanced-head kernel table (replica 0): "
                     f"membw spread={kt.max() / kt.min():.2f}x "
                     f"achieved_bw_frac="
                     f"{d0.achieved_bandwidth_fraction():.2f}")
    if args.topology:
        lines += topology_lines(args, run)
    elif args.balanced_trunk and run.clock == "virtual":
        d0 = run.dispatchers[0]
        for kind in TRUNK_KINDS:
            key = kernel_key(GEMV_ISA, kind)
            if key in d0.table.keys():
                kt = d0.table.ratios(key)
                lines.append(f"[serve] trunk {key} spread: "
                             f"{kt.max() / kt.min():.2f}x")
        lines.append(f"[serve] trunk decode achieved_bw_frac (replica 0): "
                     f"{d0.achieved_bandwidth_fraction():.2f}")
    sample = run.requests[0].tokens
    lines.append(f"[serve] sample: "
                 f"{sample[-min(16, args.steps):].tolist()}")
    if args.tuner_cache:
        lines.append(f"[serve] saved kernel tuner tables to "
                     f"{args.tuner_cache}")
    return lines


def topology_lines(args, run: ServeRun) -> list:
    """The ``--topology`` printout of replica 0 (the reference's): the
    topology, the trunk's placement, the socket split per trunk kind and
    the per-socket and aggregate achieved-bandwidth fractions — all of
    the machine model, on the virtual clock."""
    d0 = run.dispatchers[0]
    lines = [f"[serve] topology {args.topology}: "
             f"{d0.topology.n_sockets} socket(s), "
             f"aggregate {d0.topology.aggregate_bandwidth / 1e9:.1f} GB/s"]
    if run.engines[0].placement is not None:
        lines += run.engines[0].placement.lines()
    for kind in TRUNK_KINDS:
        key = kernel_key(GEMV_ISA, kind)
        if key in d0.table.keys():
            lines.append(f"[serve] socket split {key}: "
                         f"{np.round(d0.socket_ratios(key), 3).tolist()}")
    fracs = [d0.achieved_bandwidth_fraction(socket=s)
             for s in range(d0.topology.n_sockets)]
    lines.append(f"[serve] per-socket decode achieved_bw_frac (replica 0): "
                 f"{[round(f, 2) for f in fracs]}")
    lines.append(f"[serve] aggregate decode achieved_bw_frac (replica 0): "
                 f"{d0.achieved_bandwidth_fraction():.2f}")
    return lines


# ------------------------------------------------------------------ fleet --
@dataclass
class FleetRun:
    """What one ``--fleet`` run produced."""

    cluster: object       # repro_torch.fleet.Cluster
    router: object        # repro_torch.fleet.FleetRouter
    requests: list        # every finished request, shed and aborted included
    report: LatencyReport
    warm_started: bool    # the node table was loaded from --ratios


def fleet_specs(args) -> tuple:
    """The default heterogeneous fleet: a NUMA flagship and a NUMA desktop
    (one engine per socket, 2 prefill lanes each), a flat box, and a flat
    box throttled 3x."""
    from repro_torch.fleet import NodeSpec

    return (
        NodeSpec("big", "dual-125h", max_slots=args.batch, prefill_lanes=2),
        NodeSpec("mid", "2s-12900k", max_slots=args.batch, prefill_lanes=2),
        NodeSpec("flat", "ultra-125h", max_slots=args.batch),
        NodeSpec("slow", "ultra-125h", max_slots=args.batch, throttle=3.0),
    )


def serve_fleet(args, params: Optional[dict] = None, *,
                cfg=None) -> FleetRun:
    """``--fleet``: the default fleet behind the recursive FleetRouter,
    under diurnal heavy-tailed traffic with a failure window on the
    flagship from a quarter to 0.6 of the expected span.  Every engine
    runs on the device of ``args``; ``params`` and ``cfg`` are those of
    :func:`setup`."""
    from repro_torch.fleet import (AdmissionController, Cluster,
                                   FleetRouter, failure_window,
                                   fleet_requests)

    cfg, device, params = setup(args, params, cfg)
    max_seq = args.prompt_len + args.steps + 8
    specs = fleet_specs(args)
    cluster = Cluster.build(specs, cfg, params, max_seq=max_seq,
                            seed=args.seed, device=device)
    admission = None
    if args.fleet_admission:
        admission = AdmissionController(queue_cap=6 * len(specs),
                                        degrade_depth=3 * len(specs))
    # --ratios warm-starts/persists the *node-level* fleet table here
    table = RatioTable(len(specs), alpha=0.3)
    store = RatioStore(args.ratios) if args.ratios else None
    warm = store is not None and store.load_into(table)
    router = FleetRouter(cluster, policy=args.fleet_policy, table=table,
                         slo_ttft=FLEET_SLO_TTFT, slo_tpot=FLEET_SLO_TPOT,
                         admission=admission)
    requests = fleet_requests(
        args.requests, base_rate=args.rate, vocab_size=cfg.vocab_size,
        prompt_len=(4, args.prompt_len), max_new_tokens=args.steps,
        seed=args.seed)
    span = args.requests / args.rate
    events = failure_window("big", fail_at=0.25 * span,
                            recover_at=0.6 * span)
    t_wall = time.perf_counter()
    done = router.run(requests, events)
    report = LatencyReport.from_requests(
        done, slo_ttft=FLEET_SLO_TTFT, slo_tpot=FLEET_SLO_TPOT,
        wall_duration=time.perf_counter() - t_wall)
    if store is not None:
        store.save(router.table)
    return FleetRun(cluster=cluster, router=router, requests=done,
                    report=report, warm_started=warm)


def fleet_lines(args, run: FleetRun) -> list:
    """The printout of a ``--fleet`` run (the reference's)."""
    router = run.router
    names = [n.name for n in run.cluster.nodes]
    lines = []
    if run.warm_started:
        lines.append(f"[serve] warm-started fleet node ratios from "
                     f"{args.ratios}")
    lines.append(f"[serve] fleet {names} policy={args.fleet_policy} "
                 f"routed={router.routed.tolist()} "
                 f"requeued={router.n_requeued}")
    lines += run.report.lines()
    lines.append(f"[serve] node prefill ratios: "
                 f"{np.round(router.table.ratios(PREFILL), 3).tolist()}")
    lines.append(f"[serve] node decode  ratios: "
                 f"{np.round(router.table.ratios(DECODE), 3).tolist()}")
    st = router.last_stats.get(DECODE)
    if st is not None:
        lines.append(f"[serve] recursive decode stats: {len(st.children)} "
                     f"node domains under the fleet table")
    if args.ratios:
        lines.append(f"[serve] saved fleet node ratios to {args.ratios}")
    return lines


# ----------------------------------------------------------- observability --
class Observers:
    """The ``--trace``, ``--flight-recorder`` and ``--metrics`` sinks of
    one run: installed before the mode runs, written after it returns (or
    raises) by :meth:`close`, which returns the lines to print."""

    def __init__(self, args):
        self.args = args
        self.tracer = self.recorder = self.registry = None
        self._prev_tracer = self._prev_recorder = None
        if args.trace:
            from repro_torch.obs import SpanTracer
            self.tracer = SpanTracer()
            self._prev_tracer = _ev.install(self.tracer)
        if args.flight_recorder:
            from repro_torch.obs import FlightRecorder
            self.recorder = FlightRecorder(
                path=args.flight_recorder,
                slo_ttft=FLEET_SLO_TTFT if args.fleet else None,
                slo_tpot=FLEET_SLO_TPOT if args.fleet else None)
            self._prev_recorder = _ev.install_recorder(self.recorder)
        if args.metrics:
            from repro_torch.obs import MetricsRegistry
            self.registry = MetricsRegistry()

    def close(self) -> list:
        args, lines = self.args, []
        if self.tracer is not None:
            _ev.install(self._prev_tracer)
            self.tracer.write(args.trace)
            lines.append(f"[serve] wrote trace to {args.trace} "
                         f"({self.tracer.n_spans} spans, "
                         f"{self.tracer.n_counters} counter samples, "
                         f"{self.tracer.n_instants} instants)")
        if self.recorder is not None:
            _ev.install_recorder(self._prev_recorder)
            if self.recorder.last_dump is None:
                self.recorder.trip("exit")
            lines.append(f"[serve] flight recorder: "
                         f"{len(self.recorder.records())} records, "
                         f"{len(self.recorder.trips)} trip(s) -> "
                         f"{args.flight_recorder}")
        if self.registry is not None:
            if args.metrics.endswith(".json"):
                self.registry.write_json(args.metrics)
            else:
                with open(args.metrics, "w", encoding="utf-8") as fh:
                    fh.write(self.registry.prometheus_text())
            lines.append(f"[serve] wrote metrics to {args.metrics}")
        return lines


def run_mode(args, registry=None) -> list:
    """Run the selected mode (fleet / legacy / default) and return its
    printout; the run's latency report is published into ``registry``
    when one is given."""
    if args.fleet:
        run = serve_fleet(args)
        if registry is not None:
            run.report.publish(registry)
        return fleet_lines(args, run)
    if args.legacy_batch:
        return legacy_lines(serve_legacy(args))
    run = serve(args)
    if registry is not None:
        run.report.publish(registry)
    return report_lines(args, run)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    check_flags(args)
    observers = Observers(args)
    try:
        for line in run_mode(args, observers.registry):
            print(line)
    finally:
        for line in observers.close():
            print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
