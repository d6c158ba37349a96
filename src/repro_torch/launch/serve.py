"""Serve entry point of the port: request-level continuous batching with
open-loop (seeded Poisson) traffic, phase-aware ratio learning, and dynamic
replica routing — on the card by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \\
      --preset full --balanced-trunk --trunk-quant q4 --replicas 1

Requests arrive open-loop and are routed to replicas by measured
per-phase throughput; each replica interleaves chunked prefill with its
running decode batch.  ``--machine`` drives a deterministic virtual clock
from the paper's hybrid-CPU model (``--machine wall``: real wall time).
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

``--device cpu`` runs the same path with the kernels' plain torch version.
The fleet and topology modes, the kernel-tuner cache and the
observability exporters are not ported yet: those flags exit with a
message.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.hybrid_sim import MACHINES
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

# flag -> what it needs that the port does not carry yet
NOT_PORTED = {
    "fleet": "the fleet package",
    "topology": "the topology package",
    "trace": "the observability exporters",
    "metrics": "the observability exporters",
    "flight_recorder": "the observability exporters",
    "tuner_cache": "the kernel tuner front end (TunedMatmul)",
}


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
    ap.add_argument("--arch", default="llama2-7b")
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
    ap.add_argument("--fleet", action="store_true", help="(not ported yet)")
    ap.add_argument("--topology", default=None, help="(not ported yet)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="(not ported yet)")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="(not ported yet)")
    ap.add_argument("--flight-recorder", default=None, metavar="PATH",
                    help="(not ported yet)")
    ap.add_argument("--balanced-head", action="store_true",
                    help="run the LM head as balanced per-core Q4 kernel "
                         "shards (hybrid kernel dispatch) instead of inside "
                         "the decode step")
    ap.add_argument("--tuner-cache", default=None, help="(not ported yet)")
    return ap


def check_ported(args) -> None:
    """Raise SystemExit naming the first requested mode the port lacks."""
    for flag, needs in NOT_PORTED.items():
        if getattr(args, flag):
            raise SystemExit(f"--{flag.replace('_', '-')} is not ported yet "
                             f"(needs {needs})")
    if args.balanced_head and args.balanced_trunk:
        raise SystemExit("--balanced-trunk already includes the head; "
                         "drop --balanced-head")
    for flag in ("balanced_trunk", "balanced_head"):
        if getattr(args, flag) and args.machine == "wall":
            raise SystemExit(f"--machine wall with "
                             f"--{flag.replace('_', '-')} is not ported yet "
                             f"(needs the threaded dispatcher)")


@dataclass
class ServeRun:
    """What one serving run produced (the printout reads it)."""

    cfg: object
    device: torch.device
    engines: List[ContinuousBatchingEngine]
    dispatchers: List[HybridKernelDispatcher]
    inflight: InflightDispatcher
    requests: List[Request]
    routed: np.ndarray
    slot_counts: list
    clock: str
    report: LatencyReport
    iterations: list      # IterationStats of every engine step, in order


def build_engines(args, cfg, params, device, *,
                  double_buffer: bool = True,
                  cuda_graph: bool = True) -> tuple:
    """One continuous-batching engine (and, with ``--balanced-trunk`` or
    ``--balanced-head``, one virtual-clock kernel dispatcher) per replica.
    ``double_buffer=False`` lowers a Q4 trunk onto the direct kernel
    instead of the double-buffered one; ``cuda_graph=False`` runs the
    decode step uncaptured on the card."""
    chunk = args.prefill_chunk if args.prefill_chunk > 0 else None
    max_seq = args.prompt_len + args.steps + 8
    engines, dispatchers = [], []
    for i, n_slots in enumerate(replica_slot_counts(args.batch,
                                                    args.replicas)):
        cost = (None if args.machine == "wall"
                else HybridPhaseCost(args.machine, seed=args.seed + i))
        head, trunk = None, None
        if args.balanced_trunk:
            disp = HybridKernelDispatcher.virtual(
                args.machine, seed=args.seed + i, keep_stats=False)
            dispatchers.append(disp)
            trunk = BalancedTrunk.from_params(cfg, params, disp,
                                              quant=args.trunk_quant,
                                              double_buffer=double_buffer,
                                              device=device)
        elif args.balanced_head:
            disp = HybridKernelDispatcher.virtual(
                args.machine, seed=args.seed + i, execute=True,
                keep_stats=False)
            dispatchers.append(disp)
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
    check_ported(args)
    args.machine = args.machine or "ultra-125h"
    device = resolve_device(args.device)
    if cfg is None:
        cfg = (get_config(args.arch) if args.preset == "full"
               else reduced_config(args.arch))
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
    engines, dispatchers = build_engines(args, cfg, params, device,
                                         double_buffer=double_buffer,
                                         cuda_graph=cuda_graph)

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
    return ServeRun(cfg=cfg, device=device, engines=engines,
                    dispatchers=dispatchers, inflight=inflight,
                    requests=requests, routed=routed,
                    slot_counts=replica_slot_counts(args.batch,
                                                    args.replicas),
                    clock=clock, report=report, iterations=iterations)


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
    lines = [f"[serve] {args.replicas} replica(s), slots={run.slot_counts}, "
             f"routed={run.routed.tolist()} ({run.clock} clock) on "
             f"{run.device}"]
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
    elif run.dispatchers:
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
    return lines


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.legacy_batch:
        for line in legacy_lines(serve_legacy(args)):
            print(line)
        return 0
    run = serve(args)
    for line in report_lines(args, run):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
