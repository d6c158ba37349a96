"""Hybrid kernel dispatch: Balancer-planned per-core shards of real kernels.

The paper's runtime splits every GEMM/GEMV along its N dimension into one
*contiguous* shard per core, sized by the per-ISA performance-ratio table
(Eq. 3), and feeds the shard times back into the table (Eq. 2)::

    RatioTable["avx_vnni" | "membw"]  --Eq.3-->  per-core N shards
         ^                                           |
         |                                      worker pool runs the real
         +------------- Eq.2 + EMA <----------- kernel shard

:class:`HybridKernelDispatcher` owns that loop for any caller:

* ``dispatch(spec, total[, fn][, plan=])`` — the split/run/report cycle
  for an abstract kernel (``fn=None`` runs the pure virtual-time model;
  ``plan=`` replays a split the device already executed, the compiled
  decode feedback);
* ``q4_matmul(x, qw)`` / ``int8_gemm(a, w)`` / ``f32_matmul(x, w)`` —
  eager sharded execution: each worker's shard is one launch of the real
  kernel over that worker's weight rows, written straight into that
  worker's columns of one preallocated output on the device (no host
  round trip and no copy per shard; zero-width shards launch nothing).

Two pools run the shards.  :meth:`HybridKernelDispatcher.virtual` runs
them in turn on the caller's thread and takes their times from the
simulated hybrid CPU; :meth:`HybridKernelDispatcher.threaded` runs them
on persistent OS threads, one per worker, and the pool times each worker
on the wall clock: the paper's measure → EMA → split loop on real
hardware.  On the card a threaded shard runs on a CUDA stream of its own
worker, which first waits for the caller's stream (where x was made);
the worker synchronizes its stream before it returns, so its time covers
the kernel, and after the region the caller's stream waits for every
worker stream.  A threaded region emits no span on the virtual clock.

Per-shard launch variants: each eager Q4 or int8 shard asks the
dispatcher's :class:`~repro_torch.core.tuner.KernelTuner` for a variant
(:data:`~repro_torch.kernels.ops.Q4_CANDIDATES`,
:data:`~repro_torch.kernels.ops.INT8_CANDIDATES`) under
``(kernel, shape_class(m, shard rows, k))``, launches it, times it
(:func:`~repro_torch.kernels.ops.time_call`) and reports the time,
unless the caller pins the variant (``variant=``).  Every variant gives
the same bits, so eager and compiled outputs stay bitwise equal whatever
the tuner picks.  The Q4 shards run at
:func:`~repro_torch.kernels.ops.q4_blocks`, the compiled lowering's
blocks.

Primary-ISA keying follows the paper: compute-bound prefill GEMMs dispatch
under ``"avx_vnni"``, memory-bound decode GEMVs under ``"membw"``, and the
balanced trunk refines the table key per layer kind with
:func:`kernel_key` (``"membw/attn_proj"``-style keys).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core import events as _ev
from repro_torch.core.hybrid_sim import SimulatedHybridCPU, make_machine
from repro_torch.core.pool import SubTask, ThreadWorkerPool, VirtualWorkerPool
from repro_torch.core.tuner import KernelTuner, shape_class
from repro_torch.quant.q4 import BYTES_PER_ELEM, QuantizedLinear
from repro_torch.runtime import (
    Balancer,
    EvenPolicy,
    KernelSpec,
    Plan,
    ProportionalPolicy,
    RatioTable,
    RegionStats,
    StatsSink,
)

from . import ops

__all__ = ["HybridKernelDispatcher", "GEMM_ISA", "GEMV_ISA",
           "TRUNK_KINDS", "kernel_key"]

GEMM_ISA = "avx_vnni"   # compute-bound prefill GEMM
GEMV_ISA = "membw"      # memory-bound decode GEMV

# Layer kinds of the balanced trunk: every decode-step projection family
# gets its own ratio-table key per ISA (q/k/v/o share "attn_proj"; the MLP
# up/gate projections share "mlp_up"; the down projection and the LM head
# stand alone).
TRUNK_KINDS = ("attn_proj", "mlp_up", "mlp_down", "head")


def kernel_key(isa: str, kind: Optional[str] = None) -> str:
    """Ratio-table key for a trunk projection: ``"<isa>/<kind>"`` (or the
    bare ISA when no kind is given)."""
    return isa if kind is None else f"{isa}/{kind}"


class _WorkerStreams:
    """The CUDA stream of each worker thread of a threaded dispatcher,
    made on the thread's first shard and kept for the pool's life."""

    def __init__(self):
        self._local = threading.local()
        self._lock = threading.Lock()
        self.streams: list = []

    def stream(self, device: torch.device):
        s = getattr(self._local, "stream", None)
        if s is None:
            s = torch.cuda.Stream(device)
            self._local.stream = s
            with self._lock:
                self.streams.append(s)
        return s


class HybridKernelDispatcher:
    """Per-core balanced dispatch of kernel parallel regions.

    Construct via :meth:`virtual` (deterministic hybrid-CPU model, one
    :class:`VirtualWorkerPool` per ISA over a shared machine) or
    :meth:`threaded` (real OS threads with wall-clock shard times).  One
    dispatcher owns one :class:`RatioTable` keyed by primary ISA (refined
    per layer kind), one :class:`KernelTuner` for per-shard launch
    variants, and running bytes/busy-seconds accounting per ISA for
    achieved-bandwidth fractions.

    ``dynamic=False`` turns the dispatcher into the OpenMP-balanced static
    baseline (equal shards, no feedback) — same execution path, so dynamic
    vs. static comparisons isolate the paper's contribution.
    """

    def __init__(self, pool_factory: Callable[[str], object], n_workers: int,
                 *, machine: Optional[SimulatedHybridCPU] = None,
                 table: Optional[RatioTable] = None, alpha: float = 0.3,
                 tuner: Optional[KernelTuner] = None,
                 sink: Optional[StatsSink] = None, dynamic: bool = True,
                 keep_stats: bool = True):
        self.n_workers = n_workers
        self.machine = machine
        self.table = table or RatioTable(n_workers, alpha=alpha)
        if self.table.n_workers != n_workers:
            raise ValueError("table size does not match worker count")
        self.tuner = tuner or KernelTuner()
        self.sink = sink
        self.dynamic = dynamic
        self.keep_stats = keep_stats
        self.stats: list = []
        self.last_stats: Optional[RegionStats] = None
        self._pool_factory = pool_factory
        self._pools: Dict[str, object] = {}
        self._balancers: Dict[tuple, Balancer] = {}
        # worker liveness the owner can flip directly; combined with the
        # machine's scheduled capacity events at plan time (capacity_mask)
        self.active = np.ones(n_workers, dtype=bool)
        self._bytes: Dict[str, float] = {}
        self._busy: Dict[str, float] = {}
        # bytes/busy accounting is a read-modify-write on plain dicts;
        # reports may arrive from concurrent regions, so it is locked
        self._acct_lock = threading.Lock()
        self._streams: Optional[_WorkerStreams] = None   # threaded only

    # ------------------------------------------------------- constructors --
    @classmethod
    def virtual(cls, machine: SimulatedHybridCPU | str, *,
                execute: bool = False, seed: int = 0, **kwargs):
        """Dispatcher over the simulated hybrid CPU: shard times come from
        the core model; ``execute=True`` additionally runs the real kernel
        shards (the eager trunk)."""
        if isinstance(machine, str):
            machine = make_machine(machine, seed=seed)
        return cls(
            lambda isa: VirtualWorkerPool(machine, isa=isa, execute=execute),
            machine.n_cores, machine=machine, **kwargs)

    @classmethod
    def threaded(cls, n_workers: int, **kwargs):
        """Dispatcher over one persistent OS-thread pool (wall-clock shard
        times; the ISA only keys the ratio table).  On the card each
        worker launches on a CUDA stream of its own."""
        pool = ThreadWorkerPool(n_workers)
        d = cls(lambda isa: pool, n_workers, **kwargs)
        d._streams = _WorkerStreams()
        return d

    def close(self) -> None:
        for pool in {id(p): p for p in self._pools.values()}.values():
            pool.close()

    # ------------------------------------------------------------ plumbing --
    def _pool(self, isa: str):
        if isa not in self._pools:
            self._pools[isa] = self._pool_factory(isa)
        return self._pools[isa]

    def set_active(self, i: int, active: bool = True) -> None:
        """Mark worker ``i`` parked (or returned).  Plans stop assigning
        to it; its ratio-table entry is untouched, so it resumes at its
        last learned speed."""
        if not 0 <= i < self.n_workers:
            raise IndexError(f"worker {i} out of range")
        self.active[i] = bool(active)

    def capacity_mask(self, isa: str = GEMV_ISA) -> np.ndarray:
        """The plan-time active mask: explicit :meth:`set_active` state
        AND the machine's scheduled capacity events sampled at the ISA
        pool's clock (the time the next region will actually start)."""
        mask = self.active.copy()
        if self.machine is not None:
            pool = self._pools.get(isa)
            now = float(getattr(pool, "clock", 0.0)) if pool is not None else 0.0
            mask &= self.machine.active_mask(now)
        return mask

    def _balancer(self, spec: KernelSpec) -> Balancer:
        key = (spec.table_key, spec.granularity)
        if key not in self._balancers:
            if self.dynamic:
                policy = ProportionalPolicy(
                    self.table, key=spec.table_key,
                    granularity=spec.granularity,
                    active=lambda isa=spec.isa: self.capacity_mask(isa))
            else:
                # the static baseline stays capacity-blind on purpose
                policy = EvenPolicy(self.n_workers,
                                    granularity=spec.granularity)
            self._balancers[key] = Balancer(policy, sink=self.sink,
                                            keep_stats=False)
        return self._balancers[key]

    # ------------------------------------------------------------ dispatch --
    def dispatch(self, spec: KernelSpec, total: int,
                 fn: Optional[Callable[[int, int], None]] = None, *,
                 bytes_per_unit: float = 0.0, work_scale: float = 1.0,
                 update: bool = True,
                 plan: Optional[Plan] = None) -> RegionStats:
        """One balanced parallel region of ``total`` units along the
        kernel's split dimension: plan per-core contiguous shards, run them
        on the ISA's pool, feed shard times back.  ``plan`` replays an
        externally realized split instead of planning afresh — the
        compiled-decode feedback path, where the per-core counts were fixed
        by the offset snapshot the device executed."""
        bal = self._balancer(spec)
        if plan is None:
            plan = bal.plan(total)
        elif int(np.asarray(plan.counts).sum()) != total:
            raise ValueError("replayed plan does not cover the region")
        work_per_unit = spec.work_per_unit * work_scale
        subtasks = [
            SubTask(worker=w, start=lo, size=hi - lo,
                    work=float(hi - lo) * work_per_unit, fn=fn)
            for w, (lo, hi) in enumerate(plan.ranges)
        ]
        pool = self._pool(spec.isa)
        tracing = _ev.TRACER is not None
        t0 = getattr(pool, "clock", None) if tracing else None
        times = pool.run(subtasks)
        moved = float(total) * bytes_per_unit
        st = bal.report(plan, times, update=update and self.dynamic,
                        label=f"{spec.name}@{spec.table_key}",
                        bytes_moved=moved)
        if moved > 0 and st.makespan > 0:
            self._account(spec.isa, moved, st.makespan)
        if t0 is not None:
            _ev.emit_span(
                f"dispatch:{spec.isa}", f"{spec.name}@{spec.table_key}",
                t0, pool.clock - t0, cat="dispatch",
                args=lambda: {"units": int(total),
                              "imbalance": round(st.imbalance, 4)})
            _ev.emit_counter(
                f"ratio:{spec.table_key}", pool.clock,
                lambda: {f"w{i}": round(float(r), 5) for i, r in
                         enumerate(self.table.ratios(spec.table_key))})
            _ev.emit_counter(
                f"capacity:{spec.isa}", pool.clock,
                lambda: {"active_workers": int(
                    self.capacity_mask(spec.isa).sum())})
            if moved > 0 and self.machine is not None:
                _ev.emit_counter(
                    f"bw:{spec.isa}", pool.clock,
                    lambda: {"achieved_bw_frac": round(
                        self.achieved_bandwidth_fraction(spec.isa), 5)})
        if self.keep_stats:
            self.stats.append(st)
        self.last_stats = st
        return st

    # ----------------------------------------------------------- telemetry --
    def _account(self, isa: str, moved: float, busy: float) -> None:
        """Accrue one region's bytes/busy under the accounting lock."""
        with self._acct_lock:
            if _ev.TRACER is not None:
                where = f"{type(self).__name__}._account"
                _ev.emit_acquire(self._acct_lock, where=where)
                _ev.emit_read(self, f"bytes[{isa}]", where=where)
                _ev.emit_write(self, f"bytes[{isa}]", where=where)
            self._bytes[isa] = self._bytes.get(isa, 0.0) + moved
            self._busy[isa] = self._busy.get(isa, 0.0) + busy
            if _ev.TRACER is not None:
                _ev.emit_release(self._acct_lock,
                                 where=f"{type(self).__name__}._account")

    def reset_bandwidth_accounting(self) -> None:
        """Zero the cumulative bytes/busy counters (steady-state windows:
        warm the ratio tables first, reset, then measure)."""
        self._bytes.clear()
        self._busy.clear()

    def achieved_bandwidth(self, isa: str = GEMV_ISA) -> float:
        """Bytes/s streamed by this dispatcher's ``isa`` regions so far
        (total bytes moved / total region makespan)."""
        busy = self._busy.get(isa, 0.0)
        if busy <= 0:
            return 0.0
        return self._bytes.get(isa, 0.0) / busy

    def achieved_bandwidth_fraction(self, isa: str = GEMV_ISA) -> float:
        """The paper's headline metric: achieved bandwidth as a fraction of
        the machine's streaming (MLC-analogue) bandwidth.  Requires a
        virtual machine (the denominator)."""
        if self.machine is None:
            raise ValueError("bandwidth fraction needs a simulated machine")
        return self.achieved_bandwidth(isa) / self.machine.socket_bandwidth

    # ------------------------------------------------------- real kernels --
    def _require_executing(self, isa: str) -> None:
        pool = self._pool(isa)
        if getattr(pool, "execute", True) is False:
            raise ValueError(
                "this dispatcher's virtual pool does not execute shard fns "
                "(construct with execute=True), so kernel outputs would be "
                "missing; use dispatch() for purely modelled regions")

    def _on_workers(self, fn: Callable[[int, int], None],
                    device: torch.device) -> Callable[[int, int], None]:
        """``fn`` as a threaded dispatcher's worker runs it on the card: on
        the worker's own stream, after the caller's stream has reached
        this point, synchronized before the worker returns (so the pool's
        wall time covers the kernel).  Unchanged elsewhere."""
        if self._streams is None or device.type != "cuda":
            return fn
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(device))

        def run(start: int, size: int) -> None:
            s = self._streams.stream(device)
            with torch.cuda.device(device), torch.cuda.stream(s):
                s.wait_event(ready)
                fn(start, size)
            s.synchronize()
        return run

    def _run_shards(self, spec: KernelSpec, total: int,
                    fn: Callable[[int, int], None], device: torch.device,
                    **kwargs) -> None:
        """One region of real shards (:meth:`dispatch`); after a threaded
        region on the card the caller's stream waits for every worker
        stream."""
        self.dispatch(spec, total, self._on_workers(fn, device), **kwargs)
        if self._streams is not None and device.type == "cuda":
            caller = torch.cuda.current_stream(device)
            for s in self._streams.streams:
                caller.wait_stream(s)

    def _shard_fn(self, kernel: str, m: int, k: int, candidates,
                  variant: Optional[tuple],
                  run_shard: Callable[[int, int, tuple, torch.Tensor], None],
                  out: torch.Tensor) -> Callable[[int, int], None]:
        """One shard: the kernel's launch ``variant`` — or, unpinned, the
        tuner's pick among ``candidates`` under ``(kernel,
        shape_class(m, size, k))``, timed and reported — over weight rows
        [start, start + size), writing columns [start, start + size) of
        ``out`` in place."""
        def fn(start: int, size: int) -> None:
            dst = out[:, start:start + size]
            if variant is not None:
                run_shard(start, size, variant, dst)
                return
            key = (kernel, shape_class(m, size, k))
            cfg = self.tuner.select(key, candidates)
            _, secs = ops.time_call(
                lambda: run_shard(start, size, cfg, dst), out.device)
            self.tuner.report(key, cfg, secs)
        return fn

    def q4_matmul(self, x: torch.Tensor, qw: QuantizedLinear, *,
                  isa: str = GEMV_ISA, key: Optional[str] = None,
                  variant: Optional[tuple] = None, granularity: int = 8,
                  work_scale: float = 1.0,
                  update: bool = True) -> torch.Tensor:
        """Fp32-Int4-Fp32 ``x (M,K) @ Q4_0 (N,K).T`` as balanced per-core
        N-row shards of a Q4 kernel entry, at the compiled lowering's
        blocks for K (:func:`~repro_torch.kernels.ops.q4_blocks`): the
        tuner's pick of ``("direct",)`` or ``("ring",)`` per shard, or
        ``variant`` when pinned (the reference's pinned ``blocks``).
        ``isa`` keys the ratio table ("membw" for decode GEMV, "avx_vnni"
        when the same kernel runs compute-bound prefill); ``key`` refines
        the table key per layer kind (see :func:`kernel_key`)."""
        self._require_executing(isa)
        m, k = x.shape
        n = qw.out_features
        out = torch.empty((m, n), dtype=x.dtype, device=x.device)

        def run_shard(start, size, var, dst):
            shard = QuantizedLinear(qw.packed[start:start + size],
                                    qw.scales[start:start + size])
            ops.q4_variant(x, shard, var, out=dst)

        bytes_per_row = k * BYTES_PER_ELEM
        work = bytes_per_row if isa == GEMV_ISA else 2.0 * m * k
        spec = KernelSpec("q4_matmul", isa=isa, granularity=granularity,
                          work_per_unit=work, key=key)
        fn = self._shard_fn("q4_matmul", m, k, ops.Q4_CANDIDATES, variant,
                            run_shard, out)
        self._run_shards(spec, n, fn, x.device,
                         bytes_per_unit=bytes_per_row, work_scale=work_scale,
                         update=update)
        return out

    def int8_gemm(self, a_u8: torch.Tensor, w_s8: torch.Tensor, *,
                  isa: str = GEMM_ISA, key: Optional[str] = None,
                  variant: Optional[tuple] = None, granularity: int = 16,
                  work_scale: float = 1.0,
                  update: bool = True) -> torch.Tensor:
        """u8 (M,K) x s8 (N,K) -> s32 (M,N) as balanced per-core N-row
        shards of the int8 kernel (the paper's VNNI prefill GEMM), each at
        the tuner's pick of the kernel's instantiations (or ``variant``);
        the s32 sums are exact, so shard outputs equal the monolithic
        product bit for bit."""
        self._require_executing(isa)
        m, k = a_u8.shape
        n = w_s8.shape[0]
        out = torch.empty((m, n), dtype=torch.int32, device=a_u8.device)

        def run_shard(start, size, var, dst):
            ops.int8_gemm(a_u8, w_s8[start:start + size], out=dst,
                          variant=var)

        work = 2.0 * m * k if isa != GEMV_ISA else float(k)
        spec = KernelSpec("int8_gemm", isa=isa, granularity=granularity,
                          work_per_unit=work, key=key)
        fn = self._shard_fn("int8_gemm", m, k, ops.INT8_CANDIDATES, variant,
                            run_shard, out)
        self._run_shards(spec, n, fn, a_u8.device, bytes_per_unit=float(k),
                         work_scale=work_scale, update=update)
        return out

    def f32_matmul(self, x: torch.Tensor, w: torch.Tensor, *,
                   isa: str = GEMV_ISA, key: Optional[str] = None,
                   granularity: int = 1, work_scale: float = 1.0,
                   update: bool = True) -> torch.Tensor:
        """f32 ``x (M,K) @ W (N,K).T`` as balanced per-core N-row shards of
        a plain ``torch.matmul`` (TF32 off) — no quantization, no block
        constraints (``granularity=1``), no variant to tune.  This is the
        trunk's precision reference: the bytes model streams the f32
        weight rows (4K bytes each).  A shard may sum in another order than
        the monolithic product (the BLAS picks its kernel by shape), so the
        two agree within float tolerance, not bit for bit."""
        self._require_executing(isa)
        x = x.to(torch.float32)
        m, k = x.shape
        n = w.shape[0]
        out = torch.empty((m, n), dtype=torch.float32, device=x.device)

        def fn(start: int, size: int) -> None:
            ops.f32_matmul(x, w[start:start + size],
                           out=out[:, start:start + size])

        bytes_per_row = 4.0 * k
        work = bytes_per_row if isa == GEMV_ISA else 2.0 * m * k
        spec = KernelSpec("f32_matmul", isa=isa, granularity=granularity,
                          work_per_unit=work, key=key)
        self._run_shards(spec, n, fn, x.device,
                         bytes_per_unit=bytes_per_row, work_scale=work_scale,
                         update=update)
        return out
