"""Compiled balanced decode: shard-planned lowering of the trunk with no
host work inside the step.

The paper's measure -> EMA -> split loop is split across the step the way
the paper splits it across the parallel region:

* **Before the step** (host): the ratio table is planned once per call
  site and written into int32 boundary tensors on the device — an
  :class:`~repro_torch.runtime.OffsetSnapshot`, whose tensors keep their
  addresses from step to step — passed *as arguments* into the step.
  Balance is decided before the parallel work starts.
* **Inside the step** (device): every projection is ONE launch over the
  full (M, N) output — the double-buffered Q4 CUDA kernel
  (:func:`~repro_torch.kernels.q4_matmul.q4_matmul_db`; bf16 activations go
  in and come out as they are, on the tensor cores), the u8 x s8 CUDA
  kernel (:func:`~repro_torch.kernels.int8_gemm.int8_gemm`) between
  dynamic u8 quantization and its dequant, or, for the fp32 trunk, one
  ``torch.matmul``.  Core ``c`` owns output rows
  ``[b[c], b[c+1])`` of the boundary tensor; the per-core shard sizes (the
  boundary differences, computed inside the step once per call site) are
  appended to the step's cost tape — nothing is read back to the host
  inside the step.  When the engine captures the decode step as a CUDA
  graph (:mod:`repro_torch.serving.step_graph`), the records made while
  capturing are the tape of every replay: each replay recomputes their
  size tensors, in the graph's memory, from the refreshed boundaries.
* **After the step** (host): :meth:`CompiledDispatcher.feedback` copies the
  tape's sizes to the host once, replays each recorded region through the
  dispatcher's virtual worker pools — same per-core time model, same Eq. 2
  EMA updates, same bytes/busy bandwidth accounting (two-level
  socket-then-core for a :class:`~repro_torch.topology.TopologyDispatcher`)
  — and refreshes the snapshot for the next step.

:class:`CompiledDispatcher` wraps a flat
:class:`~repro_torch.kernels.dispatch.HybridKernelDispatcher` or a
:class:`~repro_torch.topology.TopologyDispatcher` (duck-typed to avoid the
package cycle); it is what
:class:`~repro_torch.models.balanced.BalancedTrunk` binds to in
``mode="compiled"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import events as _ev
from repro_torch.device import resolve_device
from repro_torch.quant.int8 import quantize_u8_dynamic
from repro_torch.quant.q4 import BYTES_PER_ELEM, QuantizedLinear
from repro_torch.runtime import KernelSpec, OffsetSnapshot, OffsetSpec, Plan

from . import ops
from .ops import q4_blocks
from .dispatch import GEMV_ISA, kernel_key
from .q4_matmul import q4_matmul_db, q4_matmul_plain

__all__ = ["CompiledDispatcher", "CompiledSpec", "q4_blocks"]

# Per-kernel shard granularities, matching the reference's bridged kernel
# entries so both plan over identical grain sizes.
_GRANULARITY = {"q4_matmul": 8, "int8_gemm": 16, "f32_matmul": 1}


@dataclass(frozen=True)
class CompiledSpec:
    """One registered compiled call site: everything the feedback replay
    needs.  ``name`` keys the offset snapshot; tape records carry only
    ``spec_id``."""

    spec_id: int
    name: str        # snapshot key: "<isa>/<kind>@<kernel>:<N>x<K>"
    kernel: str      # "q4_matmul" | "int8_gemm" | "f32_matmul"
    isa: str
    key: str         # ratio-table key (kernel_key(isa, kind))
    kind: str
    n: int
    k: int
    granularity: int


def _introspect(layer):
    """(kernel, K, placement-registry weight object) for a balanced layer
    (duck-typed on storage)."""
    qw = getattr(layer, "qw", None)
    if qw is not None:  # BalancedQuantLinear
        return "q4_matmul", qw.in_features, qw
    w = getattr(layer, "w", None)
    if w is None:
        raise TypeError(f"not a balanced linear: {type(layer).__name__}")
    if hasattr(w, "q"):  # BalancedLinear (QuantizedWeightI8)
        return "int8_gemm", int(w.q.shape[1]), w.q
    return "f32_matmul", int(w.shape[1]), w  # BalancedFp32Linear


class CompiledDispatcher:
    """Compiled lowering + between-step feedback replay over a balanced
    dispatcher.

    One instance owns one :class:`OffsetSnapshot` on ``device`` (planned
    from the same Balancers the dispatcher uses), a spec registry, and the
    step's cost tape.  ``double_buffer`` picks the kernel: the
    double-buffered :func:`q4_matmul_db` (default) or the direct one.  For
    a socket-local topology dispatcher each boundary tensor concatenates
    the per-socket core plans (outer socket split first, then each
    socket's per-core split: one boundary per core of the machine), and
    feedback replays both levels; the socket-oblivious baseline plans and
    replays over its flattened machine.
    """

    def __init__(self, dispatcher, *, double_buffer: bool = True,
                 device="cuda"):
        self.dispatcher = dispatcher
        self.double_buffer = double_buffer
        self.device = resolve_device(device)
        sds = getattr(dispatcher, "socket_dispatchers", None)
        self._topo = sds is not None and bool(getattr(
            dispatcher, "socket_local", False))
        self._oblivious = sds is not None and not self._topo
        self._socket_cores = None
        if self._topo:
            self._socket_cores = [d.n_workers for d in sds]
            self.n_workers = sum(self._socket_cores)
        elif self._oblivious:
            self.n_workers = dispatcher.flat.n_workers
        else:
            self.n_workers = dispatcher.n_workers
        self.snapshot = OffsetSnapshot(self._plan_counts, device=self.device)
        self._specs: List[CompiledSpec] = []
        self._by_name: Dict[str, CompiledSpec] = {}
        # spec_id -> the weight object the trunk's placement registered
        self._weights: Dict[int, object] = {}
        self._tape: Optional[list] = None
        self._inner_ns = 0             # a traced replay's per-socket share
        # boundary tensor id -> (tensor, shard sizes): every projection of
        # one spec in a step reads one boundary tensor, so its sizes are
        # computed once per step (inside it), not once per launch
        self._sizes: Dict[int, tuple] = {}

    # -------------------------------------------------------- registration --
    def spec_for(self, layer, isa: str, kind: str) -> CompiledSpec:
        """The registered spec for one balanced layer under one (ISA,
        kind) — created (and its offset spec registered) on first use."""
        kernel, k, wobj = _introspect(layer)
        n = int(layer.out_features)
        key = kernel_key(isa, kind)
        name = f"{key}@{kernel}:{n}x{k}"
        spec = self._by_name.get(name)
        if spec is not None:
            if spec.kernel != kernel or spec.k != k:
                raise ValueError(
                    f"compiled spec {name!r} re-registered with a different "
                    f"kernel/shape")
            return spec
        g = _GRANULARITY[kernel]
        spec = CompiledSpec(spec_id=len(self._specs), name=name,
                            kernel=kernel, isa=isa, key=key, kind=kind,
                            n=n, k=k, granularity=g)
        self._specs.append(spec)
        self._by_name[name] = spec
        self._weights[spec.spec_id] = wobj
        self.snapshot.register(OffsetSpec(name=name, total=n, granularity=g))
        return spec

    # ------------------------------------------------------------ planning --
    def _kernel_spec(self, spec: CompiledSpec, m: int) -> KernelSpec:
        """The runtime KernelSpec for one replayed region (work model
        identical to the eager kernel entries: bytes per weight row for
        the GEMV, 2*M*K operations otherwise; the int8 GEMV counts K)."""
        if spec.kernel == "int8_gemm":
            work = 2.0 * m * spec.k if spec.isa != GEMV_ISA else float(spec.k)
        else:
            bpr = self._bytes_per_unit(spec)
            work = bpr if spec.isa == GEMV_ISA else 2.0 * m * spec.k
        return KernelSpec(spec.kernel, isa=spec.isa,
                          granularity=spec.granularity,
                          work_per_unit=work, key=spec.key)

    def _bytes_per_unit(self, spec: CompiledSpec) -> float:
        """Weight bytes streamed per output row."""
        if spec.kernel == "q4_matmul":
            return spec.k * BYTES_PER_ELEM
        if spec.kernel == "int8_gemm":
            return float(spec.k)
        return 4.0 * spec.k

    def _plan_counts(self, ospec: OffsetSpec) -> np.ndarray:
        """Snapshot planner: per-core counts from the current ratio state,
        through the dispatcher's cached Balancers."""
        spec = self._by_name[ospec.name]
        kspec = self._kernel_spec(spec, m=1)  # work model irrelevant to plan
        if self._topo:
            topo = self.dispatcher
            outer = topo._balancer(kspec).plan(spec.n).counts
            parts = [topo.socket_dispatchers[s]._balancer(kspec)
                     .plan(int(c)).counts
                     for s, c in enumerate(outer)]
            return np.concatenate(parts)
        flat = self.dispatcher.flat if self._oblivious else self.dispatcher
        return flat._balancer(kspec).plan(spec.n).counts

    def refresh(self) -> Dict[str, torch.Tensor]:
        """Re-plan every registered call site from the current ratio
        tables; returns the device offset snapshot, rewritten in place
        (pass it into the next step)."""
        return self.snapshot.refresh()

    # ----------------------------------------------------------- cost tape --
    def tape_begin(self) -> list:
        """Open the cost tape (call at the top of a step).  Every compiled
        projection until :meth:`tape_end` appends its per-core shard sizes,
        computed afresh in this step."""
        self._sizes.clear()
        self._tape = []
        return self._tape

    def tape_end(self, tape: list) -> list:
        """Close the tape and return its records; hand them to
        :meth:`feedback` after the step."""
        if tape is not self._tape:
            raise RuntimeError("mismatched compiled cost tape")
        self._tape = None
        return list(tape)

    def _shard_sizes(self, bounds: torch.Tensor) -> torch.Tensor:
        hit = self._sizes.get(id(bounds))
        if hit is None or hit[0] is not bounds:
            hit = (bounds, bounds[1:] - bounds[:-1])
            self._sizes[id(bounds)] = hit
        return hit[1]

    def _record(self, spec: CompiledSpec, m: int, offsets) -> None:
        if self._tape is None:
            return
        src = offsets if offsets is not None else self.snapshot.device()
        self._tape.append({"spec": spec.spec_id, "m": m,
                           "sizes": self._shard_sizes(src[spec.name])})

    # ------------------------------------------------------------- kernels --
    def apply(self, layer, x: torch.Tensor, *, isa: str, kind: str,
              offsets=None, plain: bool = False,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """One compiled balanced projection ``y = x @ W.T``: the layer's
        kernel runs as one launch over the whole output; the per-core
        boundaries from ``offsets`` (or the snapshot's current device
        tensors) go to the cost tape.  A Q4 product of bf16 x takes x as it
        is (the tensor-core body) and writes y in ``out_dtype`` (x's dtype
        when None; float32 keeps the f32 sums, as the LM head's logits);
        every other product runs in f32, cast to ``out_dtype``.
        ``plain=True`` runs the kernel's plain torch version instead, on
        any device (the reference path that tests and the chip smoke
        compare against); the fp32 product has no kernel and is the same
        either way."""
        spec = self.spec_for(layer, isa, kind)
        dtype = out_dtype or x.dtype
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if spec.kernel != "q4_matmul" or x2.dtype != torch.bfloat16:
            x2 = x2.to(torch.float32)
        if spec.kernel == "q4_matmul":
            y = self._q4(x2, layer.qw, spec, plain, dtype)
        elif spec.kernel == "int8_gemm":
            y = ops.int8_linear(quantize_u8_dynamic(x2), layer.w,
                                plain=plain)
        else:
            y = ops.f32_matmul(x2, layer.w)
        self._record(spec, int(x2.shape[0]), offsets)
        return y.to(dtype).reshape(*lead, -1)

    def _q4(self, x: torch.Tensor, qw: QuantizedLinear, spec: CompiledSpec,
            plain: bool, dtype: torch.dtype) -> torch.Tensor:
        """The Q4 product of f32 or bf16 x; bf16 x gives f32 y where
        ``dtype`` is float32, else y in x's dtype."""
        bk = q4_blocks(spec.k)[2]
        f32_y = x.dtype == torch.bfloat16 and dtype == torch.float32
        if plain:
            return q4_matmul_plain(x, qw, bk, torch.float32 if f32_y else None)
        out = (torch.empty((x.shape[0], spec.n), dtype=torch.float32,
                           device=x.device) if f32_y else None)
        if not self.double_buffer:
            return ops.q4_matmul(x, qw, blocks=q4_blocks(spec.k), out=out)
        return q4_matmul_db(x, qw, bk, out=out)

    # ------------------------------------------------------------ feedback --
    def feedback(self, records, update: bool = True) -> Dict[str, torch.Tensor]:
        """Replay one step's recorded regions through the dispatcher's
        virtual pools — per-shard modelled times feed the Eq. 2 EMA
        updates, bytes/busy accounting accrues — then refresh the offset
        snapshot for the next step.  The records' device shard sizes are
        copied to the host in one transfer.  Wall spans: ``feedback.fetch``
        (that copy), ``feedback.replay`` (with a topology, its
        ``inner_ms`` per-socket replays and ``outer_ms`` rest), then the
        refresh's."""
        records = list(records)
        if not records:
            return self.refresh()
        w = _ev.WALL
        sp = w and w.begin("feedback.fetch")
        sizes = torch.stack([torch.as_tensor(r["sizes"])
                             for r in records]).cpu().numpy()
        if sp:
            w.end(sp)
            sp = w.begin("feedback.replay", records=len(records))
            t0, self._inner_ns = w.now(), 0
        for rec, counts in zip(records, sizes.astype(np.int64)):
            spec = self._specs[int(rec["spec"])]
            m = int(rec["m"])
            if int(counts.sum()) != spec.n:
                raise ValueError(
                    f"device shard sizes for {spec.name!r} cover "
                    f"{int(counts.sum())} rows, expected {spec.n}")
            if self._topo:
                self._replay_topology(spec, m, counts, update)
            else:
                self._replay_flat(spec, m, counts, update)
        if sp:
            if self._topo:
                inner = self._inner_ns * 1e-6
                w.end(sp, inner_ms=inner,
                      outer_ms=(w.now() - t0) * 1e-6 - inner)
            else:
                w.end(sp)
        return self.refresh()

    def _replay_flat(self, spec: CompiledSpec, m: int, counts: np.ndarray,
                     update: bool) -> None:
        kspec = self._kernel_spec(spec, m)
        plan = Plan(counts=counts, key=kspec.table_key,
                    granularity=spec.granularity)
        if self._oblivious:
            topo = self.dispatcher
            st = topo.flat.dispatch(
                kspec, spec.n, None,
                bytes_per_unit=self._bytes_per_unit(spec),
                work_scale=topo._oblivious_scale(spec.isa),
                update=update, plan=plan)
            if topo.keep_stats:
                topo.stats.append(st)
            return
        disp = self.dispatcher
        # a dispatcher without a time model has nothing to replay against:
        # keep the accounting, skip the updates
        model_ok = disp.machine is not None
        disp.dispatch(kspec, spec.n, None,
                      bytes_per_unit=self._bytes_per_unit(spec),
                      update=update and model_ok, plan=plan)

    def _replay_topology(self, spec: CompiledSpec, m: int,
                         counts: np.ndarray, update: bool) -> None:
        """Two-level replay: the inner per-core regions, one per socket
        (each socket's pool advances by its own makespan), then the outer
        socket-level report with ``units=`` feedback — mirroring
        ``TopologyDispatcher._split`` for a plan fixed by the snapshot.
        ``counts`` holds one entry per core of the machine, socket after
        socket."""
        topo = self.dispatcher
        kspec = self._kernel_spec(spec, m)
        bpu = self._bytes_per_unit(spec)
        parts = np.split(counts, np.cumsum(self._socket_cores)[:-1])
        socket_counts = np.array([int(p.sum()) for p in parts],
                                 dtype=np.int64)
        placement = topo.placement_for(self._weights.get(spec.spec_id),
                                       spec.n)
        times = np.zeros(topo.n_sockets)
        w = _ev.WALL
        t0 = w and w.now()
        lo = 0
        for s, c in enumerate(socket_counts):
            hi = lo + int(c)
            if c > 0:
                scale = topo._work_scale(spec.isa, s, (lo, hi), placement)
                st = topo.socket_dispatchers[s].dispatch(
                    kspec, int(c), None, bytes_per_unit=bpu,
                    work_scale=scale, update=update,
                    plan=Plan(counts=parts[s], key=kspec.table_key,
                              granularity=spec.granularity))
                times[s] = st.makespan
            lo = hi
        if w is not None:
            self._inner_ns += w.now() - t0
        bal = topo._balancer(kspec)
        plan = Plan(counts=socket_counts, key=kspec.table_key,
                    granularity=spec.granularity)
        moved = float(spec.n) * bpu
        st = bal.report(plan, times, update=update and topo.dynamic,
                        label=f"{kspec.name}@{kspec.table_key}",
                        bytes_moved=moved)
        if moved > 0 and st.makespan > 0:
            topo._account(spec.isa, moved, st.makespan)
        if topo.keep_stats:
            topo.stats.append(st)
