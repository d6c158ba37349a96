"""Roofline terms of a dry-run cell on NVIDIA H100s (the reference's
``repro.launch.roofline``, with the card's constants and a trace in place
of compiled HLO).

Three terms, in seconds, per device:

  compute    = FLOPs / PEAK_FLOPS       (989.4 TFLOP/s dense bf16)
  memory     = HBM bytes / HBM_BW       (3.35 TB/s HBM3)
  collective = the sum, over the collectives the traced step issues, of
               wire bytes over the bandwidth of the slowest link the
               collective's group crosses: NVLINK_BW (450 GB/s per
               direction) inside a node of GPUS_PER_NODE = 8 cards,
               INTER_NODE_BW (50 GB/s per card) across nodes.

Sources: NVIDIA H100 Tensor Core GPU data sheet, SXM part — 1,979 TFLOP/s
bf16 with sparsity, so 989.4 dense; 3.35 TB/s; NVLink 900 GB/s, which is
both directions of 18 NVLink 4 links, so 450 GB/s each way.  NVIDIA DGX
H100 user guide — 8 GPUs per node and, for the compute fabric, one
400 Gb/s ConnectX-7 (InfiniBand NDR) port per GPU: 50 GB/s.

A mesh's ranks are laid out row-major (``init_device_mesh`` over
``arange(world)``) and a node holds 8 consecutive ranks, so on the 16x16
mesh a ``"model"`` group of 16 spans 2 nodes and a ``"data"`` group 16.
A ring is as fast as its slowest hop, so a group charged at the node
link is every group that leaves its node.

The FLOPs and HBM bytes of the terms are :mod:`.analytic`'s (primary, as
in the reference).  Collectives come from :class:`StepRecorder`, a
``TorchDispatchMode`` that sees every collective op (functional
``_c10d_functional.*``, ``c10d.*`` and DTensor's
``_dtensor.shard_dim_alltoall``) the traced step issues, with its
output's bytes and its process group's ranks.  The reference parses
post-SPMD HLO and multiplies each ``while`` body's collectives by the
loop's trip count; the port's eager trace issues every collective of every
layer and microbatch, so there is no trip count to attribute.  Its
``wire_bytes_tpu`` and ``t_collective_tpu`` corrected an artifact of XLA's
CPU backend (bf16 dots computed in f32, their all-reduces moving f32);
the trace moves the dtypes the card would move, so neither is kept.

``hlo_flops_raw`` / ``hlo_bytes_raw`` keep their names and their place as
secondary numbers: the trace's own counts, FLOPs from ``FlopCounterMode``
(which counts DTensor ops at their global shapes, so divided by the
world) and bytes as the sum of each local operator's input and output
bytes (views excluded).
"""

from __future__ import annotations

import heapq
import math
import sys
import weakref
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# H100 SXM (per card)
PEAK_FLOPS = 989.4e12   # bf16, dense
HBM_BW = 3.35e12        # bytes/s
NVLINK_BW = 450e9       # bytes/s per direction, inside a node
INTER_NODE_BW = 50e9    # bytes/s per card across nodes (400 Gb/s NDR)
GPUS_PER_NODE = 8

# the recorder's op names -> the reference's collective kinds
_KINDS = {
    "all_gather_into_tensor": "all-gather", "_allgather_base_": "all-gather",
    "allgather_": "all-gather", "allgather_into_tensor_coalesced":
        "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    # DTensor's own op for moving a shard between dims on a CUDA mesh
    "shard_dim_alltoall": "all-to-all",
    "broadcast_": "broadcast", "broadcast": "broadcast",
}
_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d", "_dtensor")


def _wire_factor(kind: str, n: int) -> float:
    """Ring-algorithm wire bytes per device, as a multiple of the op's
    output bytes."""
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n
    if kind == "all-gather":
        return (n - 1) / n
    if kind == "reduce-scatter":
        return (n - 1)  # output is 1/n of the input that moves
    if kind == "all-to-all":
        return (n - 1) / n
    if kind == "collective-permute":
        return 1.0
    return 1.0


def link_bandwidth(ranks) -> float:
    """Bytes/s per device of the slowest link a group of global ``ranks``
    crosses: NVLink inside one node, the inter-node port otherwise."""
    nodes = {r // GPUS_PER_NODE for r in ranks}
    return NVLINK_BW if len(nodes) <= 1 else INTER_NODE_BW


@dataclass
class CollectiveStats:
    ops: dict = field(default_factory=dict)        # kind -> count
    raw_bytes: dict = field(default_factory=dict)  # kind -> output bytes
    wire_bytes: float = 0.0
    seconds: float = 0.0                           # wire over each link

    def add(self, kind: str, nbytes: int, n: int, mult: float = 1.0,
            bandwidth: float = INTER_NODE_BW) -> float:
        """Count one collective; returns its wire bytes."""
        self.ops[kind] = self.ops.get(kind, 0) + mult
        self.raw_bytes[kind] = self.raw_bytes.get(kind, 0) + nbytes * mult
        wire = nbytes * _wire_factor(kind, n) * mult
        self.wire_bytes += wire
        self.seconds += wire / bandwidth
        return wire


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _issued_at() -> str:
    """The innermost frame of the port's model or training code (where the
    collective was issued); ``"backward"`` when autograd's engine runs
    it."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename.replace("\\", "/")
        if "/repro_torch/" in name and "/repro_torch/launch/" not in name \
                and "/repro_torch/sharding/" not in name:
            short = name.split("/repro_torch/", 1)[1]
            return f"{short}:{f.f_lineno} ({f.f_code.co_name})"
        f = f.f_back
    return "backward"


class StepRecorder(TorchDispatchMode):
    """What a traced step does on one device: every collective it issues,
    the bytes its local operators read and write, and the peak of the
    bytes its live local tensors hold.

    DTensor ops are passed on to DTensor (``NotImplemented``), so the
    recorder sees the local operators and collectives they become, and
    never the global-shape ops DTensor runs under ``FakeTensorMode`` to
    propagate shapes.

    The memory count follows each storage from the operator that makes it
    to its release (a weak reference on the untyped storage), from the
    tensors registered with :meth:`hold` before the trace.  It is a lower
    bound of what a caching allocator holds: it ignores fragmentation and
    the allocator's rounding of sizes, and workspace of the library
    kernels the ops call.
    """

    def __init__(self):
        super().__init__()
        self.stats = CollectiveStats()
        # (wire, kind, group size, out bytes, where issued, out dtype+shape)
        self.records: list = []
        self.largest: list = []     # heap of (bytes, op, shape, dtype)
        self.op_bytes = 0.0
        self.live = 0
        self.peak = 0
        self._held: dict = {}
        self._groups: dict = {}

    # ------------------------------------------------------------ memory --
    def hold(self, tensors) -> None:
        """Count ``tensors`` (an iterable; DTensors by their local shard) as
        live from now until their storages are freed."""
        for t in tensors:
            local = getattr(t, "_local_tensor", t)
            self._track(local)

    def _track(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = id(st)
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._held.pop(key, 0)

    # ------------------------------------------------------- collectives --
    def _ranks(self, group) -> tuple:
        import torch.distributed as dist

        key = group if isinstance(group, str) else id(group)
        if key not in self._groups:
            if isinstance(group, str):
                from torch.distributed.distributed_c10d import \
                    _resolve_process_group
                pg = _resolve_process_group(group)
            else:
                pg = dist.ProcessGroup.unbox(group)
            self._groups[key] = tuple(dist.get_process_group_ranks(pg))
        return self._groups[key]

    def _collective(self, name: str, func, args, kwargs, out) -> None:
        schema = func._schema
        bound = dict(zip([a.name for a in schema.arguments], args))
        bound.update(kwargs)
        group = bound.get("group_name", bound.get("process_group"))
        ranks = self._ranks(group)
        if schema.name.startswith("c10d::"):
            out = args[0]  # in-place c10d ops write their first argument
        outs = list(_tensors(out))
        nbytes = sum(_nbytes(t) for t in outs)
        kind = _KINDS[name]
        n = len(ranks)
        wire = self.stats.add(kind, nbytes, n, 1.0, link_bandwidth(ranks))
        what = " ".join(f"{str(t.dtype)[6:]}{list(t.shape)}" for t in outs)
        self.records.append((wire, kind, n, nbytes, _issued_at(), what))

    # ---------------------------------------------------------- dispatch --
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out  # DTensor's shape propagation, not the step's work
        ns = func.namespace
        name = func._schema.name.split("::", 1)[1]
        if ns in _NAMESPACES and name in _KINDS:
            self._collective(name, func, args, kwargs, out)
        fresh = not func.is_view
        if fresh:
            self.op_bytes += sum(_nbytes(t) for t in _tensors(args)) + \
                sum(_nbytes(t) for t in _tensors(out))
        for t in _tensors(out):
            self._track(t)
            if fresh:
                self._note_size(func, t)
        return out

    def _note_size(self, func, t: torch.Tensor, keep: int = 64) -> None:
        item = (_nbytes(t), str(func), tuple(t.shape), str(t.dtype))
        if item in self.largest:
            return
        if len(self.largest) < keep:
            heapq.heappush(self.largest, item)
        elif item > self.largest[0]:
            heapq.heapreplace(self.largest, item)


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops: float              # analytic, per device (primary)
    hbm_bytes: float          # analytic, per device (primary)
    wire_bytes: float         # every collective the traced step issued
    per_device_output_bytes: float
    model_flops: float
    collective_ops: dict = field(default_factory=dict)
    hlo_flops_raw: float = 0.0   # the trace's counts (secondary)
    hlo_bytes_raw: float = 0.0
    # the most bytes the step's live local tensors held at once: a lower
    # bound of the allocator's peak (no fragmentation, rounding or library
    # workspace; see StepRecorder)
    peak_mem_bytes: Optional[float] = None
    # wire over each collective's link; None charges every wire byte at
    # the inter-node link, the slowest (the reference charged one ICI link)
    collective_seconds: Optional[float] = None

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        if self.collective_seconds is None:
            return self.wire_bytes / INTER_NODE_BW
        return self.collective_seconds

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / FLOPs (per device): remat/dispatch overhead."""
        if self.flops <= 0:
            return 0.0
        return self.model_flops / self.flops

    @property
    def roofline_fraction(self) -> float:
        """Achievable fraction of the compute roofline if the dominant term
        were perfectly overlapped: t_compute / t_bound."""
        if self.t_bound <= 0:
            return 0.0
        return self.t_compute / self.t_bound

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "wire_bytes": self.wire_bytes,
            "collective_ops": self.collective_ops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
            "hlo_flops_raw": self.hlo_flops_raw,
            "hlo_bytes_raw": self.hlo_bytes_raw,
            "peak_mem_bytes": self.peak_mem_bytes,
            "per_device_output_bytes": self.per_device_output_bytes,
        }


def model_flops_per_device(cfg, shape_spec, n_devices: int) -> float:
    """MODEL_FLOPS: 6*N_active*D for training, 2*N_active*D for inference
    forward (D = tokens processed), divided across devices."""
    n_active = cfg.active_param_count()
    if shape_spec.kind == "train":
        tokens = shape_spec.batch * shape_spec.seq
        total = 6.0 * n_active * tokens
    elif shape_spec.kind == "prefill":
        tokens = shape_spec.batch * shape_spec.seq
        total = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        total = 2.0 * n_active * shape_spec.batch
    return total / n_devices


def analyze(recorder: StepRecorder, trace_flops: float, *, arch: str, shape,
            mesh_dims: tuple, cfg, output_bytes: float = 0.0) -> Roofline:
    """The cell's :class:`Roofline` from a finished trace: ``trace_flops``
    is ``FlopCounterMode``'s total (global shapes)."""
    from .analytic import analyze_cell

    n_dev = math.prod(mesh_dims)
    ana = analyze_cell(cfg, shape, n_dev)
    return Roofline(
        arch=arch,
        shape=shape.name,
        mesh="x".join(str(s) for s in mesh_dims),
        flops=ana.flops,
        hbm_bytes=ana.hbm_bytes,
        wire_bytes=recorder.stats.wire_bytes,
        collective_ops=recorder.stats.ops,
        collective_seconds=recorder.stats.seconds,
        per_device_output_bytes=output_bytes,
        model_flops=model_flops_per_device(cfg, shape, n_dev),
        hlo_flops_raw=trace_flops / n_dev,
        hlo_bytes_raw=recorder.op_bytes,
        peak_mem_bytes=float(recorder.peak),
    )
