"""Step auditor: the host-sync and region contracts of the decode step.

The port's counterpart of ``repro.analysis.jaxpr_audit``.  The reference
audits a jaxpr, the traced program of its jitted step; PyTorch runs
eagerly and has no jaxpr, so the port records what the step does instead
(hence the new name): every ATen operator the step dispatches, through a
``TorchDispatchMode`` over one call (:func:`record_step`, the
counterpart of ``jax.make_jaxpr`` walked by ``iter_eqns``; it sees the
operators inside every function the step calls, as ``iter_eqns`` walks
sub-jaxprs), and every balanced region an eager step opens
(:func:`record_regions`).  The rule IDs stay the reference's, so findings
line up:

* **JA001** — a compiled step (the one the engine captures as a CUDA
  graph) contains **no host synchronization**: no
  ``aten._local_scalar_dense`` (``.item()``, ``int()``/``bool()`` of a
  tensor), no operator whose output size depends on the data
  (``nonzero``, ``masked_select``, ``unique``...), no comparison answered
  on the host (``equal``, ``is_nonzero``) and no copy from a device to
  the host.  On the card the step also runs under
  ``torch.cuda.set_sync_debug_mode("error")``, which turns every
  synchronizing CUDA call — ``.tolist()`` and ``.numpy()`` copies, which
  dispatch no operator on the CPU, and a host function called inside the
  step (the reference's Python callback) among them — into an error.
* **JA002** — :class:`~repro_torch.runtime.OffsetSnapshot` boundary
  tensors entering a compiled step reach **only** slicing, index
  arithmetic and the cost tape's ``bounds[1:] - bounds[:-1]``
  (:data:`ALLOWED_OFFSET_OPS`, the counterpart of the reference's
  ``_ALLOWED_OFFSET_PRIMS``), by taint over the recorded operators: an
  offset-derived value flowing into anything else means the step's
  output depends on balance state in a way feedback replay cannot
  account for.
* **JA003** — an **eager** step opens exactly the expected number of
  balanced regions: one per banked projection of every layer, plus the
  head.  The port's eager mode is what the reference's bridge was (each
  projection planned, run as per-core shards and fed back when it is
  called), and a region is what a bridge callback was.
* **JA004** — those regions reach the ratio table in the forward's
  program order: each region over the projection the model's program
  runs next, its observation the next one the table receives.  The
  reference guarded against callbacks being reordered; here regions
  reordered would break the measure → EMA → split sequence the same way.
"""

from __future__ import annotations

import functools
import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .findings import Finding

__all__ = [
    "RULES",
    "ALLOWED_OFFSET_OPS",
    "SYNC_OPS",
    "RecordedStep",
    "record_step",
    "audit_compiled",
    "Regions",
    "record_regions",
    "expected_regions",
    "audit_eager",
    "run_pass",
]

RULES = {
    "JA001": "host synchronization inside a compiled (captured) step",
    "JA002": "offset boundary tensor consumed by a non-slice operator "
             "inside a compiled step",
    "JA003": "eager step region count differs from the per-layer contract",
    "JA004": "eager step regions out of the forward's program order",
}

# ATen operators an offset boundary tensor may flow through inside a
# compiled step: slicing and views, the cost-tape arithmetic
# (bounds[1:] - bounds[:-1]), casts and copies, index clamping and
# comparisons.
ALLOWED_OFFSET_OPS = frozenset({
    "slice", "select", "narrow", "index_select", "gather", "squeeze",
    "unsqueeze", "view", "reshape", "_unsafe_view", "expand", "alias",
    "t", "transpose", "permute", "contiguous", "clone", "detach",
    "lift_fresh", "_to_copy", "copy", "copy_", "cat", "stack",
    "sub", "rsub", "add", "neg",
    "lt", "le", "gt", "ge", "eq", "ne", "where", "maximum", "minimum",
    "max", "min", "clamp", "clamp_min", "clamp_max",
})

# operators that make the host wait for the device: a scalar read, an
# output sized by the data, a comparison answered on the host
SYNC_OPS = frozenset({
    "_local_scalar_dense", "item", "is_nonzero", "equal", "allclose",
    "nonzero", "nonzero_static", "masked_select", "unique", "_unique",
    "_unique2", "unique_dim", "unique_consecutive", "repeat_interleave",
})


# -------------------------------------------------------- op recording --
def _tensors(tree) -> list:
    import torch

    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


@dataclass
class RecordedStep:
    """What one call of a step dispatched: every operator's name in order,
    the host-synchronizing ones, and the operators an offset reached that
    :data:`ALLOWED_OFFSET_OPS` does not hold."""

    ops: List[str] = field(default_factory=list)
    syncs: List[str] = field(default_factory=list)
    offset_sinks: Dict[str, int] = field(default_factory=dict)
    label: str = "step"


@functools.cache
def _recorder_class():
    """The ``TorchDispatchMode`` behind :func:`record_step` (made on first
    use, so importing this module imports no torch)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Mode(TorchDispatchMode):
        def __init__(self, rec: RecordedStep, tainted):
            super().__init__()
            self.rec = rec
            self._taint: Dict[int, weakref.ref] = {}
            for t in tainted:
                self._mark(t)

        def _mark(self, t) -> None:
            self._taint[id(t)] = weakref.ref(t)

        def _is_tainted(self, t) -> bool:
            ref = self._taint.get(id(t))
            return ref is not None and ref() is t

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = func.overloadpacket.__name__
            rec = self.rec
            rec.ops.append(name)
            ins = _tensors((args, kwargs))
            outs = _tensors(out)
            if name in SYNC_OPS:
                rec.syncs.append(name)
            elif any(i.device.type != "cpu" for i in ins) and \
                    any(o.device.type == "cpu" for o in outs):
                rec.syncs.append(f"{name} (device to host)")
            if any(self._is_tainted(t) for t in ins):
                if name in ALLOWED_OFFSET_OPS:
                    for o in outs:
                        self._mark(o)
                else:
                    rec.offset_sinks[name] = rec.offset_sinks.get(name, 0) + 1
            return out

    return _Mode


def record_step(fn: Callable, *args, offsets: Sequence = (),
                label: str = "step", **kwargs) -> Tuple[object, RecordedStep]:
    """Call ``fn(*args, **kwargs)`` under the recording mode, the tensors
    of ``offsets`` tainted; returns its result and the
    :class:`RecordedStep`."""
    rec = RecordedStep(label=label)
    with _recorder_class()(rec, _tensors(list(offsets))):
        out = fn(*args, **kwargs)
    return out, rec


def audit_compiled(rec: RecordedStep, *,
                   where: Optional[str] = None) -> List[Finding]:
    """JA001 + JA002 over a recorded compiled step."""
    where = where or rec.label
    findings: List[Finding] = []
    counts: Dict[str, int] = {}
    for name in rec.syncs:
        counts[name] = counts.get(name, 0) + 1
    for name, n in sorted(counts.items()):
        findings.append(Finding(
            rule="JA001", severity="error", location=f"step:{where}",
            message=f"compiled step makes {n} {name} call(s); the "
                    f"no-host-sync contract of a captured step is broken"))
    for name in sorted(rec.offset_sinks):
        findings.append(Finding(
            rule="JA002", severity="error", location=f"step:{where}",
            message=f"offset boundary tensor flows into {name!r}; offsets "
                    f"may only be consumed via slicing and index "
                    f"arithmetic (the cost-tape pattern)"))
    return findings


@contextmanager
def sync_debug_errors():
    """``torch.cuda.set_sync_debug_mode("error")`` for the block: every
    synchronizing CUDA call inside raises."""
    import torch

    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def audit_sync_debug(fn: Callable, *, where: str) -> List[Finding]:
    """JA001 on the card: ``fn()`` under sync debug mode "error"; a
    synchronizing call is a finding (with its message)."""
    try:
        with sync_debug_errors():
            fn()
    except RuntimeError as e:
        return [Finding(rule="JA001", severity="error",
                        location=f"step:{where}",
                        message=f"synchronizing CUDA call under sync debug "
                                f"mode: {str(e).splitlines()[0]}")]
    return []


# ----------------------------------------------------------- regions --
@dataclass
class Regions:
    """The balanced regions an eager step opened, in order, each as
    ``(table key, id of the weight it ran)``, and the keys the ratio
    table received observations for, in order."""

    regions: List[Tuple[str, int]] = field(default_factory=list)
    observed: List[str] = field(default_factory=list)


def _weight_of(layer) -> object:
    """The tensor a balanced linear's shards read (Q4, int8 or fp32)."""
    if hasattr(layer, "qw"):
        return layer.qw.packed
    w = layer.w
    return getattr(w, "q", w)


@contextmanager
def record_regions(dispatcher):
    """Record every region ``dispatcher`` (flat) opens inside the block,
    with the weight it ran, and every observation its ratio table gets.
    Yields the :class:`Regions`; the dispatcher is restored after."""
    got = Regions()
    current: List[int] = [0]
    names = ("q4_matmul", "int8_gemm", "f32_matmul")
    saved = {n: getattr(dispatcher, n) for n in names + ("dispatch",)}
    table, observe = dispatcher.table, dispatcher.table.observe

    def wrap_kernel(name):
        inner = saved[name]

        def run(x, w, *a, **k):
            current[0] = id(w.packed if name == "q4_matmul" else w)
            return inner(x, w, *a, **k)
        return run

    def dispatch(spec, *a, **k):
        got.regions.append((spec.table_key, current[0]))
        return saved["dispatch"](spec, *a, **k)

    def observed(key, *a, **k):
        got.observed.append(key)
        return observe(key, *a, **k)

    for n in names:
        setattr(dispatcher, n, wrap_kernel(n))
    dispatcher.dispatch = dispatch
    table.observe = observed
    try:
        yield got
    finally:
        for n in saved:
            delattr(dispatcher, n)
        del table.observe


# the order the model's program runs each banked group's projections
# (models/attention.py, models/layers.py mlp_fwd)
PROGRAM_ORDER = {"attn": ("wq", "wk", "wv", "wo"),
                 ("ffn", "swiglu"): ("wg", "wi", "wo"),
                 ("ffn", "gelu"): ("wi", "wo")}


def expected_regions(trunk, isa: str, *,
                     head: bool = True) -> List[Tuple[str, int]]:
    """The regions one eager step of ``trunk`` must open, in the forward's
    program order: every banked projection of every layer, then the
    head."""
    from repro_torch.kernels.dispatch import kernel_key
    from repro_torch.models.balanced import _KIND

    cfg = trunk.cfg
    period = len(cfg.period())
    out: List[Tuple[str, int]] = []
    for i, (mixer, ffn) in enumerate(cfg.layer_plan()):
        j, rep = i % period, i // period
        groups = []
        if mixer == "attn":
            groups.append(("attn", PROGRAM_ORDER["attn"]))
        if ffn == "dense":
            groups.append(("ffn", PROGRAM_ORDER[("ffn", cfg.mlp)]))
        for group, names in groups:
            for name in names:
                layers = trunk.bank.get((j, group, name))
                if layers is not None:
                    out.append((kernel_key(isa, _KIND[(group, name)]),
                                id(_weight_of(layers[rep]))))
    if head and trunk.head is not None:
        out.append((kernel_key(isa, "head"), id(_weight_of(trunk.head))))
    return out


def audit_eager(got: Regions, expected: List[Tuple[str, int]], *,
                where: str = "eager step") -> List[Finding]:
    """JA003 (the region count) + JA004 (program order, and each region's
    observation reaching the table in the same order)."""
    findings: List[Finding] = []
    if len(got.regions) != len(expected):
        findings.append(Finding(
            rule="JA003", severity="error", location=f"step:{where}",
            message=f"eager step opened {len(got.regions)} balanced "
                    f"region(s), expected {len(expected)} (one per banked "
                    f"projection of every layer, plus the head)"))
        return findings
    for n, (have, want) in enumerate(zip(got.regions, expected)):
        if have != want:
            findings.append(Finding(
                rule="JA004", severity="error", location=f"step:{where}",
                message=f"region {n} runs {have[0]} on another weight than "
                        f"the forward's program order puts there "
                        f"({want[0]}); regions were reordered"))
            break
    keys = [k for k, _ in got.regions]
    if got.observed != keys:
        findings.append(Finding(
            rule="JA004", severity="error", location=f"step:{where}",
            message=f"the ratio table received {len(got.observed)} "
                    f"observation(s) in another order than the regions "
                    f"ran ({len(keys)})"))
    return findings


# -------------------------------------------------------- the steps --
def _decode_inputs(cfg, batch: int, max_seq: int, device):
    import torch

    from repro_torch.models import init_state

    state = init_state(cfg, batch, max_seq, device=device)
    tok = torch.zeros((batch, 1), dtype=torch.int32, device=device)
    pos = torch.zeros((batch,), dtype=torch.int32, device=device)
    return tok, pos, state


def compiled_step(cfg, params, trunk, *, isa: str = "membw",
                  batch: int = 1, max_seq: int = 8, device="cpu"):
    """One compiled decode step exactly as the engine runs it (trunk
    projections, the head, the cost tape) as ``(step, offsets)``:
    ``step(offsets)`` runs it on fresh inputs."""
    from repro_torch.models import forward

    tok, pos, state = _decode_inputs(cfg, batch, max_seq, device)
    offsets = trunk.compiled_refresh()

    def step(offs):
        tape = trunk.compiled_tape_begin()
        out = forward(cfg, params, tok, state=state, pos_offset=pos,
                      apply_head=False, trunk=trunk, trunk_isa=isa,
                      trunk_offsets=offs)
        logits = trunk.apply_head(out.logits[:, -1, :], isa=isa,
                                  offsets=offs)
        return logits, trunk.compiled_tape_end(tape)

    return step, offsets


def eager_step(cfg, params, trunk, *, isa: str = "membw", batch: int = 1,
               max_seq: int = 8, device="cpu") -> Callable:
    """One eager decode step: the trunk's projections as balanced regions,
    then its head over the last position."""
    from repro_torch.models import forward

    tok, pos, state = _decode_inputs(cfg, batch, max_seq, device)

    def step():
        out = forward(cfg, params, tok, state=state, pos_offset=pos,
                      apply_head=False, trunk=trunk, trunk_isa=isa)
        return trunk.apply_head(out.logits[:, -1, :], isa=isa)

    return step


def _captured_llama_step(log, findings: List[Finding]) -> None:
    """JA001 on the card at full width: llama2-7b's compiled Q4 decode
    step (32 layers, bf16, random weights from seed 0, 4 slots), run
    uncaptured once and replayed from its CUDA graph once under sync debug
    mode "error"."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.dispatch import HybridKernelDispatcher
    from repro_torch.models import BalancedTrunk, init_params
    from repro_torch.serving.step_graph import StepGraph

    cfg = get_config("llama2-7b")
    dev = torch.device("cuda")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    disp = HybridKernelDispatcher.virtual("ultra-125h", keep_stats=False)
    trunk = BalancedTrunk.from_params(cfg, params, disp, quant="q4",
                                      device=dev)
    step, offsets = compiled_step(cfg, params, trunk, batch=4, max_seq=64,
                                  device=dev)
    step(offsets)                 # first use: workspaces, kernel builds
    torch.cuda.synchronize()
    graph = StepGraph(lambda t: step(offsets),
                      [torch.zeros(1, dtype=torch.int32, device=dev)])
    graph(0)                      # warm-up and capture
    torch.cuda.synchronize()
    where = "llama2-7b captured decode step (full width, card)"
    got = audit_sync_debug(lambda: step(offsets), where=where + ", body")
    got += audit_sync_debug(graph.graph.replay, where=where + ", replay")
    torch.cuda.synchronize()
    findings.extend(got)
    log(f"audit: {where}: sync debug mode 'error', body and replay, "
        f"{len(got)} finding(s)")
    del graph, trunk, params
    torch.cuda.empty_cache()


def run_pass(log=None, device: str = "cpu") -> List[Finding]:
    """Audit reduced granite-8b as the reference's pass does: the whole
    compiled step, each projection kind and the head standalone (JA001,
    JA002), then the eager trunk with ``pin_q4_blocks=True`` (JA003,
    JA004).  On ``device="cuda"`` the compiled step also runs under sync
    debug mode, and llama2-7b's captured step at full width after it.
    Used by ``python -m repro_torch.analysis audit``."""
    import numpy as np
    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.kernels.dispatch import GEMV_ISA, HybridKernelDispatcher
    from repro_torch.models import BalancedTrunk, init_params

    log = log or (lambda s: None)
    findings: List[Finding] = []
    dev = torch.device(device)
    cfg = reduced_config("granite-8b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    disp = HybridKernelDispatcher.virtual("ultra-125h", execute=True)
    try:
        compiled = BalancedTrunk.from_params(cfg, params, disp, quant="q4",
                                             mode="compiled", device=dev)
        step, offsets = compiled_step(cfg, params, compiled, isa=GEMV_ISA,
                                      device=dev)
        offs = list(offsets.values())
        _, rec = record_step(step, offsets, offsets=offs,
                             label="compiled decode step")
        got = audit_compiled(rec)
        if dev.type == "cuda":
            got += audit_sync_debug(lambda: step(offsets),
                                    where="compiled decode step (card)")
        findings.extend(got)
        log(f"audit: compiled decode step: {len(rec.ops)} operator(s), "
            f"{len(rec.syncs)} host sync(s), {len(got)} finding(s)")

        # each projection kind + head, recorded standalone
        rng = np.random.default_rng(0)
        x_d = torch.from_numpy(rng.standard_normal(
            (2, cfg.d_model)).astype(np.float32)).to(dev)
        x_ff = torch.from_numpy(rng.standard_normal(
            (2, cfg.d_ff)).astype(np.float32)).to(dev)
        sites = [(g, n) for (j, g, n) in sorted(compiled.bank) if j == 0]
        for group, name in sites:
            proj = compiled.projector(0, 0, group, GEMV_ISA, offsets=offsets)
            xin = x_ff if (group, name) == ("ffn", "wo") else x_d
            _, rec = record_step(proj, name, xin, None, offsets=offs,
                                 label=f"compiled {group}.{name}")
            got = audit_compiled(rec)
            findings.extend(got)
            log(f"audit: compiled {group}.{name}: {len(rec.ops)} "
                f"operator(s), {len(got)} finding(s)")
        _, rec = record_step(compiled.apply_head, x_d, isa=GEMV_ISA,
                             offsets=offs, label="compiled head")
        got = audit_compiled(rec)
        findings.extend(got)
        log(f"audit: compiled head: {len(rec.ops)} operator(s), "
            f"{len(got)} finding(s)")

        eager = BalancedTrunk.from_params(cfg, params, disp, quant="q4",
                                          mode="eager", pin_q4_blocks=True,
                                          device=dev)
        step = eager_step(cfg, params, eager, isa=GEMV_ISA, device=dev)
        with record_regions(disp) as regions:
            step()
        want = expected_regions(eager, GEMV_ISA)
        got = audit_eager(regions, want, where="eager decode step")
        findings.extend(got)
        log(f"audit: eager decode step (pin_q4_blocks=True): "
            f"{len(regions.regions)} region(s), expected {len(want)}, "
            f"{len(got)} finding(s)")
    finally:
        disp.close()
    if dev.type == "cuda":
        del params, compiled, eager
        torch.cuda.empty_cache()
        _captured_llama_step(log, findings)
    return findings
