"""Happens-before race detection over replayed worker-pool schedules.

The port's copy of ``repro.analysis.races``.  The measure→EMA→split loop
is full of shared mutable state — the
:class:`~repro_torch.core.tuner.KernelTuner` variant tables,
:class:`~repro_torch.runtime.table.RatioTable` EMA vectors, dispatcher
bytes/busy accounting — touched from worker-pool sub-tasks and from the
main task between regions.  This pass checks the synchronization
discipline mechanically.

How it works:

1. The pools and shared state emit :class:`~repro_torch.core.events.Event`s
   when a tracer is installed (see :mod:`repro_torch.core.events`): ``fork``/``join`` for
   pool sub-tasks, ``acquire``/``release`` for locks, ``read``/``write`` for
   state accesses.
2. :func:`find_races` replays the recorded schedule through a vector-clock
   happens-before checker.  Two accesses to the same ``(obj, field)``
   conflict when they come from different logical tasks, at least one is a
   write, and neither happens-before the other through fork/join or lock
   edges — rule **RC001**.

Because logical tasks are pool sub-tasks (not OS threads), the checker is
*predictive*: a :class:`~repro_torch.core.pool.VirtualWorkerPool` executes its
sub-tasks sequentially, but an unsynchronized access pattern between two
sub-tasks of one region is flagged anyway — the schedule that loses the
update merely hasn't happened yet.  This is the property that lets the CLI
vet threaded execution plans without ever racing for real.  The
threaded schedules run for real too: on the card (``device="cuda"``)
their shards launch the CUDA kernels from the workers' own streams.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, List, Tuple

from repro_torch.core import events as ev
from .findings import Finding

__all__ = ["RULES", "Recorder", "trace", "find_races", "run_pass"]

RULES = {
    "RC001": "conflicting unsynchronized accesses (write involved) to "
             "shared mutable state from concurrent logical tasks",
}


class Recorder:
    """Thread-safe event sink; install via :func:`trace`."""

    def __init__(self):
        self.events: List[ev.Event] = []
        self._lock = threading.Lock()

    def emit(self, event: ev.Event) -> None:
        with self._lock:
            self.events.append(event)


@contextmanager
def trace():
    """Record all access events emitted within the block."""
    rec = Recorder()
    prev = ev.install(rec)
    try:
        yield rec
    finally:
        ev.install(prev)


# ------------------------------------------------------------- the checker --
class _Clock(dict):
    """Sparse vector clock: task -> count."""

    def merge(self, other: Dict[str, int]) -> None:
        for task, n in other.items():
            if n > self.get(task, 0):
                self[task] = n


def find_races(events, *, max_findings: int = 25) -> List[Finding]:
    """Run the vector-clock happens-before check over a recorded schedule."""
    clocks: Dict[str, _Clock] = {}
    lock_clocks: Dict[str, _Clock] = {}
    # (obj, field) -> list of (kind, task, clock-snapshot, where); pruned to
    # the latest access per (task, kind) — sound because a task's own clock
    # only grows, so its latest access is the hardest to order against.
    accesses: Dict[Tuple[str, str], Dict[Tuple[str, str], tuple]] = {}
    findings: List[Finding] = []
    seen = set()

    def clock(task: str) -> _Clock:
        c = clocks.get(task)
        if c is None:
            c = _Clock({task: 0})
            clocks[task] = c
        return c

    for e in events:
        c = clock(e.task)
        c[e.task] = c.get(e.task, 0) + 1
        if e.kind == "fork":
            child = clock(e.obj)
            child.merge(c)
        elif e.kind == "join":
            c.merge(clock(e.obj))
        elif e.kind == "acquire":
            held = lock_clocks.get(e.obj)
            if held is not None:
                c.merge(held)
        elif e.kind == "release":
            held = lock_clocks.setdefault(e.obj, _Clock())
            held.merge(c)
        elif e.kind in ("read", "write"):
            site = accesses.setdefault((e.obj, e.field), {})
            snap = dict(c)
            for (other_task, other_kind), (o_clock, o_where) in site.items():
                if other_task == e.task:
                    continue
                if e.kind == "read" and other_kind == "read":
                    continue
                if o_clock.get(other_task, 0) <= c.get(other_task, 0):
                    continue  # ordered: prior access happens-before this one
                dedup = (e.obj, e.field, other_kind, e.kind,
                         o_where, e.where)
                if dedup in seen:
                    continue
                seen.add(dedup)
                findings.append(Finding(
                    rule="RC001", severity="error",
                    location=f"trace:{e.obj}.{e.field}",
                    message=(f"unsynchronized {other_kind} at "
                             f"{o_where or other_task} conflicts with "
                             f"{e.kind} at {e.where or e.task} "
                             f"(tasks {other_task} vs {e.task})")))
                if len(findings) >= max_findings:
                    return findings
            site[(e.task, e.kind)] = (snap, e.where)
    return findings


# --------------------------------------------------------------- CLI pass --
def run_pass(log=None, device: str = "cpu") -> List[Finding]:
    """Replay representative schedules of the real stack under the tracer
    and check them, the kernels' shards on ``device``.  Used by ``python
    -m repro_torch.analysis races``."""
    import numpy as np
    import torch

    log = log or (lambda s: None)
    findings: List[Finding] = []

    def _run(name: str, fn) -> None:
        with trace() as rec:
            fn()
        found = find_races(rec.events)
        for f in found:
            findings.append(Finding(
                rule=f.rule, severity=f.severity,
                location=f"{f.location} [{name}]", message=f.message))
        log(f"races: {name}: {len(rec.events)} events, "
            f"{len(found)} race(s)")

    def _q4_inputs(seed: int):
        from repro_torch.quant.q4 import quantize_q4_0
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(rng.normal(size=(1, 64)).astype(np.float32))
        qw = quantize_q4_0(torch.from_numpy(
            rng.normal(size=(96, 64)).astype(np.float32)).to(device))
        return x.to(device), qw

    def _virtual_q4():
        from repro_torch.kernels.dispatch import HybridKernelDispatcher
        d = HybridKernelDispatcher.virtual("ultra-125h", execute=True)
        try:
            x, qw = _q4_inputs(0)
            for _ in range(2):
                d.q4_matmul(x, qw)
        finally:
            d.close()

    def _threaded_f32():
        from repro_torch.kernels.dispatch import HybridKernelDispatcher
        d = HybridKernelDispatcher.threaded(2)
        try:
            rng = np.random.default_rng(1)
            x = torch.from_numpy(rng.normal(size=(2, 32)).astype(np.float32))
            w = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32))
            for _ in range(2):
                d.f32_matmul(x.to(device), w.to(device))
        finally:
            d.close()

    def _threaded_q4():
        # the workers select and report launch variants in one tuner
        from repro_torch.kernels.dispatch import HybridKernelDispatcher
        d = HybridKernelDispatcher.threaded(4)
        try:
            x, qw = _q4_inputs(2)
            for _ in range(3):
                d.q4_matmul(x, qw)
        finally:
            d.close()

    def _threaded_accounting():
        from repro_torch.core.pool import SubTask, ThreadWorkerPool
        from repro_torch.kernels.dispatch import (GEMV_ISA,
                                                  HybridKernelDispatcher)
        d = HybridKernelDispatcher.threaded(4)
        pool = ThreadWorkerPool(4)
        try:
            subtasks = [
                SubTask(worker=w, start=w, size=1, work=1.0,
                        fn=lambda s, z: d._account(GEMV_ISA, 128.0, 1e-3))
                for w in range(4)
            ]
            pool.run(subtasks)  # lint: allow(RL003) accounting-only schedule
        finally:
            pool.close()
            d.close()

    def _two_level():
        from repro_torch.kernels.dispatch import GEMV_ISA
        from repro_torch.runtime import KernelSpec
        from repro_torch.topology.dispatch import TopologyDispatcher
        topo = TopologyDispatcher("dual-125h", execute=False)
        try:
            spec = KernelSpec(name="gemv", isa=GEMV_ISA)
            for _ in range(3):
                topo.dispatch(spec, 2048, bytes_per_unit=2048.0)
        finally:
            topo.close()

    _run("virtual q4 dispatch", _virtual_q4)
    _run("threaded f32 dispatch", _threaded_f32)
    _run("threaded q4 dispatch", _threaded_q4)
    _run("concurrent bytes/busy accounting", _threaded_accounting)
    _run("two-level topology dispatch", _two_level)
    return findings
