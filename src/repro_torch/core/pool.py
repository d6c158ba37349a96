"""Worker pools with per-worker execution-time recording.

The paper's CPU runtime "binds each thread to a physical core and tracks the
execution time of each thread during executing kernels".  Two pools implement
the same interface:

* :class:`ThreadWorkerPool` — real OS threads, one per (simulated) core, with
  wall-clock timing.  On this 1-core container it is functionally correct but
  cannot exhibit hybrid-CPU timing, so it is used for correctness smoke tests.
* :class:`VirtualWorkerPool` — a deterministic virtual-time model of a hybrid
  CPU (see :mod:`repro_torch.core.hybrid_sim`).  Sub-task "execution" optionally
  runs the real ``fn`` for correctness, while the reported per-worker times
  come from the core model:  ``t_i = work_i / effective_throughput_i``.

Both report times with the same shape so the scheduler/runtime code is
identical — exactly the property the paper relies on (the scheduler only ever
sees (worker, time) pairs).

A region may assign *several* sub-tasks to the same worker (chunked shard
dispatch does this); each worker runs its sub-tasks sequentially and its
reported time is the sum over them.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.core import events as _ev

__all__ = ["SubTask", "ThreadWorkerPool", "VirtualWorkerPool"]


@dataclass
class SubTask:
    """One worker's slice of a parallel region.

    ``fn(start, size)`` performs the real computation (may be ``None`` for
    purely-modelled runs); ``work`` is the abstract work volume (e.g. FLOPs
    or bytes) used by the virtual-time model.
    """

    worker: int
    start: int
    size: int
    work: float
    fn: Optional[Callable[[int, int], None]] = None


class ThreadWorkerPool:
    """One persistent thread per worker; dispatch/join per parallel region.

    Threads are persistent (created once) to mirror the paper's bound thread
    pool — creating threads per region would swamp the timings the runtime
    learns from.
    """

    def __init__(self, n_workers: int):
        self.n_workers = n_workers
        self._tasks: list[List[SubTask]] = [[] for _ in range(n_workers)]
        self._times = np.zeros(n_workers)
        self._errors: list[Optional[BaseException]] = [None] * n_workers
        self._region = 0
        self._task_labels: list[Optional[str]] = [None] * n_workers
        self._go = [threading.Event() for _ in range(n_workers)]
        self._done = [threading.Event() for _ in range(n_workers)]
        self._stop = False
        self._threads = [
            threading.Thread(target=self._loop, args=(i,), daemon=True)
            for i in range(n_workers)
        ]
        for t in self._threads:
            t.start()

    def _loop(self, i: int) -> None:
        while True:
            self._go[i].wait()
            self._go[i].clear()
            if self._stop:
                return
            t0 = time.perf_counter()
            label = self._task_labels[i]
            if label is not None:
                _ev.push_task(label)
            # A raising shard fn must not kill the worker thread: run()
            # joins on _done (a dead thread would deadlock it) and
            # re-raises the stored error on the caller's side.
            try:
                for task in self._tasks[i]:
                    if task.fn is not None and task.size > 0:
                        task.fn(task.start, task.size)
            except BaseException as e:
                self._errors[i] = e
            finally:
                self._times[i] = time.perf_counter() - t0
                if label is not None:
                    _ev.pop_task()
                self._done[i].set()

    def run(self, subtasks: Sequence[SubTask]) -> np.ndarray:
        """Execute one parallel region; returns per-worker times (seconds).

        Workers with no sub-task report time 0 (skipped by the runtime).
        A worker assigned several sub-tasks runs them back to back and
        reports the total.
        """
        self._times[:] = 0.0
        self._errors = [None] * self.n_workers
        self._tasks = [[] for _ in range(self.n_workers)]
        for st in subtasks:
            if st.size > 0:
                self._tasks[st.worker].append(st)
        active = [w for w in range(self.n_workers) if self._tasks[w]]
        tracing = _ev.TRACER is not None
        self._region += 1
        for w in active:
            if tracing:
                label = f"{_ev.label(self)}/r{self._region}/w{w}"
                self._task_labels[w] = label
                _ev.emit_fork(label, where="ThreadWorkerPool.run")
            else:
                self._task_labels[w] = None
            self._done[w].clear()
            self._go[w].set()
        for w in active:
            self._done[w].wait()
            if tracing and self._task_labels[w] is not None:
                _ev.emit_join(self._task_labels[w],
                              where="ThreadWorkerPool.run")
        errors = [e for e in self._errors if e is not None]
        if errors:
            # chain concurrent failures so none is silently discarded —
            # the traceback shows every worker's error, not just worker 0's
            for first, rest in zip(errors, errors[1:]):
                first.__cause__ = rest
            raise errors[0]
        return self._times.copy()

    def close(self) -> None:
        self._stop = True
        for e in self._go:
            e.set()
        for t in self._threads:
            t.join(timeout=1.0)


class VirtualWorkerPool:
    """Deterministic virtual-time pool backed by a hybrid-CPU model.

    ``machine`` is any object exposing
    ``task_time(worker: int, isa: str, work: float, now: float) -> float``
    (see :class:`repro_torch.core.hybrid_sim.SimulatedHybridCPU`).  The pool keeps a
    virtual clock that advances by the *makespan* of each region, exactly as a
    barrier-synchronized parallel-for would.  A worker's sub-tasks run
    sequentially, each starting at the virtual instant the previous one
    finished, so time-varying background load lands on the right sub-task.
    """

    def __init__(self, machine, isa: str = "avx2", execute: bool = False):
        self.machine = machine
        self.n_workers = machine.n_cores
        self.isa = isa
        self.execute = execute
        self.clock = 0.0
        self._region = 0

    def run(self, subtasks: Sequence[SubTask]) -> np.ndarray:
        times = np.zeros(self.n_workers)
        # Sub-tasks execute sequentially here, but each (region, worker) is
        # its own *logical* task for the race detector: fork/join are the
        # only ordering edges a real parallel pool would provide, so the
        # replayed schedule exposes synchronization bugs this virtual
        # execution merely masks.
        tracing = _ev.TRACER is not None
        forked: dict = {}
        if tracing:
            self._region += 1
        for st in subtasks:
            if st.size <= 0:
                continue
            if tracing:
                label = forked.get(st.worker)
                if label is None:
                    label = f"{_ev.label(self)}/r{self._region}/w{st.worker}"
                    forked[st.worker] = label
                    _ev.emit_fork(label, where="VirtualWorkerPool.run")
                _ev.push_task(label)
            try:
                if self.execute and st.fn is not None:
                    st.fn(st.start, st.size)
            finally:
                if tracing:
                    _ev.pop_task()
            t_start = self.clock + times[st.worker]
            dt = self.machine.task_time(st.worker, self.isa, st.work, t_start)
            times[st.worker] += dt
            if tracing:
                _ev.emit_span(
                    f"core{st.worker}", self.isa, t_start, dt, cat="pool",
                    args=lambda st=st: {"start": st.start, "size": st.size,
                                        "work": st.work})
        if tracing:
            for label in forked.values():
                _ev.emit_join(label, where="VirtualWorkerPool.run")
        self.clock += float(times.max(initial=0.0))
        return times

    def close(self) -> None:  # interface parity
        pass
