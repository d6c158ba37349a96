"""Access-event hooks for the happens-before race detector.

The balancing stack's correctness argument is "shared mutable state is only
touched between parallel regions (main task) or under a lock" — the class of
invariant behind the PR 3 worker-pool fixes.  This module makes that claim
machine-checkable: the worker pools and the shared state they touch
(:class:`~repro_torch.core.tuner.KernelTuner`, :class:`~repro_torch.runtime.table.
RatioTable` EMA updates, dispatcher bytes/busy accounting) emit lightweight
*access events* whenever a tracer is installed, and
:mod:`repro.analysis.races` replays the recorded schedule through a
vector-clock happens-before checker.

Cost when disabled is one global load and a ``None`` check per hook
(``TRACER`` is ``None`` by default); no event objects are built.

Event vocabulary (``kind``):

* ``read`` / ``write`` — one access to ``(obj, field)`` from the current
  logical task;
* ``acquire`` / ``release`` — lock edges (emit *after* acquiring and
  *before* releasing, inside the critical section);
* ``fork`` / ``join`` — task edges: the current task spawned / awaited the
  logical task named in ``obj``.

Logical tasks are strings, not OS threads: a :class:`~repro_torch.core.pool.
VirtualWorkerPool` runs its sub-tasks sequentially on one thread, but each
``(region, worker)`` is its own logical task with only fork/join ordering —
so the checker finds schedules the virtual execution merely *masks*
(predictive race detection over the replayed pool schedule).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass

__all__ = [
    "Event",
    "TRACER",
    "RECORDER",
    "install",
    "install_recorder",
    "current_task",
    "push_task",
    "pop_task",
    "task",
    "label",
    "emit_read",
    "emit_write",
    "emit_acquire",
    "emit_release",
    "emit_fork",
    "emit_join",
    "emit_span",
    "emit_counter",
    "emit_instant",
    "push_scope",
    "pop_scope",
    "record",
]

# The installed tracer (anything with ``emit(Event)``), or None.  Module
# global so the disabled-path check is a single load.
TRACER = None


@dataclass(frozen=True)
class Event:
    """One recorded schedule step."""

    kind: str      # "read" | "write" | "acquire" | "release" | "fork" | "join"
    task: str      # logical task the event happened on
    obj: str       # state label ("KernelTuner#1") or child-task / lock label
    field: str = ""   # field within obj for read/write ("tables['membw']")
    where: str = ""   # source label for reporting ("KernelTuner.report")


class _TaskCtx(threading.local):
    def __init__(self):
        self.stack = []


_ctx = _TaskCtx()


def current_task() -> str:
    """The current logical task: the innermost pushed label, else the OS
    thread's identity (every un-annotated thread is its own task)."""
    stack = _ctx.stack
    if stack:
        return stack[-1]
    return f"thread:{threading.current_thread().name}"


def push_task(name: str) -> None:
    _ctx.stack.append(name)


def pop_task() -> None:
    _ctx.stack.pop()


@contextmanager
def task(name: str):
    """Run a block as logical task ``name`` (pools wrap sub-task fns)."""
    push_task(name)
    try:
        yield
    finally:
        pop_task()


# ------------------------------------------------------------------ labels --
# Stable human-readable labels per traced object.  Keyed by id() — cleared on
# every install() so a recycled id cannot alias across trace sessions.
_label_by_id: dict = {}
_label_counts: dict = {}


def label(obj) -> str:
    """A stable ``ClassName#k`` label for ``obj`` within one trace."""
    if isinstance(obj, str):
        return obj
    key = id(obj)
    got = _label_by_id.get(key)
    if got is None:
        cls = type(obj).__name__
        n = _label_counts.get(cls, 0) + 1
        _label_counts[cls] = n
        got = f"{cls}#{n}"
        _label_by_id[key] = got
    return got


def install(tracer):
    """Install ``tracer`` (or ``None`` to disable); returns the previous
    tracer.  Resets the label registry so labels are per-session."""
    global TRACER
    prev = TRACER
    TRACER = tracer
    _label_by_id.clear()
    _label_counts.clear()
    return prev


# ------------------------------------------------------------------- emits --
def _emit(kind: str, obj, field: str, where: str) -> None:
    t = TRACER
    if t is None:
        return
    t.emit(Event(kind=kind, task=current_task(), obj=label(obj),
                 field=field, where=where))


def emit_read(obj, field: str, where: str = "") -> None:
    _emit("read", obj, field, where)


def emit_write(obj, field: str, where: str = "") -> None:
    _emit("write", obj, field, where)


def emit_acquire(lock, where: str = "") -> None:
    """Emit *after* physically acquiring ``lock``."""
    _emit("acquire", lock, "", where)


def emit_release(lock, where: str = "") -> None:
    """Emit *before* physically releasing ``lock``."""
    _emit("release", lock, "", where)


def emit_fork(child_task: str, where: str = "") -> None:
    """The current task is about to start ``child_task``."""
    _emit("fork", child_task, "", where)


def emit_join(child_task: str, where: str = "") -> None:
    """The current task has awaited ``child_task``'s completion."""
    _emit("join", child_task, "", where)


# ------------------------------------------------------------------- spans --
# Virtual-clock span/counter hooks for the ``repro.obs`` tracer.  The same
# TRACER slot serves both the race detector (which only implements ``emit``)
# and the span tracer: each hook duck-types on the tracer method it needs, so
# a tracer that lacks it costs one getattr and nothing else.  ``args`` and
# ``values`` may be zero-argument callables — evaluated only when a matching
# tracer is installed, so building the payload is free on the disabled path.

def emit_span(track: str, name: str, start: float, dur: float,
              cat: str = "", args=None) -> None:
    """One completed span on virtual-clock ``track`` (seconds)."""
    t = TRACER
    if t is None:
        return
    fn = getattr(t, "span", None)
    if fn is None:
        return
    if callable(args):
        args = args()
    fn(track, name, start, dur, cat, args)


def emit_counter(track: str, t_now: float, values) -> None:
    """Sampled counter values (``{series: number}``) on ``track``."""
    t = TRACER
    if t is None:
        return
    fn = getattr(t, "counter", None)
    if fn is None:
        return
    if callable(values):
        values = values()
    fn(track, t_now, values)


def emit_instant(track: str, name: str, t_now: float, args=None) -> None:
    """A zero-duration marker (routing/admission decisions)."""
    t = TRACER
    if t is None:
        return
    fn = getattr(t, "instant", None)
    if fn is None:
        return
    if callable(args):
        args = args()
    fn(track, name, t_now, args)


def push_scope(name: str) -> None:
    """Enter a naming scope (node/replica) grouping subsequent spans."""
    t = TRACER
    if t is None:
        return
    fn = getattr(t, "push_scope", None)
    if fn is not None:
        fn(name)


def pop_scope() -> None:
    t = TRACER
    if t is None:
        return
    fn = getattr(t, "pop_scope", None)
    if fn is not None:
        fn()


# ---------------------------------------------------------------- recorder --
# The flight-recorder channel is independent of the tracer: balancer
# decisions (ratio snapshots, offset refreshes, capacity/admission events)
# are recorded even when no trace is being exported, so an SLO burn or a
# tripped IV contract can dump the decisions that led up to it.
RECORDER = None


def install_recorder(recorder):
    """Install a decision recorder (anything with ``record(kind, key, t,
    payload)``), or ``None`` to disable; returns the previous recorder."""
    global RECORDER
    prev = RECORDER
    RECORDER = recorder
    return prev


def record(kind: str, key: str, t: float = 0.0, **payload) -> None:
    """Record one balancer/admission decision.  One global load + ``None``
    check when disabled; payload kwargs are only assembled by the caller, so
    keep call sites to cheap scalars."""
    r = RECORDER
    if r is None:
        return
    r.record(kind, key, t, payload)
