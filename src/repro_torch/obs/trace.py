# lint: virtual-clock-module
"""Chrome/Perfetto ``trace_event`` tracer on the shared virtual clock.

The tracer receives spans, counters and instants through the hooks in
:mod:`repro_torch.core.events` (``emit_span``/``emit_counter``/``emit_instant``)
and groups them into Perfetto processes and threads:

* **process** = the current *scope* — a stack pushed by :meth:`push_scope` /
  :meth:`pop_scope` from :class:`~repro_torch.fleet.cluster.Node` ("node:big") and
  :class:`~repro_torch.serving.dispatch.InflightDispatcher` ("replica0"), joined
  with "/".  Single-machine runs land in the implicit process ``"main"``.
* **thread (track)** = one core, socket, dispatch region or counter series
  within the process ("core3", "socket1", "engine", "dispatch:membw").

All timestamps are *virtual* seconds converted to microseconds at export,
so a fixed-seed run produces a byte-identical trace: virtual execution is
single-threaded, ids are assigned in first-seen order, and the JSON is
dumped with sorted keys and canonical separators.

**Wall spans.**  The same tracer, installed with
:func:`repro_torch.core.events.install_wall`, also keeps spans and counter
samples on the host's clock (:meth:`begin`/:meth:`end`, a parent stack,
:meth:`request_phase`, :meth:`sample`): where the serving engine, its
decode step and its cost-tape feedback spend their time, whether or not a
cost model drives the engine.  They are stamped in ns on the clock that
``torch.profiler`` stamps its events with (:func:`wall_ns`), so they lie
beside a profile's host ranges and device operations, and are kept in
memory (:meth:`wall_spans`) until :meth:`write` puts them in a process of
their own, ``wall``, with times from the first stamp (the trace's
``otherData.wall_origin_ns``).  A trace with no wall span is byte for byte
what it was without them.

Export with :meth:`write` and open the file at https://ui.perfetto.dev (or
``chrome://tracing``).  :func:`validate_trace` checks the schema the way the
CI smoke job does.
"""

from __future__ import annotations

import json
import time
from typing import NamedTuple, Optional

__all__ = ["SpanTracer", "WallSpan", "validate_trace", "wall_ns"]

_ALLOWED_PH = {"X", "C", "i", "M"}


def wall_ns() -> int:
    """Now, in ns on the profiler's clock: ``torch.profiler`` converts its
    host and device timestamps to Unix-epoch ns, which this reads."""
    return time.time_ns()  # lint: allow(RL001) the wall spans' own clock


class WallSpan(NamedTuple):
    """One closed wall span: ``start``/``end`` in ns on :func:`wall_ns`'s
    clock, ``parent`` the enclosing span's ``sid`` (0: none), ``request``
    the request id where one applies."""

    sid: int
    parent: int
    name: str
    start: int
    end: int
    request: Optional[int] = None
    args: Optional[dict] = None

    @property
    def ms(self) -> float:
        return (self.end - self.start) * 1e-6


def _us(t: float) -> float:
    """Virtual seconds -> trace microseconds, rounded so float noise cannot
    break byte-determinism across same-seed runs."""
    return round(float(t) * 1e6, 3)


class SpanTracer:
    """Collects trace events; install via ``repro_torch.core.events.install``.

    Also implements the race-tracer ``emit`` hook as a no-op so the access
    events the pools/dispatchers emit while a span tracer is installed are
    accepted and discarded rather than raising.
    """

    def __init__(self):
        self._scope: list[str] = []
        self._pids: dict[str, int] = {}       # proc name -> pid (first-seen)
        self._tids: dict[tuple, int] = {}     # (pid, track) -> tid
        self._events: list[dict] = []         # ph M metadata, emission order
        self._body: list[dict] = []           # ph X/C/i, emission order
        self.n_spans = 0
        self.n_counters = 0
        self.n_instants = 0
        self.wall: list[WallSpan] = []        # closed wall spans, by end
        self.samples: list[tuple] = []        # (track, ns, {series: value})
        self._wall_id = 0
        self._stack: list[int] = []           # open wall spans, innermost last
        self._open: dict = {}                 # sid -> (parent, name, ns, req, args)
        self._phases: dict = {}               # request id -> (phase, ns)

    # ------------------------------------------------------------- scoping --
    def push_scope(self, name: str) -> None:
        self._scope.append(str(name))

    def pop_scope(self) -> None:
        self._scope.pop()

    def _proc(self) -> str:
        return "/".join(self._scope) if self._scope else "main"

    def _ids(self, track: str) -> tuple[int, int]:
        proc = self._proc()
        pid = self._pids.get(proc)
        if pid is None:
            pid = len(self._pids) + 1
            self._pids[proc] = pid
            self._events.append({
                "ph": "M", "pid": pid, "tid": 0,
                "name": "process_name", "args": {"name": proc},
            })
        key = (pid, track)
        tid = self._tids.get(key)
        if tid is None:
            tid = sum(1 for k in self._tids if k[0] == pid) + 1
            self._tids[key] = tid
            self._events.append({
                "ph": "M", "pid": pid, "tid": tid,
                "name": "thread_name", "args": {"name": track},
            })
        return pid, tid

    # --------------------------------------------------------------- hooks --
    def span(self, track: str, name: str, start: float, dur: float,
             cat: str = "", args: Optional[dict] = None) -> None:
        pid, tid = self._ids(track)
        ev = {"ph": "X", "pid": pid, "tid": tid, "name": name,
              "ts": _us(start), "dur": _us(dur)}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self._body.append(ev)
        self.n_spans += 1

    def counter(self, track: str, t_now: float, values: dict) -> None:
        pid, tid = self._ids(track)
        self._body.append({
            "ph": "C", "pid": pid, "tid": tid, "name": track,
            "ts": _us(t_now),
            "args": {k: float(v) for k, v in values.items()},
        })
        self.n_counters += 1

    def instant(self, track: str, name: str, t_now: float,
                args: Optional[dict] = None) -> None:
        pid, tid = self._ids(track)
        ev = {"ph": "i", "pid": pid, "tid": tid, "name": name,
              "ts": _us(t_now), "s": "t"}
        if args:
            ev["args"] = args
        self._body.append(ev)
        self.n_instants += 1

    def emit(self, event) -> None:  # race-detector hook: accept and discard
        pass

    # ---------------------------------------------------------- wall clock --
    now = staticmethod(wall_ns)

    def begin(self, name: str, request: Optional[int] = None,
              **args) -> int:
        """Open wall span ``name`` inside the innermost open one; returns
        its id (never 0) for :meth:`end`."""
        self._wall_id += 1
        sid = self._wall_id
        stack = self._stack
        self._open[sid] = (stack[-1] if stack else 0, name, wall_ns(),
                           request, args or None)
        stack.append(sid)
        return sid

    def end(self, sid: int, **args) -> None:
        """Close span ``sid``, adding ``args`` to the ones it opened with
        (a zero-argument callable is called when the spans are read).
        Spans opened inside it and left open by an exception are dropped."""
        t = wall_ns()
        stack = self._stack
        while stack:
            top = stack.pop()
            if top == sid:
                break
            self._open.pop(top, None)
        parent, name, start, request, opened = self._open.pop(sid)
        if args:
            opened = {**opened, **args} if opened else args
        self.wall.append(WallSpan(sid, parent, name, start, t, request,
                                  opened))

    def request_phase(self, request: int, phase: Optional[str]) -> None:
        """Request ``request`` enters ``phase`` (``None``: it finished):
        its previous phase becomes a span on the request's own track."""
        t = wall_ns()
        prev = self._phases.pop(request, None)
        if prev is not None:
            self._wall_id += 1
            self.wall.append(WallSpan(self._wall_id, 0, prev[0], prev[1], t,
                                      request))
        if phase is not None:
            self._phases[request] = (phase, t)

    def sample(self, track: str, **values) -> None:
        """One sample of counter ``track`` on the wall clock."""
        self.samples.append((track, wall_ns(), values))

    def wall_spans(self) -> list[WallSpan]:
        """The closed wall spans, their deferred args resolved."""
        for i, sp in enumerate(self.wall):
            if sp.args and any(callable(v) for v in sp.args.values()):
                self.wall[i] = sp._replace(args={
                    k: v() if callable(v) else v for k, v in sp.args.items()})
        return self.wall

    def _wall_events(self) -> tuple[list, list, Optional[int]]:
        """The wall spans and samples as (metadata, body, origin ns), in a
        process of their own after the virtual ones; request phases go on
        one track per request, the lanes' spans on ``engine``."""
        spans = self.wall_spans()
        if not spans and not self.samples:
            return [], [], None
        origin = min([sp.start for sp in spans]
                     + [t for _, t, _ in self.samples])
        pid = len(self._pids) + 1
        meta = [{"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                 "args": {"name": "wall"}}]
        tids: dict = {}

        def tid(track):
            if track not in tids:
                tids[track] = len(tids) + 1
                meta.append({"ph": "M", "pid": pid, "tid": tids[track],
                             "name": "thread_name", "args": {"name": track}})
            return tids[track]

        def us(t):
            return round((t - origin) / 1e3, 3)

        body = []
        for sp in sorted(spans, key=lambda s: (s.start, s.sid)):
            args = {"id": sp.sid, "parent": sp.parent, **(sp.args or {})}
            if sp.request is not None:
                args["request"] = sp.request
            track = ("engine" if sp.parent or sp.request is None
                     else f"request {sp.request}")
            body.append({"ph": "X", "pid": pid, "tid": tid(track),
                         "name": sp.name, "ts": us(sp.start),
                         "dur": us(sp.end) - us(sp.start), "args": args})
        for track, t, values in self.samples:
            body.append({"ph": "C", "pid": pid, "tid": tid(track),
                         "name": track, "ts": us(t),
                         "args": {k: float(v) for k, v in values.items()}})
        return meta, body, origin

    # -------------------------------------------------------------- export --
    def chrome_events(self) -> list[dict]:
        """Metadata first (Perfetto names tracks before events reference
        them), then spans/counters/instants in emission order, then the
        wall spans and samples by start."""
        return self.to_chrome()["traceEvents"]

    def to_chrome(self) -> dict:
        meta, body, origin = self._wall_events()
        out = {"displayTimeUnit": "ms",
               "traceEvents": self._events + meta + self._body + body}
        if origin is not None:
            out["otherData"] = {"wall_origin_ns": origin}
        return out

    def write(self, path: str) -> None:
        """Deterministic dump: canonical separators + sorted keys means a
        fixed-seed run writes a byte-identical file."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f,
                      separators=(",", ":"), sort_keys=True)
            f.write("\n")


def validate_trace(trace) -> list[str]:
    """Schema-check a Chrome ``trace_event`` dict (or a path to one); returns
    a list of problems, empty when the trace is Perfetto-loadable."""
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    problems: list[str] = []
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        return ["top level must be an object with a 'traceEvents' list"]
    events = trace["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' must be a list"]
    named: set = set()
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _ALLOWED_PH:
            problems.append(f"{where}: unknown ph {ph!r}")
            continue
        for field in ("pid", "tid"):
            if not isinstance(ev.get(field), int):
                problems.append(f"{where}: missing int {field!r}")
        if not isinstance(ev.get("name"), str) or not ev.get("name"):
            problems.append(f"{where}: missing name")
        if ph == "M":
            if ev.get("name") not in ("process_name", "thread_name"):
                problems.append(f"{where}: metadata name {ev.get('name')!r}")
            elif not isinstance(ev.get("args", {}).get("name"), str):
                problems.append(f"{where}: metadata without args.name")
            else:
                named.add((ev["name"], ev.get("pid"), ev.get("tid")))
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: complete event with bad dur {dur!r}")
        if ph == "C" and not isinstance(ev.get("args"), dict):
            problems.append(f"{where}: counter without args")
        if ("process_name", ev.get("pid"), 0) not in named:
            problems.append(f"{where}: pid {ev.get('pid')} has no "
                            f"process_name metadata before first use")
    return problems
