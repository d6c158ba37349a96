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

Export with :meth:`write` and open the file at https://ui.perfetto.dev (or
``chrome://tracing``).  :func:`validate_trace` checks the schema the way the
CI smoke job does.
"""

from __future__ import annotations

import json
from typing import Optional

__all__ = ["SpanTracer", "validate_trace"]

_ALLOWED_PH = {"X", "C", "i", "M"}


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

    # -------------------------------------------------------------- export --
    def chrome_events(self) -> list[dict]:
        """Metadata first (Perfetto names tracks before events reference
        them), then spans/counters/instants in emission order."""
        return self._events + self._body

    def to_chrome(self) -> dict:
        return {"displayTimeUnit": "ms", "traceEvents": self.chrome_events()}

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
