"""Spans of a traced run, taken from the benchmark's side around the calls
into each layer of the engine (wrappers on the engine instance, as the
port's ``chip_smoke.py`` ``StepParts`` takes them), and a profiler slice
of the steady window.

Per iteration (host clock unless said):

* ``prefill_s``: from the iteration's start to the start of its decode
  lane (or its end), with the device synchronized at both ends: the
  admission, the chunk, its head and pick and its cost-tape feedback;
* ``decode_s``: the decode lane, from the replay to the iteration's end
  (replay, pick, feedback, the engine's bookkeeping);
* ``feedback_decode_s``: the decode lane's cost-tape feedback and offset
  refresh (``CompiledDispatcher.feedback`` through the engine's
  ``_feedback``);
* ``body_ms``: the decode step's device span by CUDA events around the
  engine's ``_decode`` (the graph replay with its input copies).

Inside the profiler slice each iteration is a ``perfbench.iteration``
range and the prefill trunk call, the admission's fresh state, the pick
and the feedback are ``perfbench.<part>`` ranges, so the device's idle
gaps can be named by what the host was doing.
"""

from __future__ import annotations

import time

import torch


class Probe:
    """Timers on one engine; ``begin``/``end`` bracket each iteration."""

    def __init__(self, engine, clock=time.perf_counter):
        self.engine = engine
        self.clock = clock
        self.cuda = engine.device.type == "cuda"
        self.parts: dict = {}
        self.profiling = False
        self._range = None
        self._decoding = False
        self._wrap()

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.engine.device)

    def _ranged(self, name: str, fn):
        def call(*a, **k):
            if not self.profiling:
                return fn(*a, **k)
            with torch.profiler.record_function(f"perfbench.{name}"):
                return fn(*a, **k)
        return call

    def _wrap(self) -> None:
        eng = self.engine
        decode, feedback, run = eng._decode, eng._feedback, eng._run

        def timed_decode():
            self._sync()
            t = self.clock()
            self.parts["decode_start"] = t
            self._decoding = True
            if self.cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = self._ranged("replay", decode)()
                e1.record()
                self.parts["body_events"] = (e0, e1)
            else:
                out = self._ranged("replay", decode)()
            return out

        def timed_feedback(recs):
            t = self.clock()
            self._ranged("feedback", feedback)(recs)
            if self._decoding:
                self.parts["feedback_decode_s"] = self.clock() - t

        def ranged_run(tokens, state, pos, phase, lanes=False):
            name = "replay" if self._decoding else "prefill"
            return self._ranged(name, run)(tokens, state, pos, phase, lanes)

        eng._decode = timed_decode
        eng._feedback = timed_feedback
        eng._run = ranged_run
        eng._sample = self._ranged("pick", eng._sample)
        eng._fresh_state = self._ranged("admission", eng._fresh_state)

    def begin(self) -> None:
        self._sync()
        self.parts = {"start": self.clock()}
        self._decoding = False
        if self.profiling:
            self._range = torch.profiler.record_function("perfbench.iteration")
            self._range.__enter__()

    def end(self) -> None:
        self._sync()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        p = self.parts
        t1 = self.clock()
        p["end"] = t1
        dec = p.get("decode_start")
        p["prefill_s"] = (dec if dec is not None else t1) - p["start"]
        if dec is not None:
            p["decode_s"] = t1 - dec

    def resolve(self, iters) -> None:
        """CUDA-event times of every iteration's body (after a sync)."""
        self._sync()
        for it in iters:
            ev = it.parts.pop("body_events", None)
            if ev is not None:
                it.parts["body_ms"] = ev[0].elapsed_time(ev[1])

    def remove(self) -> None:
        for name in ("_decode", "_feedback", "_run", "_sample",
                     "_fresh_state"):
            self.engine.__dict__.pop(name, None)
