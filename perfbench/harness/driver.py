"""The client side of a run: submits each request when it is due, steps
the program's dispatcher, and stamps every delivered token on the wall
clock after the step that delivered it.

Each request goes in with ``arrival_time = engine.now`` (the engine's own
clock is the virtual hybrid-CPU clock of the serve default; so it admits
the request at once), and is timed from when it was due on the wall clock.
A step that delivers a request's first token and its second (a prefill's
last chunk, then the decode step of the same iteration) delivers both at
its end: one stamp, as a client streaming the output sees them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from perfbench.harness.traffic import Req


@dataclass
class Iter:
    """One engine iteration as the harness saw it."""

    t0: float
    t1: float
    prefill: Optional[Tuple[int, int, bool]] = None  # (start, length, last)
    decode_ctx: List[int] = field(default_factory=list)  # cache rows after
    rows: int = 0                               # rows the decode step ran
    parts: dict = field(default_factory=dict)   # the probe's timers


class Driver:
    """Drives one system with one traffic generator."""

    def __init__(self, system, traffic, probe=None,
                 clock: Callable[[], float] = time.perf_counter,
                 sleep: Callable[[float], None] = time.sleep):
        self.sys = system
        self.gen = traffic
        self.probe = probe
        self.clock = clock
        self.sleep = sleep
        self.active: List[Req] = []
        self.requests: List[Req] = []
        self.iters: List[Iter] = []
        self.origin: Optional[float] = None     # the window's start
        self.close: Optional[float] = None      # the window's end
        self.late: List[float] = []             # submit - due, open loop

    # -------------------------------------------------------------- intake --
    def submit(self, rec: Req, now: float) -> None:
        from repro_torch.serving import Request

        eng = self.sys.engine
        rec.request = Request(prompt=rec.prompt, max_new_tokens=rec.max_new,
                              arrival_time=eng.now)
        rec.submitted = now
        self.sys.inflight.submit(rec.request)
        self.active.append(rec)
        self.requests.append(rec)

    def _rel(self, t: float) -> Optional[float]:
        return None if self.origin is None else t - self.origin

    # ---------------------------------------------------------------- step --
    def step(self) -> Iter:
        """One iteration of the dispatcher, then the stamps."""
        from repro_torch.serving import RequestState

        t0 = self.clock()
        if self.probe is not None:
            self.probe.begin()
        stats = self.sys.inflight.step()[0]
        if self.probe is not None:
            self.probe.end()
        t1 = self.clock()
        it = Iter(t0=t0, t1=t1, rows=int(self.sys.engine.max_slots
                                         if stats.decode_tokens else 0))
        if self.probe is not None:
            it.parts = self.probe.parts
        finished = []
        for rec in self.active:
            r = rec.request
            if rec.first_chunk is None and r.state is not RequestState.WAITING:
                rec.first_chunk = t0
            if r.prefill_done > rec.prefill_seen:
                it.prefill = (rec.prefill_seen, r.prefill_done - rec.prefill_seen,
                              r.prefill_done >= r.prompt_len)
                rec.prefill_seen = r.prefill_done
            n = r.n_generated
            if n > rec.n_seen:
                decoded = n - rec.n_seen - (1 if rec.n_seen == 0 else 0)
                if decoded:
                    it.decode_ctx.append(r.prompt_len + n - 1)
                rec.stamps.append((t1, n - rec.n_seen))
                rec.n_seen = n
            if r.state is RequestState.FINISHED:
                rec.done = t1
                finished.append(rec)
        self.sys.inflight.poll_finished()
        for rec in finished:
            self.active.remove(rec)
            for nxt in self.gen.finished(rec, self._rel(t1)):
                self.submit(nxt, t1)
        self.iters.append(it)
        return it

    # ------------------------------------------------------------- phases --
    def fill(self) -> None:
        """Set-up traffic: send the generator's first requests and step
        until every one sent is decoding (nothing waits or prefills)."""
        now = self.clock()
        for rec in self.gen.initial():
            self.submit(rec, now)
        eng = self.sys.engine
        while eng.n_waiting or eng.n_prefilling:
            self.step()

    def window(self, seconds: float, on_iter=None) -> None:
        """Measure for ``seconds``: send what falls due, step while there is
        work, wait for the next arrival when there is none.  No step starts
        after the close."""
        self.origin = self.clock()
        self.close = self.origin + seconds
        inflight = self.sys.inflight
        while True:
            now = self.clock()
            if now >= self.close:
                break
            for rec in self.gen.due(now - self.origin):
                self.submit(rec, now)
                self.late.append(now - self.origin - rec.due)
            if not inflight.has_work:
                nxt = self.gen.next_due()
                until = self.close if nxt is None else min(
                    self.close, self.origin + nxt)
                self.sleep(max(0.0, until - self.clock()))
                continue
            if on_iter is not None:
                on_iter(self)
            self.step()

    def follow_through(self, limit_s: float = 120.0) -> None:
        """After the close (open loop): no new arrivals; step until every
        request that was due in the window has finished."""
        if not self.gen.open_loop:
            return
        t_stop = self.clock() + limit_s
        while any(r.due is not None and r.done is None
                  for r in self.active) and self.clock() < t_stop:
            self.step()

    def window_iters(self) -> List[Iter]:
        return [it for it in self.iters
                if self.origin <= it.t0 and it.t1 <= self.close]
