"""Serving engine: request-level continuous batching over the balanced
trunk.

``ContinuousBatchingEngine`` is the serving core: a persistent decode
batch of ``max_slots`` rows (slot-based KV state, per-row cache indices),
an iteration-level scheduler that interleaves chunked prefill with running
decode steps, and request admission/eviction with no full-batch barrier.
Time comes either from the wall clock or from a per-phase hybrid-CPU cost
model (:class:`~repro_torch.serving.phases.HybridPhaseCost`), which also
drives the paper's control loop with separate "prefill" / "decode" ratio
keys.

The port runs one prefill lane.  Multi-lane prefill, the topology wiring,
the balanced-head-only mode and the seed-era ``ServeEngine`` /
``RoutedServer`` are not ported yet.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import events as _ev
from repro_torch.device import resolve_device
from repro_torch.models import forward, init_state

from .phases import DECODE, PHASE_ISA, PREFILL
from .request import FinishReason, Request, RequestState
from .scheduler import IterationScheduler, IterationStats
from .slots import SlotCacheManager

__all__ = ["ContinuousBatchingEngine"]


class ContinuousBatchingEngine:
    """Request-level engine: persistent decode batch + interleaved prefill.

    One :meth:`step` is one scheduler iteration:

    1. *(idle fast-forward)* with nothing admitted and nothing running, the
       clock jumps to the next arrival (open-loop traffic replay).
    2. *Prefill lane*: at most one prompt chunk (``prefill_chunk`` tokens,
       or the whole prompt) runs on a detached batch-1 state; on the last
       chunk the first token is sampled and the state is adopted into a
       free decode slot.
    3. *Decode lane*: one greedy step for the whole persistent batch;
       finished requests release their slots immediately.

    With a compiled ``balanced_trunk`` (a
    :class:`~repro_torch.models.BalancedTrunk`) every projection of both
    lanes, and the LM head, runs as one kernel launch; the step takes the
    device offset snapshot as an argument and returns its cost tape, which
    is replayed into the ratio tables between steps.  An eager trunk has
    neither: each projection plans, runs one kernel shard per core and
    feeds back when it is called, and its head runs only where a token is
    sampled (the last prefill chunk and every decode step), as in the
    reference's ``jit_bridge=False`` engine.

    ``cost_model`` (see :class:`~repro_torch.serving.phases.
    PhaseCostModel`) replaces wall timing with deterministic virtual
    seconds; the model on ``device`` still produces the real tokens.
    """

    def __init__(self, cfg: ModelConfig, params, *, max_slots: int,
                 max_seq: int, prefill_chunk: Optional[int] = None,
                 prefill_lanes: int = 1,
                 sampler: Optional[Callable] = None, cost_model=None,
                 balanced_head=None, balanced_trunk=None, topology=None,
                 device="cuda"):
        if prefill_lanes != 1:
            raise NotImplementedError(
                "prefill_lanes > 1 (batched multi-lane prefill) is not "
                "ported yet")
        if topology is not None:
            raise NotImplementedError("topology= is not ported yet")
        if balanced_head is not None:
            raise NotImplementedError(
                "balanced_head= (eager shard dispatch of the head) is not "
                "ported yet; use a balanced_trunk with a head")
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.cost_model = cost_model
        self.balanced_trunk = balanced_trunk
        self.manager = SlotCacheManager(cfg, max_slots, max_seq,
                                        device=self.device)
        self.scheduler = IterationScheduler(prefill_chunk,
                                            prefill_lanes=prefill_lanes)
        # soft concurrency cap (<= max_slots): admission headroom only
        self.slot_budget = max_slots
        self.now = 0.0
        self.finished: List[Request] = []
        self._running: List[Request] = []
        self._partial = None           # in-flight batch-1 prefill state
        self._next_id = 0
        # (B,) greedy rows by default; a sampler sees (B, V) logits.
        self._pick = sampler or (lambda lg: torch.argmax(lg, -1))
        self._compiled_trunk = (balanced_trunk is not None
                                and balanced_trunk.mode == "compiled")
        # Initial offset snapshot (compiled trunk): planned from whatever
        # the ratio tables currently hold, refreshed after every step.
        self._offsets = (balanced_trunk.compiled_refresh()
                         if self._compiled_trunk else None)

    # ------------------------------------------------------------ the step --
    def _run(self, tokens: torch.Tensor, state, pos, phase: str):
        """One trunk call (prefill chunk or decode step).  Returns (B, V)
        logits — (B, d) hidden states when an eager trunk's head is still
        to run (:meth:`_head`) — the updated state, and the step's
        cost-tape records (None without a compiled trunk)."""
        trunk = self.balanced_trunk
        last = "last" if phase == PREFILL else "all"
        if not self._compiled_trunk:
            out = forward(self.cfg, self.params, tokens, state=state,
                          pos_offset=pos, logits_mode=last,
                          apply_head=trunk is None or trunk.head is None,
                          trunk=trunk, trunk_isa=PHASE_ISA[phase])
            return out.logits[:, -1, :], out.state, None
        tape = trunk.compiled_tape_begin()
        out = forward(self.cfg, self.params, tokens, state=state,
                      pos_offset=pos, logits_mode=last,
                      apply_head=trunk.head is None, trunk=trunk,
                      trunk_isa=PHASE_ISA[phase], trunk_offsets=self._offsets)
        logits = out.logits[:, -1, :]
        if trunk.head is not None:
            logits = trunk.apply_head(logits, isa=PHASE_ISA[phase],
                                      offsets=self._offsets)
        return logits, out.state, trunk.compiled_tape_end(tape)

    def _head(self, hidden: torch.Tensor, phase: str) -> torch.Tensor:
        """An eager trunk's LM head over (B, d) hidden states; the logits
        of every other engine pass through."""
        trunk = self.balanced_trunk
        if self._compiled_trunk or trunk is None or trunk.head is None:
            return hidden
        return trunk.apply_head(hidden, isa=PHASE_ISA[phase])

    def _feedback(self, recs) -> None:
        """Between-step feedback: replay the step's cost tape into the ratio
        tables and refresh the offset snapshot."""
        if recs is not None:
            self._offsets = self.balanced_trunk.compiled_feedback(recs)

    # ------------------------------------------------------------- intake --
    def submit(self, request: Request) -> int:
        """Queue a request; returns its engine-assigned id."""
        if request.prompt_len + 1 > self.max_seq:
            raise ValueError(
                f"prompt of {request.prompt_len} tokens cannot decode within "
                f"max_seq={self.max_seq}")
        request.request_id = self._next_id
        self._next_id += 1
        self.scheduler.submit(request)
        return request.request_id

    def set_slot_budget(self, budget: int) -> int:
        """Re-plan the soft concurrency cap: admission stops above the
        budget while admitted requests run to completion.  Clamped to
        ``[1, max_slots]``.  Returns the applied budget."""
        self.slot_budget = int(np.clip(budget, 1, self.max_slots))
        return self.slot_budget

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work or bool(self._running)

    @property
    def n_running(self) -> int:
        return len(self._running)

    @property
    def n_waiting(self) -> int:
        return self.scheduler.n_waiting()

    @property
    def n_prefilling(self) -> int:
        return len(self.scheduler.lanes)

    @property
    def pending_prefill_tokens(self) -> int:
        """Prompt tokens queued ahead of a newly routed request (the
        dispatcher's prefill-pressure signal)."""
        pending = sum(r.prompt_len for r in self.scheduler.waiting)
        pending += sum(r.prompt_len - r.prefill_done
                       for r in self.scheduler.lanes)
        return pending

    @property
    def queue_depth(self) -> int:
        """Outstanding requests at every pre-finish stage."""
        return self.n_running + self.n_prefilling + self.n_waiting

    def outstanding(self) -> List[Request]:
        """Every request currently owned by the engine."""
        out = list(self.scheduler.waiting)
        out.extend(self.scheduler.lanes)
        out.extend(self._running)
        return out

    def steal_waiting(self) -> List[Request]:
        """Remove and return all still-WAITING requests."""
        out = list(self.scheduler.waiting)
        self.scheduler.waiting.clear()
        return out

    def poll_finished(self) -> List[Request]:
        """Drain and return requests finished since the last poll."""
        out, self.finished = self.finished, []
        return out

    def abort(self, request: Request) -> bool:
        """Cancel a request at any pre-finish stage, releasing whatever it
        holds.  Returns False when it already finished."""
        if request.state is RequestState.FINISHED:
            return False
        man, sched = self.manager, self.scheduler
        if request.state is RequestState.WAITING:
            try:
                sched.waiting.remove(request)
            except ValueError:
                raise ValueError("request is not queued in this engine")
        elif request.state is RequestState.PREFILL:
            sched.remove_lane(request)  # raises when not prefilling here
            self._partial = None
            man.release(request.slot)
            request.slot = None
        elif request.state is RequestState.RUNNING:
            if request not in self._running:
                raise ValueError("request is not running in this engine")
            self._running.remove(request)
            man.release(request.slot)
            request.slot = None
        request.state = RequestState.FINISHED
        request.finish_reason = FinishReason.ABORTED
        request.finish_time = self.now
        self.finished.append(request)
        return True

    # -------------------------------------------------------------- step ---
    def step(self) -> IterationStats:
        """Run one scheduler iteration; returns what it did (the per-phase
        feedback record)."""
        st = IterationStats()
        man, sched = self.manager, self.scheduler
        dev = self.device

        # Idle fast-forward: nothing to run until the next arrival.
        if (not self._running and not sched.lanes
                and sched.waiting and not sched.n_waiting(self.now)):
            self.now = max(self.now, sched.waiting[0].arrival_time)

        budget_free = max(0, min(man.n_free,
                                 self.slot_budget - man.n_active))
        chunks = sched.next_prefill(self.now, budget_free)
        if chunks:
            chunk = chunks[0]
            req = chunk.request
            if req.slot is None:  # newly admitted: reserve the slot now
                req.slot = man.allocate()
                req.state = RequestState.PREFILL
                req.admit_time = self.now
                # a fresh zeroed batch-1 state per admission: the caches
                # are written in place, so no state is ever shared
                self._partial = init_state(self.cfg, 1, self.max_seq,
                                           device=dev)
            tokens = torch.as_tensor(
                req.prompt[chunk.start:chunk.start + chunk.length][None, :],
                device=dev)
            t0 = time.perf_counter()
            logits, small, recs = self._run(
                tokens, self._partial,
                torch.tensor(chunk.start, dtype=torch.int32, device=dev),
                PREFILL)
            tok = None
            if chunk.is_last:
                # sampling inside the timed window, matching the decode
                # lane (TTFT includes the head)
                tok = int(self._pick(self._head(logits, PREFILL))
                          .reshape(-1)[0])
            if self.cost_model is None:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                dt = time.perf_counter() - t0
            else:
                dt = self.cost_model.prefill_seconds(
                    chunk.length, ctx=chunk.start + chunk.length)
            self._feedback(recs)
            req.prefill_done += chunk.length
            sched.prefill_advanced(chunk)
            if self.cost_model is not None:
                _ev.emit_span("engine", PREFILL, self.now, dt, cat="engine",
                              args=lambda: {"tokens": int(chunk.length)})
            self.now += dt
            st.prefill_tokens = chunk.length
            st.prefill_seconds = dt
            if chunk.is_last:
                self._partial = None
                req.generated.append(tok)
                req.first_token_time = self.now
                man.adopt(req.slot, small, req.prompt_len, tok)
                req.state = RequestState.RUNNING
                self._running.append(req)
                st.admitted.append(req.request_id)
                self._maybe_finish(req, tok, st)
            else:
                self._partial = small

        if self._running:
            tok = torch.as_tensor(man.last_token[:, None], device=dev)
            pos = torch.as_tensor(man.pos, device=dev)
            t0 = time.perf_counter()
            logits, man.state, recs = self._run(tok, man.state, pos, DECODE)
            next_tok = (self._pick(self._head(logits, DECODE))
                        .reshape(-1).cpu().numpy())
            if self.cost_model is None:
                dt = time.perf_counter() - t0
            else:
                dt = self.cost_model.decode_seconds(
                    len(self._running), ctx=int(man.pos.max()))
            self._feedback(recs)
            if self.cost_model is not None:
                _ev.emit_span(
                    "engine", DECODE, self.now, dt, cat="engine",
                    args=lambda: {"batch": len(self._running)})
            self.now += dt
            st.decode_tokens = len(self._running)
            st.decode_seconds = dt
            for req in list(self._running):
                t = int(next_tok[req.slot])
                req.generated.append(t)
                man.last_token[req.slot] = t
                man.pos[req.slot] += 1
                self._maybe_finish(req, t, st)

        st.n_running = len(self._running)
        st.n_waiting = self.scheduler.n_waiting()
        st.now = self.now
        if self.cost_model is not None:
            _ev.emit_counter("queue", self.now,
                             lambda: {"depth": float(self.queue_depth)})
        return st

    def _maybe_finish(self, req: Request, tok: int, st: IterationStats) -> None:
        stopped = req.stop_token is not None and tok == req.stop_token
        out_of_room = req.prompt_len + req.n_generated + 1 > self.max_seq
        if not (stopped or out_of_room
                or req.n_generated >= req.max_new_tokens):
            return
        req.finish_reason = (FinishReason.STOP if stopped
                             else FinishReason.LENGTH)
        req.finish_time = self.now
        req.state = RequestState.FINISHED
        self.manager.release(req.slot)
        req.slot = None
        self._running.remove(req)
        self.finished.append(req)
        st.finished.append(req.request_id)

    def run_until_idle(self, max_steps: Optional[int] = None) -> List[IterationStats]:
        """Step until every submitted request has finished."""
        stats = []
        while self.has_work:
            if max_steps is not None and len(stats) >= max_steps:
                break
            stats.append(self.step())
        return stats
