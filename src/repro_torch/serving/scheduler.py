"""Iteration-level scheduling for the continuous-batching engine.

One engine iteration = (one batched prefill call over the active lanes) +
(one decode step for the whole persistent batch).  The scheduler decides
*which* prompt tokens run in the prefill lane(s) each iteration:

* Admission is arrival-ordered FIFO (deterministic): a waiting request is
  admitted as soon as it has arrived (``arrival_time <= now``), a slot is
  free, and a prefill lane (of ``prefill_lanes``, default 1) is open.
* Prefill is optionally *chunked* (``prefill_chunk``): long prompts are
  consumed up to ``chunk`` tokens per iteration so running decodes are
  never starved behind a long prompt — the usual continuous-batching
  trade between TTFT of the new request and TPOT of the running ones.
  Chunk lengths are bucketed to powers of two so the engine's jitted
  prefill compiles at most ``log2(prefill_chunk) + 1`` shapes, no matter
  how prompt lengths vary (decode already has one static shape).
* With ``prefill_lanes > 1`` every active lane advances by the *same*
  chunk length each iteration (the minimum of the per-lane bucketed
  lengths — a min of powers of two is itself a power of two, so the
  bounded-shape-set property survives): the engine then runs all lanes
  as one batched trunk call instead of one call per prompt.

The scheduler is pure host-side bookkeeping; the engine owns all jitted
execution and the slot state.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional

from .request import Request, RequestState

__all__ = ["PrefillChunk", "IterationStats", "IterationScheduler"]


@dataclass(frozen=True)
class PrefillChunk:
    """One iteration's prefill work: ``request.prompt[start:start+length]``."""

    request: Request
    start: int
    length: int

    @property
    def is_last(self) -> bool:
        return self.start + self.length >= self.request.prompt_len


@dataclass
class IterationStats:
    """What one engine iteration did, in engine-clock seconds — the per-phase
    feedback consumed by the replica dispatcher's ratio tables."""

    now: float = 0.0
    prefill_tokens: int = 0
    prefill_seconds: float = 0.0
    decode_tokens: int = 0          # one per running slot stepped
    decode_seconds: float = 0.0
    n_running: int = 0
    n_waiting: int = 0
    admitted: List[int] = field(default_factory=list)    # request ids
    finished: List[int] = field(default_factory=list)


class IterationScheduler:
    """Admission queue + chunked-prefill cursors.

    At most ``prefill_lanes`` requests are in the PREFILL state at a time
    (default 1, the classic single-lane engine); their prompts are consumed
    chunk by chunk across iterations, interleaved with decode steps of the
    running batch.
    """

    def __init__(self, prefill_chunk: Optional[int] = None,
                 prefill_lanes: int = 1):
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if prefill_lanes < 1:
            raise ValueError("prefill_lanes must be >= 1")
        self.prefill_chunk = prefill_chunk
        self.prefill_lanes = prefill_lanes
        self.waiting: Deque[Request] = deque()
        self.lanes: List[Request] = []   # admission order, PREFILL state

    @property
    def prefilling(self) -> Optional[Request]:
        """Single-lane view: the oldest in-flight prefill (None when the
        lane set is empty) — the pre-multi-lane attribute, kept for
        callers of the classic one-lane engine."""
        return self.lanes[0] if self.lanes else None

    # ------------------------------------------------------------- intake --
    def submit(self, request: Request) -> None:
        """Queue a request, keeping the queue sorted by arrival time (stable
        for equal arrivals, so submit order breaks ties deterministically)."""
        if request.state is not RequestState.WAITING:
            raise ValueError("only WAITING requests can be submitted")
        if self.waiting and request.arrival_time < self.waiting[-1].arrival_time:
            items = sorted(list(self.waiting) + [request],
                           key=lambda r: r.arrival_time)
            self.waiting = deque(items)
        else:
            self.waiting.append(request)

    def n_waiting(self, now: Optional[float] = None) -> int:
        if now is None:
            return len(self.waiting)
        return sum(1 for r in self.waiting if r.arrival_time <= now)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or bool(self.lanes)

    # ----------------------------------------------------------- per-step --
    def _desired_length(self, req: Request) -> int:
        remaining = req.prompt_len - req.prefill_done
        if self.prefill_chunk is None:
            return remaining
        # largest power of two <= min(chunk, remaining): a bounded
        # shape set for the jitted prefill (one-shot mode instead
        # compiles per distinct prompt length, the caller's trade)
        length = min(self.prefill_chunk, remaining)
        return 1 << (length.bit_length() - 1)

    def next_prefill(self, now: float, free_slots: int) -> List[PrefillChunk]:
        """The prefill work for this iteration — one chunk per active lane,
        all of the same length, admitting arrived requests into open lanes
        while ``free_slots`` allows (each new lane needs a decode slot)."""
        free = int(free_slots)
        while (len(self.lanes) < self.prefill_lanes and free > 0
               and self.waiting and self.waiting[0].arrival_time <= now):
            self.lanes.append(self.waiting.popleft())
            free -= 1
        if not self.lanes:
            return []
        length = min(self._desired_length(r) for r in self.lanes)
        return [PrefillChunk(request=r, start=r.prefill_done, length=length)
                for r in self.lanes]

    def prefill_advanced(self, chunk: PrefillChunk) -> None:
        """Mark ``chunk`` as executed; frees its lane on the last chunk
        (the engine flips the request to RUNNING)."""
        if chunk.request not in self.lanes:
            raise ValueError("chunk does not belong to an active prefill lane")
        if chunk.is_last:
            self.lanes.remove(chunk.request)

    def remove_lane(self, request: Request) -> None:
        """Drop an in-flight prefill (abort path)."""
        if request not in self.lanes:
            raise ValueError("request is not prefilling in this engine")
        self.lanes.remove(request)
