"""Request-level serving primitives.

A :class:`Request` is one generation job moving through the
continuous-batching engine's lifecycle::

    WAITING --admit--> PREFILL --last chunk--> RUNNING --finish--> FINISHED
                 (slot allocated)     (joins the persistent decode batch)

Timestamps are recorded in the engine's clock domain (wall seconds, or
virtual seconds when a phase cost model drives the clock), so latency
metrics (TTFT / TPOT) are deterministic under the simulator.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

__all__ = ["RequestState", "FinishReason", "Request"]


class RequestState(enum.Enum):
    """Lifecycle of a request inside the engine."""

    WAITING = "waiting"    # submitted, not yet admitted (queue)
    PREFILL = "prefill"    # slot reserved; prompt being consumed (chunked)
    RUNNING = "running"    # in the persistent decode batch
    FINISHED = "finished"  # left the engine; slot released


class FinishReason(enum.Enum):
    LENGTH = "length"      # hit max_new_tokens
    STOP = "stop"          # sampled the stop token
    ABORTED = "aborted"    # cancelled / engine shut down before completion
    SHED = "shed"          # rejected by admission control, never executed


@dataclass(eq=False)  # identity semantics: prompts are arrays, ids are per-engine
class Request:
    """One generation request plus its per-request runtime record.

    The engine mutates the bookkeeping fields; callers create requests with
    just ``prompt`` / ``max_new_tokens`` (and optionally ``arrival_time``
    for open-loop traffic replay).
    """

    prompt: np.ndarray                   # (S0,) int32 token ids
    max_new_tokens: int
    request_id: int = -1                 # assigned by the engine at submit()
    arrival_time: float = 0.0            # engine-clock arrival (open loop)
    stop_token: Optional[int] = None
    deadline: Optional[float] = None     # absolute clock bound for admission
    degraded: bool = False               # max_new_tokens shrunk by admission

    # --- engine bookkeeping -------------------------------------------------
    state: RequestState = RequestState.WAITING
    finish_reason: Optional[FinishReason] = None
    slot: Optional[int] = None           # decode-batch row while admitted
    prefill_done: int = 0                # prompt tokens consumed so far
    generated: List[int] = field(default_factory=list)

    # --- latency record (engine clock) --------------------------------------
    admit_time: Optional[float] = None   # prefill started
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None

    def __post_init__(self) -> None:
        self.prompt = np.asarray(self.prompt, dtype=np.int32).reshape(-1)
        if len(self.prompt) == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def n_generated(self) -> int:
        return len(self.generated)

    @property
    def tokens(self) -> np.ndarray:
        """prompt + generated tokens, the shape callers consume."""
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, dtype=np.int32)])

    # --- serving metrics ----------------------------------------------------
    @property
    def ttft(self) -> Optional[float]:
        """Time to first token: arrival -> first generated token."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def tpot(self) -> Optional[float]:
        """Time per output token over the decode phase (excludes TTFT).
        ``None`` for single-token completions — with no decode interval
        there is no sample, and a 0.0 placeholder would drag TPOT
        percentiles toward zero."""
        if self.finish_time is None or self.first_token_time is None:
            return None
        if self.n_generated <= 1:
            return None
        return ((self.finish_time - self.first_token_time)
                / (self.n_generated - 1))
