"""Slot-based KV cache manager for the continuous-batching engine.

The decode batch is *persistent*: one list of stacked KV caches with
``n_slots`` batch rows (see :func:`repro_torch.models.init_slot_state` —
cache indices are per row so every slot advances independently).  Requests
are prefilled on a detached batch-1 state and then *adopted* into a free
slot; finished requests release their slot, which is immediately reusable.
The decode step therefore always sees the same shapes.

Adopt and release are in-place row writes on the device tensors (the
reference rebuilds its immutable arrays with a jitted scatter).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import init_slot_state

__all__ = ["SlotCacheManager"]


class SlotCacheManager:
    """Owns the persistent decode-batch state plus per-slot host mirrors.

    ``pos[slot]`` is the number of valid context tokens in the slot (the
    rope/cache offset of the *next* token); ``last_token[slot]`` is the most
    recently sampled token, i.e. the next decode-step input.
    """

    def __init__(self, cfg: ModelConfig, n_slots: int, max_seq: int, *,
                 device="cuda"):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.device = resolve_device(device)
        self.state = init_slot_state(cfg, n_slots, max_seq,
                                     device=self.device)
        self.pos = np.zeros(n_slots, dtype=np.int32)
        self.last_token = np.zeros(n_slots, dtype=np.int32)
        self._free = list(range(n_slots - 1, -1, -1))  # pop() -> lowest id

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return self.n_slots - self.n_free

    def allocate(self) -> Optional[int]:
        """Reserve a slot (lowest id first, deterministic); None when full."""
        if not self._free:
            return None
        return self._free.pop()

    def adopt(self, slot: int, small_state, n_context: int,
              last_token: int) -> None:
        """Copy a prefilled batch-1 state into row ``slot`` and arm the row
        for decoding (``n_context`` prompt tokens consumed, ``last_token``
        already sampled from the prefill logits)."""
        if not 0 <= slot < self.n_slots:
            raise IndexError(f"slot {slot} out of range")
        if n_context + 1 > self.max_seq:
            raise ValueError(
                f"context {n_context} leaves no room in max_seq {self.max_seq}")
        for big, small in zip(self.state, small_state):
            big.k[:, slot].copy_(small.k[:, 0])
            big.v[:, slot].copy_(small.v[:, 0])
            big.idx[:, slot].copy_(small.idx)
        self.pos[slot] = n_context
        self.last_token[slot] = last_token

    def release(self, slot: int) -> None:
        """Return a slot to the free list (its cache rows become dead).  Its
        cache index is zeroed: while the slot stays free its idx still
        drifts (+1 per decode step, like every row) — harmless, cache writes
        clamp at the buffer edge and the next adopt overwrites the row — but
        the reset keeps the drift from accumulating across occupancies."""
        if slot in self._free:
            raise ValueError(f"slot {slot} is already free")
        for big in self.state:
            big.idx[:, slot] = 0
        self.pos[slot] = 0
        self.last_token[slot] = 0
        self._free.append(slot)
        self._free.sort(reverse=True)  # keep lowest-id-first determinism
