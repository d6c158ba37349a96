"""Ratio table -> device-array shard offsets (the compiled-decode snapshot).

The compiled lowering (:mod:`repro_torch.kernels.compiled`) follows the
paper's "balance *before* the parallel work starts": per-core shard
boundaries are planned on the host *between* engine steps and materialized
as small int32 tensors on the snapshot's device, which the decode step
consumes as ordinary inputs.  Nothing inside the step reads the ratio table
or syncs with the host; the table only influences the next step's offsets.

:class:`OffsetSnapshot` owns that materialization for any planner:

* ``register(OffsetSpec(name, total, granularity))`` declares one call
  site's split dimension;
* ``refresh()`` re-plans every registered spec from the current ratio
  state (via the ``plan_counts`` callable the owner supplied — typically
  a dispatcher's Balancer) and returns ``{name: (n_workers + 1,) int32
  tensor}`` of cumulative boundaries — worker ``w`` owns rows
  ``[b[w], b[w+1])``.  Each spec's tensor is allocated once, at the first
  refresh that plans it, and every later refresh writes the new
  boundaries into it in place: the tensors keep their addresses, so a
  decode step captured as a CUDA graph reads the latest plan at every
  replay;
* ``boundaries(name)`` / ``counts(name)`` expose the host-side mirror of
  the latest snapshot (what feedback replay compares device-recovered
  shard sizes against).

The snapshot is deliberately dumb about *how* counts are planned — flat
per-core, two-level socket-then-core, even/static — the planner callable
decides; the snapshot only guarantees that what the device reads is the
plan the host will account for.
"""

# lint: virtual-clock-module
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.analysis import invariants as _contracts
from repro_torch.core import events as _ev

__all__ = ["OffsetSpec", "OffsetSnapshot"]


@dataclass(frozen=True)
class OffsetSpec:
    """One compiled call site's split dimension: ``total`` units planned
    under ``name`` (the snapshot dict key, unique per call-site shape)."""

    name: str
    total: int
    granularity: int = 1

    def __post_init__(self) -> None:
        if self.total < 0:
            raise ValueError("total must be >= 0")
        if self.granularity < 1:
            raise ValueError("granularity must be >= 1")


class OffsetSnapshot:
    """Named host plans mirrored as device boundary arrays.

    ``plan_counts(spec) -> (n_workers,) int64`` produces one plan from the
    owner's current ratio state; ``refresh()`` runs it for every registered
    spec and writes the cumulative boundaries into that spec's tensor on
    ``device`` (kept as :attr:`tensor_device`).  Every refresh returns the
    same dict of the same tensors, whose values it has just replaced —
    callers pass it *as an argument* into their step (or capture it in a
    graph), so the step always reads the plan the host will account for.
    A planner may not change a spec's worker count once it has planned it.
    """

    def __init__(self, plan_counts: Callable[[OffsetSpec], np.ndarray], *,
                 device="cuda"):
        self._plan_counts = plan_counts
        self.tensor_device = torch.device(device)
        self._specs: Dict[str, OffsetSpec] = {}
        self._host: Dict[str, np.ndarray] = {}
        self._device: Dict[str, torch.Tensor] = {}

    # -------------------------------------------------------- registration --
    def register(self, spec: OffsetSpec) -> OffsetSpec:
        """Declare (or re-declare, idempotently) one call site.  Re-using a
        name with a different shape is a programming error and is refused."""
        prev = self._specs.get(spec.name)
        if prev is not None:
            if prev != spec:
                raise ValueError(
                    f"offset spec {spec.name!r} already registered with "
                    f"total={prev.total}, granularity={prev.granularity}")
            return prev
        self._specs[spec.name] = spec
        return spec

    @property
    def names(self) -> list:
        return list(self._specs)

    def spec(self, name: str) -> OffsetSpec:
        return self._specs[name]

    # ------------------------------------------------------------- refresh --
    def refresh(self) -> Dict[str, torch.Tensor]:
        """Re-plan every registered spec from current ratio state and write
        the boundaries into the device snapshot ``{name: (n_workers + 1,)
        int32 tensor}``, which it returns.

        The commit is atomic: every spec is planned into host locals first,
        and only when *all* have planned are the device tensors written and
        the host mirror published.  A planner exception mid-refresh must
        leave both untouched — feedback replay would otherwise compare
        device-recovered shard sizes against boundaries the device never
        saw.
        """
        w = _ev.WALL
        sp = w and w.begin("feedback.plan", sites=len(self._specs))
        host: Dict[str, np.ndarray] = {}
        for name, spec in self._specs.items():
            counts = np.asarray(self._plan_counts(spec), dtype=np.int64)
            if int(counts.sum()) != spec.total:
                raise ValueError(
                    f"planner returned {int(counts.sum())} units for "
                    f"{name!r} (expected {spec.total})")
            prev = self._device.get(name)
            if prev is not None and prev.numel() != len(counts) + 1:
                raise ValueError(
                    f"planner returned {len(counts)} workers for {name!r}, "
                    f"which was planned over {prev.numel() - 1}")
            bounds = np.zeros(len(counts) + 1, dtype=np.int32)
            np.cumsum(counts, out=bounds[1:])
            if _contracts.contracts_enabled():
                _contracts.check_offset_boundaries(
                    bounds, spec.total,
                    where=f"OffsetSnapshot.refresh[{name}]")
            host[name] = bounds
        if sp:
            w.end(sp)
            sp = w.begin("feedback.upload", copies=len(host))
        for name, bounds in host.items():
            dev = self._device.get(name)
            if dev is None:
                self._device[name] = torch.tensor(bounds,
                                                  device=self.tensor_device)
            else:
                dev.copy_(torch.from_numpy(bounds))
        if sp:
            w.end(sp)
        self._host = host
        if _ev.RECORDER is not None:
            for name, bounds in host.items():
                _ev.record("offsets", name, boundaries=bounds.tolist())
        return self._device

    def device(self) -> Dict[str, torch.Tensor]:
        """The latest device snapshot (refreshing first if none exists)."""
        if not self._device and self._specs:
            return self.refresh()
        return self._device

    # ---------------------------------------------------------- host mirror --
    def boundaries(self, name: str) -> np.ndarray:
        """Host-side cumulative boundaries of the latest snapshot."""
        if name not in self._host:
            self.refresh()
        return self._host[name]

    def counts(self, name: str) -> np.ndarray:
        """Host-side per-worker counts of the latest snapshot."""
        b = self.boundaries(name)
        return (b[1:] - b[:-1]).astype(np.int64)
