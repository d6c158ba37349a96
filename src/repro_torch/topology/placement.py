# lint: virtual-clock-module
"""NUMA-aware weight placement for balanced trunks.

The decode step streams every trunk weight once per token, so *where* each
weight's bytes are resident decides which socket can stream them locally.
:func:`place_trunk` walks a :class:`~repro_torch.models.balanced.BalancedTrunk`
and pins every banked projection's column (N-row) range to sockets —
contiguous ranges proportional to each socket's streaming bandwidth, the
placement that lets every domain's pool saturate on local traffic — and
registers the pinning with the trunk's :class:`~repro_torch.topology.dispatch.
TopologyDispatcher`, which from then on charges the fabric penalty for any
dispatch outside the resident range.

Per-domain byte accounting comes with it: :class:`TrunkPlacement` records
the resident weight bytes per socket (packed Q4 bytes, s8 bytes, or f32
bytes — what the decode step actually streams), so the placement itself is
auditable next to the per-domain achieved-bandwidth fractions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from repro_torch.quant.q4 import BYTES_PER_ELEM

from .dispatch import TopologyDispatcher
from .machine import place_rows

__all__ = ["place_rows", "place_trunk", "TrunkPlacement"]


def _weight_handle(layer) -> Tuple[object, int, float]:
    """(registry object, n rows, streamed bytes per row) for one balanced
    layer — the registry object must be the exact object the layer hands
    its dispatcher's kernel entry point (the Q4 weight, the s8 code
    tensor, the f32 weight), never a view made per call."""
    from repro_torch.models.layers import (
        BalancedFp32Linear,
        BalancedLinear,
        BalancedQuantLinear,
    )

    if isinstance(layer, BalancedQuantLinear):
        return layer.qw, layer.out_features, layer.qw.in_features * BYTES_PER_ELEM
    if isinstance(layer, BalancedLinear):
        return layer.w.q, layer.out_features, float(layer.w.q.shape[1])
    if isinstance(layer, BalancedFp32Linear):
        return layer.w, layer.out_features, 4.0 * int(layer.w.shape[1])
    raise TypeError(f"not a balanced linear: {type(layer).__name__}")


@dataclass
class TrunkPlacement:
    """The resident map of one placed trunk: per-layer socket ranges plus
    per-socket resident-byte totals."""

    shares: np.ndarray
    entries: List[tuple] = field(default_factory=list)  # (label, ranges)
    socket_bytes: np.ndarray = None

    @property
    def n_layers(self) -> int:
        return len(self.entries)

    @property
    def total_bytes(self) -> float:
        return float(self.socket_bytes.sum())

    def lines(self) -> List[str]:
        total = max(self.total_bytes, 1.0)
        frac = ", ".join(f"{b / total:.1%}" for b in self.socket_bytes)
        return [
            f"[placement] {self.n_layers} weights, "
            f"{self.total_bytes / 1e6:.2f} MB resident",
            f"[placement] per-socket bytes: [{frac}] "
            f"(bandwidth shares: {np.round(self.shares, 3).tolist()})",
        ]


def place_trunk(trunk, granularity: int = 1) -> TrunkPlacement:
    """Pin every banked projection (and the head) of ``trunk`` to the
    sockets of its dispatcher's topology.  Idempotent — re-placing simply
    overwrites the same registrations."""
    disp = trunk.dispatcher
    if not isinstance(disp, TopologyDispatcher):
        raise ValueError(
            "place_trunk needs a trunk bound to a repro_torch.topology."
            "TopologyDispatcher; this trunk's dispatcher is "
            f"{type(disp).__name__}")
    if not disp.socket_local:
        raise ValueError("the socket-oblivious baseline interleaves pages "
                         "by construction; there is nothing to place")
    shares = disp.topology.bandwidth_shares()
    placement = TrunkPlacement(
        shares=shares,
        socket_bytes=np.zeros(disp.n_sockets, dtype=np.float64))
    layers = [(f"{group}.{name}[{j}][{r}]", layer)
              for (j, group, name), stack in sorted(trunk.bank.items())
              for r, layer in enumerate(stack)]
    if trunk.head is not None:
        layers.append(("head", trunk.head))
    for label, layer in layers:
        obj, n, bytes_per_row = _weight_handle(layer)
        ranges = place_rows(n, shares, granularity)
        disp.register_placement(obj, ranges)
        placement.entries.append((label, ranges))
        for s, (lo, hi) in enumerate(ranges):
            placement.socket_bytes[s] += (hi - lo) * bytes_per_row
    return placement
