# lint: virtual-clock-module
"""Anomaly flight recorder: a bounded ring of recent balancer decisions.

Instrumented call sites publish decisions through
``repro_torch.core.events.record`` — ratio-table updates, offset refreshes,
capacity (park/DVFS) windows, admission verdicts, node fail/recover, and
per-request latency observations.  The recorder keeps the last ``capacity``
of them; when an SLO burn (``burn_window`` consecutive violating latency
records) or an invariant contract (IV00x, see
:mod:`repro_torch.analysis.invariants`) trips, the ring is dumped to disk so
"goodput dipped at t=41s" becomes a replayable decision log instead of a
shrug.

The recorder never raises out of ``record``/``trip`` — observability must
not take down the serve loop it is observing.
"""

from __future__ import annotations

import json
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

__all__ = ["DecisionRecord", "FlightRecorder"]


@dataclass(frozen=True)
class DecisionRecord:
    """One recorded decision on the virtual clock."""

    seq: int
    t: float
    kind: str      # "ratio" | "offsets" | "capacity" | "admission" |
    #                "node_event" | "latency" | ...
    key: str       # ratio-table key, offset spec name, node/core name, ...
    payload: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"seq": self.seq, "t": self.t, "kind": self.kind,
                "key": self.key, **({"payload": self.payload}
                                    if self.payload else {})}


class FlightRecorder:
    """Bounded decision ring with SLO-burn self-trip.

    ``slo_ttft``/``slo_tpot`` arm the burn detector: a ``latency`` record
    whose payload violates either SLO increments a streak, any compliant
    one resets it, and ``burn_window`` consecutive violations trip the
    recorder.  ``path`` is where :meth:`trip` dumps the ring (one JSON
    object); without a path the dump is kept on ``last_dump``.
    """

    def __init__(self, capacity: int = 256, *, path: Optional[str] = None,
                 slo_ttft: Optional[float] = None,
                 slo_tpot: Optional[float] = None,
                 burn_window: int = 8):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = int(capacity)
        self.path = path
        self.slo_ttft = slo_ttft
        self.slo_tpot = slo_tpot
        self.burn_window = int(burn_window)
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self._streak = 0
        self.trips: list[dict] = []
        self.last_dump: Optional[dict] = None

    def __len__(self) -> int:
        return len(self._ring)

    def record(self, kind: str, key: str, t: float, payload: dict) -> None:
        self._seq += 1
        self._ring.append(DecisionRecord(
            seq=self._seq, t=float(t), kind=str(kind), key=str(key),
            payload=dict(payload) if payload else {}))
        if kind == "latency" and (self.slo_ttft is not None
                                  or self.slo_tpot is not None):
            self._observe_slo(payload, float(t))

    def _observe_slo(self, payload: dict, t: float) -> None:
        ttft = payload.get("ttft")
        tpot = payload.get("tpot")
        bad = ((self.slo_ttft is not None and ttft is not None
                and ttft > self.slo_ttft)
               or (self.slo_tpot is not None and tpot is not None
                   and tpot > self.slo_tpot))
        if not bad:
            self._streak = 0
            return
        self._streak += 1
        if self._streak >= self.burn_window:
            self._streak = 0
            self.trip(f"slo_burn: {self.burn_window} consecutive "
                      f"SLO-violating requests", t=t)

    def records(self) -> list:
        return list(self._ring)

    def snapshot(self, reason: str, t: Optional[float] = None) -> dict:
        return {
            "schema": "repro.obs.flight_recorder/1",
            "reason": reason,
            "t": t,
            "n_records": len(self._ring),
            "n_dropped": max(0, self._seq - len(self._ring)),
            "records": [r.to_dict() for r in self._ring],
        }

    def trip(self, reason: str, t: Optional[float] = None) -> dict:
        """Dump the ring (to ``path`` when set); never raises."""
        dump = self.snapshot(reason, t)
        self.trips.append({"reason": reason, "t": t, "seq": self._seq})
        self.last_dump = dump
        if self.path:
            try:
                with open(self.path, "w") as f:
                    json.dump(dump, f, indent=2, sort_keys=True)
                    f.write("\n")
            except OSError:
                pass
        return dump
