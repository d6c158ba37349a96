"""What a per-layer metric's reader gets: the run as the harness recorded
it, and helpers over it.  A reader is ``perfbench/metrics/<name>.py`` with
``read(view) -> float | None``; None leaves the metric out of the line.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from perfbench.harness import work


def kernel_names(sources: Sequence[Path]) -> List[str]:
    """The ``__global__`` functions of the program's CUDA sources."""
    names = []
    for src in sources:
        text = Path(src).read_text(encoding="utf-8")
        names += re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
                            text)
    return sorted(set(names))


@dataclass
class View:
    cell: object
    model: work.Model
    slots: int
    seconds: float
    origin: float
    close: float
    iters: list                 # the window's iterations (Iter)
    requests: list              # every Req of the run
    trace: Optional[object] = None           # trace.Slice
    traced_iters: list = field(default_factory=list)  # Iter of each slice one
    q4_kernels: List[str] = field(default_factory=list)
    port_kernels: List[str] = field(default_factory=list)

    # ------------------------------------------------------------- window --
    def decode_steps(self) -> list:
        return [it for it in self.iters if it.rows]

    def chunks(self) -> list:
        return [it for it in self.iters if it.prefill is not None]

    def due_in_window(self) -> list:
        return [r for r in self.requests
                if r.due is not None and 0.0 <= r.due < self.seconds]

    def mean_part(self, iters, key: str) -> Optional[float]:
        vals = [it.parts[key] for it in iters if key in it.parts]
        return sum(vals) / len(vals) if vals else None

    def mfu_percent(self) -> Optional[float]:
        """The least time the window's work needs on the card, over the
        window: a share of the peak."""
        if not self.iters:
            return None
        least = sum(work.iteration_bound_s(self.model, it.prefill,
                                           it.decode_ctx)
                    for it in self.iters)
        return 100.0 * least / self.seconds

    # -------------------------------------------------------------- trace --
    def is_q4(self, name: str) -> bool:
        return any(k in name for k in self.q4_kernels)

    def is_port(self, name: str) -> bool:
        return any(k in name for k in self.port_kernels)

    def traced(self) -> List[Tuple[object, list]]:
        """(Iter, its device operations) of every iteration of the slice."""
        if self.trace is None or \
                len(self.traced_iters) != len(self.trace.iterations):
            return []
        return list(zip(self.traced_iters, self.trace.by_iteration()))

    def idle_percent(self) -> Optional[float]:
        if self.trace is None or self.trace.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)

    def q4_roofline_percent(self, decode_only: bool) -> Optional[float]:
        """Σ the Q4_0 launches' bounds over Σ their device time, over the
        slice's iterations whose Q4_0 launches are the ones their work
        needs (one for each product of each layer and the head)."""
        bound = spent = 0.0
        for it, ops in self.traced():
            if decode_only and (it.prefill is not None or not it.rows):
                continue
            q4 = [op for op in ops if self.is_q4(op[0])]
            launches = work.q4_launches(
                self.model, it.prefill[1] if it.prefill else None, it.rows)
            if not launches or len(q4) != len(launches):
                continue
            bound += work.q4_bound_s(launches)
            spent += sum(e - s for _, s, e in q4) * 1e-9
        return 100.0 * bound / spent if spent > 0 else None
