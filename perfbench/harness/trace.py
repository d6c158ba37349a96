"""Reduction of a ``torch.profiler`` slice to what the metrics read: the
device's operations with their times, the iterations and the host's
``perfbench.*`` ranges on the same time base, the device's busy time as
the union of its operations' intervals, and the idle gaps named by the
host range that overlaps them most.

Each iteration ends in a synchronize, so an operation that starts inside
an iteration's host range belongs to that iteration.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

Span = Tuple[str, int, int]       # (name, start ns, end ns)


@dataclass
class Slice:
    """A profiled stretch of the window: ``start``..``end`` ns."""

    start: int
    end: int
    device: List[Span] = field(default_factory=list)
    iterations: List[Tuple[int, int]] = field(default_factory=list)
    host: List[Span] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        out: List[Tuple[int, int]] = []
        for _, s, e in sorted(self.device, key=lambda d: d[1]):
            s, e = max(s, self.start), min(e, self.end)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def by_iteration(self) -> List[List[Span]]:
        """The device operations of each iteration, by start time."""
        starts = [s for s, _ in self.iterations]
        out: List[List[Span]] = [[] for _ in self.iterations]
        for op in self.device:
            i = bisect.bisect_right(starts, op[1]) - 1
            if 0 <= i < len(out):
                out[i].append(op)
        return out

    def device_ops(self, n: int = 10) -> List[list]:
        """The ``n`` device operations that took most time, by name."""
        tot: Dict[str, float] = {}
        for name, s, e in self.device:
            tot[name] = tot.get(name, 0.0) + (e - s) * 1e-9
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v] for k, v in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle seconds of the device, summed by the name of the host range
        that overlaps each gap most (``harness`` where none does: the
        benchmark's own bookkeeping between iterations)."""
        busy = self.busy_intervals()
        gaps, t = [], self.start
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < self.end:
            gaps.append((t, self.end))
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        tot: Dict[str, float] = {}
        for gs, ge in gaps:
            best, name = 0, "harness"
            # the host ranges are short and seldom nested: the last few to
            # start before the gap ends hold the one that overlaps it most
            hi = bisect.bisect_left(starts, ge)
            for hn, hs, he in host[max(0, hi - 8):hi]:
                ov = min(he, ge) - max(hs, gs)
                if ov > best:
                    best, name = ov, hn
            tot[name] = tot.get(name, 0.0) + (ge - gs) * 1e-9
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v] for k, v in top]


def _events(prof):
    """(name, on the device, an annotation, start ns, end ns) of every
    event of a stopped profiler, from its raw Kineto results."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        # a record_function range also shows on the device's timeline as
        # an annotation, which is no device operation
        yield (e.name(), e.device_type() == DeviceType.CUDA,
               e.is_user_annotation(), start, start + e.duration_ns())


def reduce(prof) -> Slice:
    """The slice a stopped profiler holds: its span is that of its
    ``perfbench.iteration`` ranges."""
    device, host, iters = [], [], []
    for name, on_device, note, s, e in _events(prof):
        if on_device:
            if not note and not name.startswith("perfbench."):
                device.append((name, s, e))
        elif name == "perfbench.iteration":
            iters.append((s, e))
        elif name.startswith("perfbench."):
            host.append((name[len("perfbench."):], s, e))
    iters.sort()
    if not iters:
        return Slice(start=0, end=0)
    return Slice(start=iters[0][0], end=iters[-1][1], device=device,
                 iterations=iters, host=host)
