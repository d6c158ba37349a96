"""Serving latency metrics: TTFT / TPOT percentiles and goodput.

Shared by ``repro_torch.launch.serve`` (and the reference's benchmarks) so
the serve entry point and the benchmark report identical numbers for identical
traffic.  All request timestamps are engine-clock seconds — which clock
that is depends on the engine: ``clock="virtual"`` (a deterministic
phase cost model) or ``clock="wall"`` (real time).  ``wall_duration``
carries the real elapsed seconds alongside the engine-clock ``duration``
when both are known, so a virtual-clock report can still state how long
the simulation itself took.

:meth:`LatencyReport.to_dict` is the stable JSON schema
(``repro.serving.latency_report/1``) consumed by ``benchmarks/run.py
--json`` and the metrics exposition; :meth:`LatencyReport.publish`
mirrors the report into a :class:`repro.obs.MetricsRegistry`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .request import FinishReason, Request

__all__ = ["PERCENTILES", "percentiles", "slo_met", "LatencyReport"]

PERCENTILES = (50, 90, 99)

SCHEMA = "repro.serving.latency_report/1"


def percentiles(values: Sequence[float],
                ps: Sequence[int] = PERCENTILES) -> Dict[int, float]:
    """{p: value} with linear interpolation; empty input -> NaNs."""
    if len(values) == 0:
        return {p: float("nan") for p in ps}
    arr = np.asarray(list(values), dtype=np.float64)
    return {p: float(np.percentile(arr, p)) for p in ps}


def slo_met(r: Request, slo_ttft: Optional[float] = None,
            slo_tpot: Optional[float] = None) -> bool:
    """True when a served request meets both SLOs.  Single-token
    completions carry a TTFT sample but no TPOT sample (``tpot is
    None``); they cannot violate a TPOT SLO.  An unset SLO is always
    met."""
    if slo_ttft is not None and (r.ttft is None or r.ttft > slo_ttft):
        return False
    if slo_tpot is not None and r.tpot is not None and r.tpot > slo_tpot:
        return False
    return True


@dataclass
class LatencyReport:
    """Aggregate serving metrics over a set of finished requests."""

    n_requests: int
    n_finished: int
    duration: float                  # engine-clock span of the run
    generated_tokens: int
    ttft: Dict[int, float]           # percentile -> seconds
    tpot: Dict[int, float]
    goodput: float                   # SLO-meeting finished requests / second
    n_shed: int = 0                  # rejected by admission, never executed
    n_degraded: int = 0              # served with admission-shrunk budgets
    clock: str = "virtual"           # what the request timestamps are in
    wall_duration: Optional[float] = None  # real elapsed seconds, if known
    ttft_samples: Tuple[float, ...] = field(default=(), repr=False)
    tpot_samples: Tuple[float, ...] = field(default=(), repr=False)

    @classmethod
    def from_requests(cls, requests: Sequence[Request], *,
                      duration: Optional[float] = None,
                      slo_ttft: Optional[float] = None,
                      slo_tpot: Optional[float] = None,
                      clock: str = "virtual",
                      wall_duration: Optional[float] = None
                      ) -> "LatencyReport":
        done = [r for r in requests if r.finish_time is not None]
        # aborted and shed requests count as finished but never as served
        # or as goodput: cancelling stragglers (or rejecting arrivals at
        # the door) must not flatter the percentiles
        served = [r for r in done
                  if r.finish_reason not in (FinishReason.ABORTED,
                                             FinishReason.SHED)
                  and r.ttft is not None]
        if duration is None:
            t0 = min((r.arrival_time for r in requests), default=0.0)
            t1 = max((r.finish_time for r in done), default=0.0)
            duration = max(t1 - t0, 0.0)
        good = [r for r in served if slo_met(r, slo_ttft, slo_tpot)]
        ttft_samples = tuple(float(r.ttft) for r in served)
        tpot_samples = tuple(float(r.tpot) for r in served
                             if r.tpot is not None)
        return cls(
            n_requests=len(requests),
            n_finished=len(done),
            duration=duration,
            # served only: tokens of cancelled stragglers must not inflate
            # the reported throughput of completed work
            generated_tokens=sum(r.n_generated for r in served),
            ttft=percentiles(ttft_samples),
            tpot=percentiles(tpot_samples),
            goodput=len(good) / duration if duration > 0 else 0.0,
            n_shed=sum(1 for r in done
                       if r.finish_reason is FinishReason.SHED),
            n_degraded=sum(1 for r in served if r.degraded),
            clock=clock,
            wall_duration=wall_duration,
            ttft_samples=ttft_samples,
            tpot_samples=tpot_samples,
        )

    @property
    def throughput(self) -> float:
        """Generated tokens per engine-clock second."""
        if self.duration <= 0:
            return 0.0
        return self.generated_tokens / self.duration

    def to_dict(self) -> dict:
        """Stable JSON-safe schema (NaN percentiles become ``None``)."""
        clean = lambda v: None if not np.isfinite(v) else float(v)
        return {
            "schema": SCHEMA,
            "n_requests": int(self.n_requests),
            "n_finished": int(self.n_finished),
            "n_shed": int(self.n_shed),
            "n_degraded": int(self.n_degraded),
            "clock": self.clock,
            "duration_s": float(self.duration),
            "wall_duration_s": (None if self.wall_duration is None
                                else float(self.wall_duration)),
            "generated_tokens": int(self.generated_tokens),
            "throughput_tok_s": float(self.throughput),
            "goodput_req_s": float(self.goodput),
            "ttft_s": {f"p{p}": clean(v)
                       for p, v in sorted(self.ttft.items())},
            "tpot_s": {f"p{p}": clean(v)
                       for p, v in sorted(self.tpot.items())},
        }

    def publish(self, registry) -> None:
        """Mirror this report into a :class:`repro_torch.obs.MetricsRegistry`:
        TTFT/TPOT histograms on the explicit SLO buckets plus
        request/token counters and throughput/goodput gauges."""
        from repro_torch.obs import TPOT_BUCKETS, TTFT_BUCKETS

        registry.histogram(
            "repro_ttft_seconds", "Time to first token",
            buckets=TTFT_BUCKETS).observe_many(self.ttft_samples)
        registry.histogram(
            "repro_tpot_seconds", "Time per output token",
            buckets=TPOT_BUCKETS).observe_many(self.tpot_samples)
        registry.counter(
            "repro_requests_total",
            "Finished requests by outcome").inc(
                self.n_finished - self.n_shed, outcome="served")
        if self.n_shed:
            registry.counter("repro_requests_total",
                             "Finished requests by outcome").inc(
                                 self.n_shed, outcome="shed")
        if self.n_degraded:
            registry.counter("repro_requests_total",
                             "Finished requests by outcome").inc(
                                 self.n_degraded, outcome="degraded")
        registry.counter(
            "repro_generated_tokens_total",
            "Tokens generated by served requests").inc(
                self.generated_tokens)
        registry.gauge(
            "repro_throughput_tokens_per_second",
            "Generated tokens per engine-clock second").set(
                self.throughput)
        registry.gauge(
            "repro_goodput_requests_per_second",
            "SLO-meeting finished requests per second").set(self.goodput)

    def lines(self, prefix: str = "[serve]") -> list:
        fmt = lambda d: " ".join(
            f"p{p}={v * 1e3:.2f}ms" for p, v in sorted(d.items()))
        extra = ""
        if self.n_shed or self.n_degraded:
            extra = f" (shed {self.n_shed}, degraded {self.n_degraded})"
        return [
            f"{prefix} finished {self.n_finished}/{self.n_requests} requests, "
            f"{self.generated_tokens} tokens in {self.duration:.3f}s "
            f"({self.throughput:.1f} tok/s, goodput {self.goodput:.2f} req/s)"
            f"{extra}",
            f"{prefix} ttft {fmt(self.ttft)}",
            f"{prefix} tpot {fmt(self.tpot)}",
        ]
