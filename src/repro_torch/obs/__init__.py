"""Observability substrate: virtual-clock tracing, metrics, flight recorder.

Three independent parts, all publishing through the :mod:`repro_torch.core.events`
shim so instrumented call sites stay a single global load when disabled:

* :class:`SpanTracer` (:mod:`repro_torch.obs.trace`) — spans and counter tracks on
  the shared virtual clock, exported as Chrome/Perfetto ``trace_event`` JSON.
* :class:`MetricsRegistry` (:mod:`repro_torch.obs.metrics`) — counters, gauges and
  explicit-bucket histograms with Prometheus text exposition and a one-shot
  JSON dump.
* :class:`FlightRecorder` (:mod:`repro_torch.obs.recorder`) — a bounded ring of
  recent balancer decisions dumped to disk when an SLO burn or an invariant
  contract (IV00x) trips.
"""

from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               TPOT_BUCKETS, TTFT_BUCKETS, lint_exposition)
from repro_torch.obs.recorder import DecisionRecord, FlightRecorder
from repro_torch.obs.trace import SpanTracer, validate_trace

__all__ = [
    "SpanTracer",
    "validate_trace",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "TTFT_BUCKETS",
    "TPOT_BUCKETS",
    "lint_exposition",
    "FlightRecorder",
    "DecisionRecord",
]
