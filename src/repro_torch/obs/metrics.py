"""Metrics registry: counters, gauges, explicit-bucket histograms.

Deliberately tiny and dependency-free — the Prometheus *text exposition
format* without the client library.  All layers publish into one
:class:`MetricsRegistry` at report time (``LatencyReport.publish``, the
serve driver, the benchmarks), so the hot paths never see a metric object.

TTFT/TPOT get explicit buckets matched to the repo's SLOs (2.0 s TTFT,
0.25 s TPOT in the fleet driver): enough resolution below the SLO to see a
burn coming, a few buckets above it to size the violation.
"""

from __future__ import annotations

import json
import re
from bisect import bisect_left
from typing import Dict, Iterable, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "TTFT_BUCKETS",
    "TPOT_BUCKETS",
    "lint_exposition",
]

# Upper bounds in seconds; +Inf is implicit.
TTFT_BUCKETS = (0.1, 0.25, 0.5, 1.0, 1.5, 2.0, 3.0, 5.0, 10.0)
TPOT_BUCKETS = (0.025, 0.05, 0.1, 0.15, 0.2, 0.25, 0.4, 0.8, 1.6)


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Counter:
    """Monotone counter; one series per label set."""

    kind = "counter"

    def __init__(self, name: str, help: str):
        self.name = name
        self.help = help
        self._series: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} decreased by {amount}")
        key = tuple(sorted(labels.items()))
        self._series[key] = self._series.get(key, 0.0) + float(amount)

    def value(self, **labels: str) -> float:
        return self._series.get(tuple(sorted(labels.items())), 0.0)

    def samples(self):
        for key, v in self._series.items():
            yield self.name, dict(key), v

    def to_json(self):
        return [{"labels": dict(k), "value": v}
                for k, v in self._series.items()]


class Gauge(Counter):
    """A value that can go either way (queue depth, ratio weight)."""

    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        self._series[tuple(sorted(labels.items()))] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        self._series[key] = self._series.get(key, 0.0) + float(amount)


class Histogram:
    """Explicit-bucket cumulative histogram (Prometheus semantics)."""

    kind = "histogram"

    def __init__(self, name: str, help: str, buckets: Iterable[float]):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"histogram {self.name} needs >= 1 bucket")
        self._series: Dict[Tuple[Tuple[str, str], ...], list] = {}

    def _cell(self, labels: Dict[str, str]):
        key = tuple(sorted(labels.items()))
        cell = self._series.get(key)
        if cell is None:
            # [per-bucket counts..., +Inf count], total count, sum
            cell = [[0] * (len(self.buckets) + 1), 0, 0.0]
            self._series[key] = cell
        return cell

    def observe(self, value: float, **labels: str) -> None:
        cell = self._cell(labels)
        cell[0][bisect_left(self.buckets, float(value))] += 1
        cell[1] += 1
        cell[2] += float(value)

    def observe_many(self, values: Iterable[float], **labels: str) -> None:
        for v in values:
            self.observe(v, **labels)

    def count(self, **labels: str) -> int:
        key = tuple(sorted(labels.items()))
        return self._series[key][1] if key in self._series else 0

    def samples(self):
        for key, (counts, n, total) in self._series.items():
            labels = dict(key)
            acc = 0
            for b, c in zip(self.buckets, counts):
                acc += c
                yield (f"{self.name}_bucket",
                       {**labels, "le": _fmt_value(b)}, acc)
            yield f"{self.name}_bucket", {**labels, "le": "+Inf"}, n
            yield f"{self.name}_sum", labels, total
            yield f"{self.name}_count", labels, n

    def to_json(self):
        out = []
        for key, (counts, n, total) in self._series.items():
            out.append({
                "labels": dict(key),
                "buckets": {_fmt_value(b): c
                            for b, c in zip(self.buckets, counts)},
                "inf": counts[-1], "count": n, "sum": total,
            })
        return out


class MetricsRegistry:
    """Named metrics with Prometheus text exposition and a JSON dump."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _register(self, metric):
        prev = self._metrics.get(metric.name)
        if prev is not None:
            if type(prev) is not type(metric):
                raise ValueError(
                    f"metric {metric.name!r} re-registered as a different "
                    f"kind ({prev.kind} vs {metric.kind})")
            return prev
        self._metrics[metric.name] = metric
        return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter(name, help))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge(name, help))

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Iterable[float]] = None) -> Histogram:
        return self._register(
            Histogram(name, help, buckets if buckets is not None
                      else TTFT_BUCKETS))

    def get(self, name: str):
        return self._metrics.get(name)

    def prometheus_text(self) -> str:
        """Prometheus text exposition format, version 0.0.4."""
        lines = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for sample_name, labels, value in m.samples():
                lines.append(
                    f"{sample_name}{_fmt_labels(labels)} {_fmt_value(value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def to_json(self) -> dict:
        return {
            name: {"kind": m.kind, "help": m.help, "series": m.to_json()}
            for name, m in sorted(self._metrics.items())
        }

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")


# --------------------------------------------------------- exposition lint --
_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r" (?P<value>[^ ]+)$")


def lint_exposition(text: str) -> list:
    """Check Prometheus text-format exposition; returns problem strings.

    This is the CI "metrics exposition lint": every sample parses, every
    TYPE is known, histograms carry ``_bucket``/``_sum``/``_count`` with an
    ``+Inf`` bucket and non-decreasing cumulative counts.
    """
    problems: list = []
    types: Dict[str, str] = {}
    buckets: Dict[str, list] = {}
    seen_suffix: Dict[str, set] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                problems.append(f"line {lineno}: malformed TYPE line")
            elif not _NAME_OK.match(parts[2]):
                problems.append(f"line {lineno}: bad metric name {parts[2]!r}")
            else:
                types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            problems.append(f"line {lineno}: unknown comment directive")
            continue
        m = _SAMPLE.match(line)
        if not m:
            problems.append(f"line {lineno}: unparseable sample: {line!r}")
            continue
        try:
            float(m.group("value"))
        except ValueError:
            problems.append(f"line {lineno}: non-numeric value "
                            f"{m.group('value')!r}")
        name = m.group("name")
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in types:
                base = name[:-len(suffix)]
                seen_suffix.setdefault(base, set()).add(suffix)
                break
        if base not in types:
            problems.append(f"line {lineno}: sample {name!r} has no TYPE")
            continue
        if types.get(base) == "histogram" and name.endswith("_bucket"):
            labels = m.group("labels") or ""
            le = None
            rest = []
            for pair in labels.split(","):
                if pair.startswith('le="'):
                    le = pair[4:].rstrip('"')
                elif pair:
                    rest.append(pair)
            if le is None:
                problems.append(f"line {lineno}: histogram bucket without le")
            else:
                bound = float("inf") if le == "+Inf" else float(le)
                buckets.setdefault((base, ",".join(sorted(rest))), []).append(
                    (lineno, bound, float(m.group("value"))))
    for base, kind in types.items():
        if kind != "histogram":
            continue
        missing = {"_bucket", "_sum", "_count"} - seen_suffix.get(base, set())
        if missing:
            problems.append(f"histogram {base}: missing series "
                            f"{sorted(missing)}")
    for (base, _rest), series in buckets.items():
        if not any(b == float("inf") for _, b, _ in series):
            problems.append(f"histogram {base}: no +Inf bucket")
        prev = None
        for lineno, bound, value in series:
            if prev is not None and bound > prev[0] and value < prev[1]:
                problems.append(
                    f"line {lineno}: histogram {base} cumulative count "
                    f"decreases at le={bound}")
            prev = (bound, value)
    return problems
