"""Per-kernel configuration tuner — the TPU analogue of per-ISA tables.

The paper keys its performance tables by ISA because P- and E-cores have
different relative throughput per instruction family.  A TPU chip is
internally homogeneous, but a Pallas kernel has the same phenomenon one
level up: the best *block configuration* (BlockSpec tile shapes) depends on
the problem shape and on which resource (MXU vs VMEM bandwidth) binds.  The
tuner keeps an EMA of measured runtime per (kernel, shape-class, config) and
selects the argmin config at dispatch time — converging online exactly like
the paper's ratio table, and re-adapting if the environment drifts.
"""

from __future__ import annotations

import json
import math
import os
import tempfile
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Hashable, Optional, Sequence, Tuple

from repro_torch.core import events as _ev

__all__ = ["KernelTuner", "TunerStore", "shape_class"]


def shape_class(*dims: int) -> Tuple[int, ...]:
    """Bucket a shape so that near-identical problems share a table entry
    (next power of two per dim)."""
    return tuple(1 << max(0, math.ceil(math.log2(max(d, 1)))) for d in dims)


@dataclass
class _Entry:
    ema: float = math.inf
    count: int = 0


class KernelTuner:
    """Online EMA argmin over candidate configs.

    ``alpha`` follows the paper's filter (new measurement weighted 1-alpha).
    Exploration: until every candidate has ``min_trials`` measurements, the
    least-measured config is chosen (round-robin warmup, mirroring the
    paper's "ratios start at 1 and converge within a few kernels").
    """

    def __init__(self, alpha: float = 0.3, min_trials: int = 2):
        self.alpha = alpha
        self.min_trials = min_trials
        self._tables: Dict[Hashable, Dict[Hashable, _Entry]] = {}
        # shard dispatch reports from worker threads concurrently; the
        # read-modify-write of an entry's EMA must not interleave
        self._lock = threading.Lock()

    def _table(self, key: Hashable, configs: Sequence[Hashable]):
        tab = self._tables.setdefault(key, {})
        for c in configs:
            tab.setdefault(c, _Entry())
        return tab

    def select(self, key: Hashable, configs: Sequence[Hashable]) -> Hashable:
        with self._lock:
            if _ev.TRACER is not None:
                _ev.emit_acquire(self._lock, where="KernelTuner.select")
                _ev.emit_read(self, "tables", where="KernelTuner.select")
                _ev.emit_release(self._lock, where="KernelTuner.select")
            tab = self._table(key, configs)
            cold = [c for c in configs if tab[c].count < self.min_trials]
            if cold:
                return min(cold, key=lambda c: tab[c].count)
            return min(configs, key=lambda c: tab[c].ema)

    def report(self, key: Hashable, config: Hashable, seconds: float) -> None:
        with self._lock:
            if _ev.TRACER is not None:
                _ev.emit_acquire(self._lock, where="KernelTuner.report")
                _ev.emit_read(self, "tables", where="KernelTuner.report")
                _ev.emit_write(self, "tables", where="KernelTuner.report")
            e = self._tables.setdefault(key, {}).setdefault(config, _Entry())
            if e.count == 0 or not math.isfinite(e.ema):
                e.ema = seconds
            else:
                e.ema = self.alpha * e.ema + (1.0 - self.alpha) * seconds
            e.count += 1
            if _ev.TRACER is not None:
                _ev.emit_release(self._lock, where="KernelTuner.report")

    def best(self, key: Hashable) -> Hashable:
        with self._lock:
            tab = self._tables.get(key)
            if not tab:
                raise KeyError(f"no measurements for {key!r}")
            return min(tab, key=lambda c: tab[c].ema)

    # -------------------------------------------------------- persistence --
    def to_json(self) -> str:
        """Measured entries only (count > 0) as JSON — the block-shape
        analogue of :meth:`repro_torch.runtime.RatioTable.to_json`, so tuned
        tables warm-start across processes like ratio tables do."""
        with self._lock:
            records = []
            for key, tab in self._tables.items():
                configs = [
                    {"config": _encode(c), "ema": e.ema, "count": e.count}
                    for c, e in tab.items() if e.count > 0
                ]
                if configs:
                    records.append({"key": _encode(key), "configs": configs})
        return json.dumps({
            "version": 1,
            "alpha": self.alpha,
            "min_trials": self.min_trials,
            "tables": records,
        }, indent=2)

    @classmethod
    def from_json(cls, text: str, **overrides) -> "KernelTuner":
        doc = json.loads(text)
        if doc.get("version") != 1:
            raise ValueError(f"unknown tuner-table version {doc.get('version')}")
        kwargs = dict(alpha=doc["alpha"], min_trials=doc["min_trials"])
        kwargs.update(overrides)
        tuner = cls(**kwargs)
        for rec in doc["tables"]:
            tab = tuner._tables.setdefault(_decode(rec["key"]), {})
            for c in rec["configs"]:
                tab[_decode(c["config"])] = _Entry(ema=float(c["ema"]),
                                                   count=int(c["count"]))
        return tuner


def _encode(obj):
    """Tuner keys/configs are (nested) tuples of str/int; JSON stores them
    as (nested) lists."""
    if isinstance(obj, tuple):
        return [_encode(o) for o in obj]
    return obj


def _decode(obj):
    if isinstance(obj, list):
        return tuple(_decode(o) for o in obj)
    return obj


class TunerStore:
    """Atomic JSON persistence for a :class:`KernelTuner` at a fixed path
    (mirrors :class:`repro_torch.runtime.RatioStore`)."""

    def __init__(self, path: str):
        self.path = path

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def save(self, tuner: KernelTuner) -> None:
        """Write-then-rename so a crashed writer never leaves a torn file."""
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(tuner.to_json())
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def load(self, **overrides) -> Optional[KernelTuner]:
        if not self.exists():
            return None
        with open(self.path) as f:
            return KernelTuner.from_json(f.read(), **overrides)

    def load_into(self, tuner: KernelTuner) -> bool:
        """Warm-start an existing tuner from the store.  Returns False (and
        leaves ``tuner`` untouched) when nothing compatible is stored — a
        different ``alpha`` changes the filter the stored EMAs were
        produced under and is refused rather than blended (same contract
        as :meth:`repro_torch.runtime.RatioStore.load_into`).  A torn or corrupt
        file (a crashed writer predating the atomic rename, or a truncated
        copy) is treated as "nothing stored": warm-start is an
        optimization, so a cold start beats crashing the serve."""
        try:
            stored = self.load()
        except (json.JSONDecodeError, KeyError, TypeError, ValueError):
            return False
        if stored is None or stored.alpha != tuner.alpha:
            return False
        with tuner._lock:
            for key, tab in stored._tables.items():
                dst = tuner._tables.setdefault(key, {})
                for c, e in tab.items():
                    dst[c] = _Entry(ema=e.ema, count=e.count)
        return True
