"""The one keyed EMA performance-ratio table (paper §2.1, Eq. 2).

``RatioTable`` subsumes the seed's ``core.scheduler.CPURuntime`` (keyed by
primary ISA) and ``core.balance.DeviceRuntime`` (keyed by program name): a
key is *any* domain string naming one balancing context — an ISA, a jitted
program, an MoE layer, a replica group.  Every key owns one length-``n``
ratio vector updated by the paper's loop:

    observed speed -> normalize -> EMA filter (alpha)          (Eq. 2)

Two observation modes share one normalization rule (``normalize``):

* ``update(key, times)`` — the paper's literal Eq. 2: work this round was
  assigned proportionally to the current table, so worker ``i``'s
  demonstrated speed is ``pr_i / t_i``.
* ``update(key, times, units=...)`` — generalized Eq. 2: ``units`` is the
  work each worker actually received (microbatch counts, request counts),
  removing the proportional-assignment assumption: speed is ``u_i / t_i``.

``normalize="mean"`` scales observations so the valid entries average 1
(the paper's Fig. 4 convention: an all-ones table on a homogeneous machine);
``normalize="sum"`` makes them sum to 1 (the literal Eq. 2 form, also the
natural convention for load *fractions* such as MoE expert shares).

``RatioStore`` persists a table as JSON so ratios warm-start across
processes — the paper keeps tables alive across kernels within one run; we
additionally keep them alive across runs.

This module is the single ``ema_update`` call path in the repository.
"""

# lint: virtual-clock-module
from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional

import numpy as np

from repro_torch.analysis import invariants as _contracts
from repro_torch.core import events as _ev
from repro_torch.core.ratio import ema_update, observed_ratios

__all__ = ["RatioTable", "RatioStore"]

_NORMALIZE_MODES = ("mean", "sum")


class RatioTable:
    """Keyed EMA performance-ratio tables over ``n_workers`` workers."""

    def __init__(self, n_workers: int, alpha: float = 0.3,
                 init_ratio: float = 1.0, normalize: str = "mean",
                 max_history: int = 512):
        if n_workers < 1:
            raise ValueError("need at least one worker")
        if normalize not in _NORMALIZE_MODES:
            raise ValueError(f"normalize must be one of {_NORMALIZE_MODES}")
        if max_history < 1:
            raise ValueError("max_history must be >= 1")
        self.n_workers = n_workers
        self.alpha = alpha
        self.init_ratio = init_ratio
        self.normalize = normalize
        self.max_history = max_history
        self._tables: Dict[str, np.ndarray] = {}
        self.history: Dict[str, list] = {}

    # ------------------------------------------------------------- access --
    def keys(self) -> list:
        return list(self._tables)

    def ratios(self, key: str) -> np.ndarray:
        """The current table for ``key`` (created at ``init_ratio`` on first
        use — the paper initializes every ratio to 1)."""
        if key not in self._tables:
            self._tables[key] = np.full(self.n_workers,
                                        float(self.init_ratio))
            self.history[key] = [self._tables[key].copy()]
        return self._tables[key]

    def set(self, key: str, values) -> np.ndarray:
        """Overwrite ``key``'s table (warm start / test injection)."""
        values = np.asarray(values, dtype=np.float64)
        if values.shape != (self.n_workers,):
            raise ValueError(
                f"expected shape ({self.n_workers},), got {values.shape}")
        self.ratios(key)  # ensure history exists
        self._tables[key] = values.copy()
        self._record(key, self._tables[key])
        return self._tables[key]

    # ------------------------------------------------------------- update --
    def update(self, key: str, times, units=None) -> np.ndarray:
        """One Eq.-2 + EMA step from observed wall times; returns the new
        table.  Workers with ``t_i <= 0`` (or ``units_i <= 0``) received no
        work; their ratio is carried over unchanged."""
        pr = self.ratios(key)
        times = np.asarray(times, dtype=np.float64)
        if times.shape != pr.shape:
            raise ValueError("times must have one entry per worker")
        if units is None:
            observed = observed_ratios(pr, times, normalize=self.normalize)
            if _contracts.contracts_enabled():
                valid = np.isfinite(times) & (times > 0) & (pr > 0)
                _contracts.check_observation(observed, valid, self.normalize,
                                             where=f"RatioTable.update[{key}]")
        else:
            units = np.asarray(units, dtype=np.float64)
            if units.shape != pr.shape:
                raise ValueError("units must have one entry per worker")
            valid = np.isfinite(times) & (times > 0) & (units > 0)
            observed = pr.copy()
            # like observed_ratios: a singleton measurement on a multi-
            # worker table carries no relative information; carry over
            # instead of normalizing it to 1.0 (which would EMA-erase
            # learned heterogeneity whenever one worker runs alone)
            if valid.sum() >= 2 or (valid.any() and self.n_workers == 1):
                speed = np.zeros_like(pr)
                speed[valid] = units[valid] / times[valid]
                denom = speed[valid].sum()
                if denom > 0:
                    scale = (float(valid.sum()) if self.normalize == "mean"
                             else 1.0)
                    observed[valid] = speed[valid] / denom * scale
            if _contracts.contracts_enabled():
                _contracts.check_observation(observed, valid, self.normalize,
                                             where=f"RatioTable.update[{key}]")
        return self.observe(key, observed)

    def observe(self, key: str, observed) -> np.ndarray:
        """EMA-filter an externally computed observation into ``key``'s
        table (e.g. MoE load fractions, where the observation is a share
        vector rather than a time vector).  This is the repository's single
        ``ema_update`` call site."""
        pr = self.ratios(key)
        observed = np.asarray(observed, dtype=np.float64)
        if _ev.TRACER is not None:
            _ev.emit_read(self, f"tables[{key}]", where="RatioTable.observe")
            _ev.emit_write(self, f"tables[{key}]", where="RatioTable.observe")
        new = ema_update(pr, observed, self.alpha)  # lint: allow(RL005)
        if _contracts.contracts_enabled():
            _contracts.check_ema_step(pr, observed, new,
                                      where=f"RatioTable.observe[{key}]")
        self._tables[key] = new
        self._record(key, new)
        return new

    def _record(self, key: str, table: np.ndarray) -> None:
        h = self.history[key]
        h.append(table.copy())
        if len(h) > self.max_history:
            del h[: len(h) - self.max_history]

    # -------------------------------------------------------- persistence --
    def to_json(self) -> str:
        return json.dumps({
            "version": 1,
            "n_workers": self.n_workers,
            "alpha": self.alpha,
            "init_ratio": self.init_ratio,
            "normalize": self.normalize,
            "tables": {k: v.tolist() for k, v in self._tables.items()},
        }, indent=2)

    @classmethod
    def from_json(cls, text: str, **overrides) -> "RatioTable":
        doc = json.loads(text)
        if doc.get("version") != 1:
            raise ValueError(f"unknown ratio-table version {doc.get('version')}")
        kwargs = dict(n_workers=doc["n_workers"], alpha=doc["alpha"],
                      init_ratio=doc.get("init_ratio", 1.0),
                      normalize=doc.get("normalize", "mean"))
        kwargs.update(overrides)
        table = cls(**kwargs)
        for key, values in doc["tables"].items():
            table.set(key, np.asarray(values, dtype=np.float64))
        return table


class RatioStore:
    """Atomic JSON persistence for a :class:`RatioTable` at a fixed path."""

    def __init__(self, path: str):
        self.path = path

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def save(self, table: RatioTable) -> None:
        """Write-then-rename so a crashed writer never leaves a torn file."""
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(table.to_json())
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def load(self, **overrides) -> Optional[RatioTable]:
        """Reconstruct the stored table, or ``None`` if nothing is stored."""
        if not self.exists():
            return None
        with open(self.path) as f:
            return RatioTable.from_json(f.read(), **overrides)

    def load_into(self, table: RatioTable, active=None) -> bool:
        """Warm-start an existing table from the store.  Returns False (and
        leaves ``table`` untouched) when nothing compatible is stored.

        Compatible means same worker count *and* same learning conventions:
        a sum-normalized table loaded into a mean-normalized one (or vice
        versa) is off by a factor of ``n_workers`` and would corrupt the
        learned ratios, and a different ``alpha`` silently changes the
        filter the stored history was produced under — both are refused
        rather than blended.

        ``active`` (a boolean mask over ``table``'s full worker width)
        reconciles the *same machine* saved under a different capacity
        state — e.g. a table saved while some cores were parked, or loaded
        while some now are:

        * *expand* — ``active`` has ``table.n_workers`` entries and the
          store's width equals its True count: the store was saved by an
          active-width table; stored values land in the active positions,
          inactive workers keep their current (init or learned) ratios.
        * *compress* — ``active`` has ``stored.n_workers`` entries and the
          table's width equals its True count: the store is full-width but
          the live table only spans the active cores; the stored vector is
          projected down via ``stored[mask]``.

        Any other width combination is a genuinely different machine and
        is refused, exactly as before.  (The preferred design keeps tables
        full-width and masks planning instead — see
        ``ProportionalPolicy.active`` — so parked cores keep their stored
        ratios without any projection at all.)

        A torn or corrupt file (a crashed writer predating the atomic
        rename, or a truncated copy) is treated as "nothing stored":
        warm-start is an optimization, so a cold start beats crashing the
        serve."""
        try:
            stored = self.load()
        except (json.JSONDecodeError, KeyError, TypeError, ValueError):
            return False
        if (stored is None or stored.normalize != table.normalize
                or stored.alpha != table.alpha):
            return False
        if stored.n_workers == table.n_workers:
            for key in stored.keys():
                table.set(key, stored.ratios(key))
            return True
        if active is None:
            return False
        mask = np.asarray(active, dtype=bool)
        if (mask.shape == (table.n_workers,)
                and stored.n_workers == int(mask.sum())):
            # expand: active-width store -> full-width table
            for key in stored.keys():
                values = table.ratios(key).copy()
                values[mask] = stored.ratios(key)
                table.set(key, values)
            return True
        if (mask.shape == (stored.n_workers,)
                and table.n_workers == int(mask.sum())):
            # compress: full-width store -> active-width table
            for key in stored.keys():
                table.set(key, stored.ratios(key)[mask])
            return True
        return False  # not a masked view of this machine: refuse
