"""What a cell is: its entry in ``BENCHMARK.json`` and the data files the
harness finds by the names there.

* ``perfbench/configs/<config>.json`` (the ``file`` of the configuration):
  the model's sizes as run (``model``), the port's architecture and any
  field of the port's configuration set for this deployment (``arch``,
  ``port``), the reference that computes it (``reference``) and the
  deployment (``deployment``).
* ``perfbench/traffic/<traffic>.json``: the traffic mix, read by the
  generator module named by its ``kind``.
* ``perfbench/checks/<workload>.json``: the number that decides
  ``correct`` and its limit, with the readings the limit was set from.
* ``perfbench/metrics/<metric>.py``: one reader per per-layer metric.

Nothing here imports the program.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]   # the checkout


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict          # the configuration file
    traffic: dict         # the traffic file
    check: dict           # the correctness limit file
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)
    root: Path = ROOT

    @property
    def bench_dir(self) -> Path:
        return self.root / "perfbench"


def _read(path: Path) -> dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str, reported: List[str]) -> bool:
    """A metric with ``workloads`` is the listed cells'; an end-to-end one
    without it every cell's; a per-layer one without it every cell's that
    reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load_cell(name: str, root: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``."""
    root = Path(root) if root is not None else ROOT
    bench = _read(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read(root / configs[w["config"]]["file"])
    traffic = _read(root / "perfbench" / "traffic" / f"{w['traffic']}.json")
    check = _read(root / "perfbench" / "checks" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, check=check, end_to_end=e2e,
                per_layer=per_layer, root=root)


def metric_reader_path(cell: Cell, metric: str) -> Path:
    return cell.bench_dir / "metrics" / f"{metric}.py"


def units(cell: Cell) -> Dict[str, str]:
    return {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
