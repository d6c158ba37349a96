"""A later change adds a configuration, a traffic mix or a per-layer metric
as files of its own plus entries in ``BENCHMARK.json``, and edits no file
the benchmark has: here a throwaway mix, metric and cell added in a
temporary copy, run through the harness on the CPU."""

import hashlib
import json

import torch

from perfbench.harness import cell as cell_mod
from perfbench.harness import spec
from perfbench.tests.conftest import make_tiny_root
from perfbench.tests.test_perfbench_faults import Tick


def digests(root):
    return {p.relative_to(root): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in (root / "perfbench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_add_mix_metric_and_cell(tmp_path):
    root = make_tiny_root(tmp_path)
    before = digests(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (root / "perfbench/traffic/tiny-burst.json").write_text(json.dumps({
        "kind": "poisson", "rate": 150.0,
        "prompt": {"dist": "uniform", "lo": 2, "hi": 9},
        "output": {"dist": "uniform", "lo": 2, "hi": 6},
        "slots": 3, "prefill_chunk": 4, "prefill_lanes": 1,
        "sequence_seed": 2}))
    (root / "perfbench/metrics/iterations.burst.py").write_text(
        "def read(view):\n    return float(len(view.iters)) or None\n")
    (root / "perfbench/checks/tiny.burst.json").write_text(json.dumps(
        {"number": "logit_gap", "limit": 0.5, "requests": 3}))
    bench["workloads"].append({"name": "tiny.burst", "config": "tiny-dense",
                               "traffic": "tiny-burst", "chips": 1,
                               "why": "throwaway"})
    for m in bench["end_to_end"]:
        if m["name"] == "tpot_p99_ms":
            m["workloads"].append("tiny.burst")
    bench["per_layer"].append({"name": "iterations.burst", "unit": "count",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "engine", "moves": "tpot_p99_ms",
                               "workloads": ["tiny.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert {k: v for k, v in digests(root).items() if k in before} == before

    c = spec.load_cell("tiny.burst", root)
    assert [m["name"] for m in c.per_layer] == ["iterations.burst"]
    assert [m["name"] for m in c.end_to_end] == ["tpot_p99_ms", "setup_s"]
    for traced in (False, True):
        res = cell_mod.run(c, 5, 0.3, traced, torch.device("cpu"), 0.0,
                           log=lambda *a: None, clock=Tick())
        assert res["correct"], res["checks"]
        want = {"iterations.burst"} if traced else {"tpot_p99_ms",
                                                     "setup_s"}
        assert set(res["metrics"]) == want
    assert res["metrics"]["iterations.burst"]["unit"] == "count"
