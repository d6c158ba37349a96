"""``perfbench/run.py`` as the benchmark's command: it refuses to run, and
prints no result, without a card; on a card (the ``gpu`` tests) each cell
runs a short window and prints the contract's last line."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def run(*args, timeout=900):
    return subprocess.run([sys.executable, "perfbench/run.py", *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = run("--workload", CELLS[0], "--seed", str(2 ** 31 + 9),
              "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_unknown_workload_fails():
    out = run("--workload", "no-such-cell", "--seed", "1", "--seconds", "1")
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", ["0", "1"])
def test_cell_on_the_card(cuda_device, workload, trace):
    out = run("--workload", workload, "--seed", str(2 ** 31 + 77),
              "--seconds", "6", "--trace", trace)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(res)[-1] == "checks"
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    if trace == "1":
        assert res["device"]["busy_s"] > 0
        assert all(m["value"] <= 105 for m in res["metrics"].values()
                   if m["unit"] == "%")
