"""The tests' own set-up in ``conftest.py``: each xdist worker's share of the
CPU's threads (in a fresh interpreter per case, since the share is taken on
import), and the per-test time limit."""

import json
import os
import re
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

import conftest

TESTS = str(Path(__file__).resolve().parent)

PROBE = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, sys.argv[1])
    if sys.argv[2] == "torch first":   # as when a plugin imported torch
        import torch
    if sys.argv[2] != "no conftest":
        import conftest
    import torch
    print(json.dumps({"torch": torch.get_num_threads(),
                      "omp": os.environ.get("OMP_NUM_THREADS"),
                      "mkl": os.environ.get("MKL_NUM_THREADS")}))
""")


def _probe(order, **env):
    base = {k: v for k, v in os.environ.items()
            if k not in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                         "PYTEST_XDIST_WORKER_COUNT")}
    out = subprocess.run([sys.executable, "-c", PROBE, TESTS, order],
                         env={**base, **env}, capture_output=True, text=True,
                         timeout=120, check=True)
    return json.loads(out.stdout.splitlines()[-1])


@pytest.mark.parametrize("order", ["torch first", "conftest first"])
def test_each_xdist_worker_gets_its_share(order):
    share = max(1, len(os.sched_getaffinity(0)) // 2)
    got = _probe(order, PYTEST_XDIST_WORKER_COUNT="2")
    assert got == {"torch": share, "omp": str(share), "mkl": str(share)}
    assert _probe(order, PYTEST_XDIST_WORKER_COUNT="10000")["torch"] == 1


def test_the_callers_thread_count_stands():
    got = _probe("conftest first", PYTEST_XDIST_WORKER_COUNT="2",
                 OMP_NUM_THREADS="3")
    assert got == {"torch": 3, "omp": "3", "mkl": None}


@pytest.mark.parametrize("order", ["torch first", "conftest first"])
def test_outside_xdist_nothing_changes(order):
    assert _probe(order) == _probe("no conftest")


def test_a_test_past_its_limit_fails_by_name(request):
    name = request.node.nodeid
    start = time.monotonic()
    with pytest.raises(pytest.fail.Exception,
                       match=re.escape(f"{name} ran past its 1 s time limit")):
        with conftest.time_limit(1, name):
            time.sleep(30)
    assert time.monotonic() - start < 10
    # the hook's own limit on this test's body is armed again
    assert signal.getitimer(signal.ITIMER_REAL)[0] > 0
