"""The control: the reference in float8, the precision below the
configuration's bfloat16, read at the same positions of the same served
sequences.  On the card, at each cell's own size, it fails the cell's
limit where the program passes it; on the CPU, at a cut, it reads a gap
where the program (float32 there) reads none."""

import pytest
import torch

from perfbench.harness import cell as cell_mod
from perfbench.harness import spec
from perfbench.tests.test_perfbench_faults import Tick
from perfbench.tests.test_perfbench_run import CELLS


@pytest.mark.parametrize("name", ["tiny.closed", "tiny.open"])
def test_control_reads_a_gap(tiny_root, name):
    c = spec.load_cell(name, tiny_root)
    res = cell_mod.run(c, 2 ** 31 + 21, 0.5, False, torch.device("cpu"),
                       0.0, control=True, log=lambda *a: None, clock=Tick())
    r = res["readings"]
    assert r["logit_gap"] == 0.0
    assert r["control_gap"] > 0.0 and r["control_mismatch"] > 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limit_on_the_card(cuda_device, workload):
    import time

    c = spec.load_cell(workload)
    res = cell_mod.run(c, 2 ** 31 + 31, 8.0, False, cuda_device,
                       time.perf_counter(), control=True,
                       log=lambda *a: None)
    number = c.check["number"]
    prog = res["readings"][number]
    ctrl = res["readings"][number.replace("logit", "control", 1)]
    assert prog <= c.check["limit"] < ctrl
