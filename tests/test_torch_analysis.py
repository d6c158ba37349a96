"""The port's analysis passes (``repro_torch.analysis``) against the
reference's, on the CPU.

* Lint: the port's ``lint_source`` flags or clears each of the
  reference's read-only fixtures (``tests/analysis_corpus/lint/``, rules
  RL001-RL003, RL005, RL006) exactly as the reference's lint does: the
  same rules on the same lines.  RL004 is rewritten for torch (a
  ``torch.compile``, a CUDA graph capture or a ``StepGraph`` over mutable
  ratio state), so it is held by inline torch fixtures, bad and good.
  ``run_pass`` over ``src/repro_torch`` is clean.
* Races: ``find_races`` gives the reference's findings on the synthetic
  schedules of ``tests/test_analysis.py``; ``run_pass`` (virtual and
  threaded dispatch, the accounting, the two-level dispatch) is clean.
* Audit: inline bad steps for JA001 (``.item()`` on an offset), JA002 (an
  offset multiplied into data), JA003 (a projection bypassing the
  dispatcher) and JA004 (regions out of order) are each flagged; reduced
  granite-8b's compiled and eager steps are clean (``run_pass``).
* The CLI: ``python -m repro_torch.analysis all --device cpu --json``
  exits 0.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.analysis import lint as ref_lint
from repro.analysis.races import find_races as ref_find_races
from repro.core.events import Event as RefEvent
from repro_torch.analysis import lint, races, step_audit
from repro_torch.analysis.findings import format_findings
from repro_torch.core.events import Event

ROOT = Path(__file__).resolve().parents[1]
CORPUS = ROOT / "tests" / "analysis_corpus" / "lint"
SHARED_RULES = ["RL001", "RL002", "RL003", "RL005", "RL006"]


# -------------------------------------------------------------- lint --
def _rules_and_lines(findings) -> list:
    return sorted((f.rule, f.location.rsplit(":", 1)[1]) for f in findings)


@pytest.mark.parametrize("kind", ["bad", "good"])
@pytest.mark.parametrize("rule", SHARED_RULES)
def test_lint_corpus_as_the_reference(rule, kind):
    path = CORPUS / f"{kind}_{rule.lower()}.py"
    got = lint.lint_file(path)
    want = ref_lint.lint_file(path)
    assert _rules_and_lines(got) == _rules_and_lines(want)
    if kind == "bad":
        assert got and {f.rule for f in got} == {rule}
    else:
        assert got == [], format_findings(got)


RL004_BAD = '''
import functools
import torch
from repro_torch.runtime import RatioTable
from repro_torch.serving.step_graph import StepGraph

table = RatioTable(4)


@torch.compile
def step(x):
    return x * table.ratios("gemv")[0]          # flagged: free `table`


def make(runtime):
    return torch.compile(lambda x: x + runtime.table.ratios("g")[0])


def capture(runtime, g, x):
    with torch.cuda.graph(g):                    # flagged: body reads .tuner
        y = x * runtime.tuner.best("k")[0]
    return y


class Engine:
    def body(self, x):
        return x + self.table.ratios("g")[0]

    def graph(self):
        return StepGraph(self.body, [])          # flagged: method reads .table


graphed = torch.cuda.make_graphed_callables(step, ())
partial = functools.partial(torch.compile, mode="default")(
    lambda x: x * table.ratios("g")[0])
'''

RL004_GOOD = '''
import torch
from repro_torch.serving.step_graph import StepGraph


@torch.compile
def step(x, offsets):
    return x + offsets["attn"][1:] - offsets["attn"][:-1]   # an argument


def capture(g, x, bounds):
    with torch.cuda.graph(g):
        y = x * (bounds[1:] - bounds[:-1])
    return y


class Engine:
    def body(self, tok):
        return tok + 1

    def graph(self, table):
        t = table.ratios("g")          # read on the host, outside capture
        return StepGraph(self.body, []), t
'''


def test_lint_rl004_torch_fixtures():
    bad = lint.lint_source(RL004_BAD, "repro_torch/x.py")
    assert {f.rule for f in bad} == {"RL004"}
    lines = sorted(int(f.location.rsplit(":", 1)[1]) for f in bad)
    assert lines == [11, 16, 20, 30, 33, 34], format_findings(bad)
    assert lint.lint_source(RL004_GOOD, "repro_torch/x.py") == []


def test_lint_paths_point_at_the_port():
    src = "import time\n\n\ndef f():\n    return time.perf_counter()\n"
    assert lint.lint_source(src, "src/repro_torch/kernels/ops.py") == []
    for path in ("src/repro_torch/topology/machine.py",
                 "src/repro_torch/core/hybrid_sim.py"):
        assert [f.rule for f in lint.lint_source(src, path)] == ["RL001"]
    key = 'K = "membw/attn_proj"\n'
    assert lint.lint_source(key, "src/repro_torch/kernels/dispatch.py") == []
    assert [f.rule for f in lint.lint_source(
        key, "src/repro_torch/kernels/compiled.py")] == ["RL002"]
    shout = 'def g():\n    print("x")\n'
    assert lint.lint_source(shout, "src/repro_torch/launch/serve.py") == []
    assert [f.rule for f in lint.lint_source(
        shout, "src/repro_torch/serving/engine.py")] == ["RL006"]
    allowed = 'import time\nnow = time.time()  # lint: allow(RL001)\n'
    assert lint.lint_source(allowed, "x.py", virtual=True) == []
    assert [f.rule for f in lint.lint_source("def broken(:\n", "x.py")] == \
        ["RL000"]


def test_lint_clean_on_the_port():
    findings = lint.run_pass(str(ROOT / "src" / "repro_torch"))
    assert findings == [], format_findings(findings)


# ------------------------------------------------------------- races --
SCHEDULES = {
    "unsynchronized writes": [
        ("fork", "main", "w0"), ("fork", "main", "w1"),
        ("write", "w0", "Disp#1", "bytes", "a"),
        ("write", "w1", "Disp#1", "bytes", "b"),
        ("join", "main", "w0"), ("join", "main", "w1")],
    "lock ordered": [
        ("fork", "main", "w0"), ("fork", "main", "w1"),
        ("acquire", "w0", "lock"), ("write", "w0", "Disp#1", "bytes"),
        ("release", "w0", "lock"), ("acquire", "w1", "lock"),
        ("write", "w1", "Disp#1", "bytes"), ("release", "w1", "lock")],
    "fork join ordered": [
        ("write", "main", "Table#1", "t"), ("fork", "main", "w0"),
        ("write", "w0", "Table#1", "t"), ("join", "main", "w0"),
        ("write", "main", "Table#1", "t")],
    "concurrent reads": [
        ("fork", "main", "w0"), ("fork", "main", "w1"),
        ("read", "w0", "Table#1", "t"), ("read", "w1", "Table#1", "t")],
    "read write conflict": [
        ("fork", "main", "w0"), ("fork", "main", "w1"),
        ("read", "w0", "Table#1", "t"), ("write", "w1", "Table#1", "t")],
}


def _events(cls, rows):
    out = []
    for row in rows:
        kind, task, obj = row[:3]
        field = row[3] if len(row) > 3 else ""
        where = row[4] if len(row) > 4 else ""
        out.append(cls(kind=kind, task=task, obj=obj, field=field,
                       where=where))
    return out


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_find_races_as_the_reference(name):
    got = races.find_races(_events(Event, SCHEDULES[name]))
    want = ref_find_races(_events(RefEvent, SCHEDULES[name]))
    assert [f.to_json() for f in got] == [f.to_json() for f in want]
    assert bool(got) == (name in ("unsynchronized writes",
                                  "read write conflict"))


def test_races_run_pass_is_clean():
    lines = []
    assert races.run_pass(log=lines.append, device="cpu") == []
    assert len(lines) == 5 and any("threaded q4" in s for s in lines)


def test_threaded_accounting_needs_its_lock():
    """The threaded dispatcher's concurrent reports replay race-free, and
    the same schedule without its lock edges races."""
    from repro_torch.core.pool import SubTask, ThreadWorkerPool
    from repro_torch.kernels.dispatch import GEMV_ISA, HybridKernelDispatcher

    d = HybridKernelDispatcher.threaded(4)
    pool = ThreadWorkerPool(4)
    try:
        with races.trace() as rec:
            pool.run([SubTask(worker=w, start=w, size=1, work=1.0,  # lint: allow(RL003) accounting-only schedule
                              fn=lambda s, z: d._account(GEMV_ISA, 1.0,
                                                         1e-3))
                      for w in range(4)])
    finally:
        pool.close()
        d.close()
    assert races.find_races(rec.events) == []
    unlocked = [e for e in rec.events if e.kind not in ("acquire", "release")]
    assert any(f.rule == "RC001" for f in races.find_races(unlocked))


# ------------------------------------------------------------- audit --
def _bounds():
    return [torch.tensor([0, 3, 5, 8], dtype=torch.int32)]


def test_audit_ja001_item_on_an_offset():
    def step(offs, x):
        n = int(offs[0][1].item())          # the host waits for the device
        return x[:n]

    _, rec = step_audit.record_step(step, _bounds(), torch.ones(8),
                                    offsets=_bounds())
    got = step_audit.audit_compiled(rec, where="bad")
    assert "JA001" in {f.rule for f in got}


def test_audit_ja002_offset_into_data():
    offs = _bounds()

    def bad(o, x):
        return x * o[0][1]

    def good(o, x):
        sizes = o[0][1:] - o[0][:-1]        # the cost tape's pattern
        return x + 1, torch.clamp(sizes, 0, 8)

    _, rec = step_audit.record_step(bad, offs, torch.ones(4), offsets=offs)
    got = step_audit.audit_compiled(rec)
    assert [f.rule for f in got] == ["JA002"] and "mul" in got[0].message
    _, rec = step_audit.record_step(good, offs, torch.ones(4), offsets=offs)
    assert step_audit.audit_compiled(rec) == []


@pytest.fixture(scope="module")
def eager():
    from repro_torch.configs import reduced_config
    from repro_torch.kernels.dispatch import HybridKernelDispatcher
    from repro_torch.models import BalancedTrunk, init_params

    cfg = reduced_config("granite-8b")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def build():
        disp = HybridKernelDispatcher.virtual("ultra-125h", execute=True)
        trunk = BalancedTrunk.from_params(cfg, params, disp, mode="eager",
                                          pin_q4_blocks=True, device="cpu")
        return disp, trunk, step_audit.eager_step(cfg, params, trunk)

    return build


def test_audit_eager_step_is_clean(eager):
    disp, trunk, step = eager()
    want = step_audit.expected_regions(trunk, "membw")
    with step_audit.record_regions(disp) as got:
        step()
    assert len(want) == 2 * 7 + 1
    assert step_audit.audit_eager(got, want) == []
    assert "dispatch" not in vars(disp)      # the recorder is removed


def test_audit_ja003_projection_bypassing_the_dispatcher(eager):
    from repro_torch.kernels import ops

    disp, trunk, step = eager()
    want = step_audit.expected_regions(trunk, "membw")
    layer = trunk.bank[(0, "attn", "wk")][1]

    class Bypass:               # the same weight, one plain launch
        qw, out_features = layer.qw, layer.out_features

        def __call__(self, x, *, isa, key=None):
            rows = x.reshape(-1, x.shape[-1]).float()
            return ops.q4_variant(rows, layer.qw, ("ring",)).reshape(
                *x.shape[:-1], -1)

    trunk.bank[(0, "attn", "wk")][1] = Bypass()
    with step_audit.record_regions(disp) as got:
        step()
    assert [f.rule for f in step_audit.audit_eager(got, want)] == ["JA003"]


def test_audit_ja004_regions_out_of_order(eager):
    disp, trunk, step = eager()
    want = step_audit.expected_regions(trunk, "membw")
    reps = trunk.bank[(0, "ffn", "wo")]
    reps[0], reps[1] = reps[1], reps[0]     # layer 1's down before layer 0's
    with step_audit.record_regions(disp) as got:
        step()
    assert [f.rule for f in step_audit.audit_eager(got, want)] == ["JA004"]
    # observations reaching the table out of the regions' order
    got.observed = got.observed[1:] + got.observed[:1]
    assert "JA004" in {f.rule for f in step_audit.audit_eager(
        got, [r for r in got.regions])}


def test_audit_run_pass_is_clean():
    lines = []
    assert step_audit.run_pass(log=lines.append, device="cpu") == []
    assert any("eager decode step" in s and "expected 15" in s
               for s in lines), lines


# --------------------------------------------------------------- CLI --
def test_cli_all_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "all", "--device",
         "cpu", "--json", "--root", str(ROOT / "src" / "repro_torch")],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout) == []
    assert "jax" not in proc.stderr


def test_lazy_submodules():
    import repro_torch.analysis as A

    assert A.step_audit is step_audit and A.races is races
    with pytest.raises(AttributeError):
        A.jaxpr_audit
