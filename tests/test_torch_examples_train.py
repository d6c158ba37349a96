"""``repro_torch.examples.train_100m`` against the reference's
``examples/train_100m.py``, and its restart, on the CPU.

Both modules' ``CFG`` is cut to 2 layers of d_model 64, d_ff 128 and a
vocabulary of 512 (the reference's heads, 8 of dim 8 over 4 kv heads; the
batches, 16 x 128 tokens in 4 microbatches, stay the example's).

* 25 steps with ``--uneven-every 5`` from the reference's initial weights:
  the step-25 line's loss within 1e-4 relative of the reference's (the
  printed four decimals, 4.4230 in both, the port's unrounded 4.423011
  inside the reference's rounding interval; the rounding alone may part
  two printed losses by 2.3e-5 of the loss), its ``uneven counts=``
  exact, and equal to what a fresh ``UnevenBatchPlanner`` gives on the
  pods' simulated speeds.
* Restart: a ``--steps 125`` run stopped right after its step-100
  checkpoint, then relaunched, trains steps 101-125 bitwise as an
  uninterrupted ``--steps 125`` run does, under
  ``torch.use_deterministic_algorithms`` (the embedding's backward on the
  CPU adds its rows in an order that varies from call to call otherwise:
  two steps from one state part in ``embed/tok``).  The checkpoint
  records the batches consumed; the reference records its prefetching
  stream's counter, which is ahead of them, so its resumed run would
  train on other batches and fail this test.
"""

import dataclasses
import importlib.util
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models import init_params as ref_init_params
from repro_torch.examples import train_100m
from repro_torch.models import params_from_numpy
from repro_torch.runtime import DeviceRuntime, UnevenBatchPlanner

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-4     # relative; see the module docstring
SMALL = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=512)
LINE = re.compile(r"\[100m\] step +(\d+) loss=(\S+)( uneven counts=(.*))?")


@pytest.fixture(scope="module")
def reference():
    spec = importlib.util.spec_from_file_location(
        "reference_example_train_100m", ROOT / "examples" / "train_100m.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def small(monkeypatch, reference):
    """Both modules' CFG cut to SMALL; the reference's initial weights."""
    monkeypatch.setattr(reference, "CFG",
                        dataclasses.replace(reference.CFG, **SMALL))
    monkeypatch.setattr(train_100m, "CFG",
                        dataclasses.replace(train_100m.CFG, **SMALL))
    params = ref_init_params(reference.CFG, jax.random.key(0))
    return params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")


def _planner_counts(n_uneven: int) -> list:
    """The counts a fresh planner gives over ``n_uneven`` uneven steps, each
    fed back with the pods' simulated times."""
    planner = UnevenBatchPlanner(DeviceRuntime(n_slices=4, alpha=0.3))
    out = []
    for _ in range(n_uneven):
        plan = planner.plan(4)
        planner.report(plan, plan.counts / train_100m.POD_SPEED)
        out.append(plan.counts.tolist())
    return out


def test_train_100m_against_the_reference(monkeypatch, capsys, tmp_path,
                                          reference, small):
    argv = ["--steps", "25", "--uneven-every", "5"]
    monkeypatch.setattr(sys, "argv", ["train_100m.py", *argv, "--ckpt-dir",
                                      str(tmp_path / "ref")])
    capsys.readouterr()
    reference.main()
    want = capsys.readouterr().out.splitlines()
    got = train_100m.main([*argv, "--ckpt-dir", str(tmp_path / "port"),
                           "--device", "cpu"], params=small)
    assert capsys.readouterr().out.splitlines() == got
    assert got[0] == want[0] == "[100m] params: 0M"
    (step_w, loss_w, _, counts_w), = [LINE.fullmatch(l).groups()
                                      for l in want if LINE.fullmatch(l)]
    (step_g, loss_g, _, counts_g), = [LINE.fullmatch(l).groups()
                                      for l in got if LINE.fullmatch(l)]
    assert step_g == step_w == "25"
    assert abs(float(loss_g) - float(loss_w)) <= LOSS_TOL * float(loss_w)
    assert counts_g == counts_w == str(_planner_counts(5)[-1])
    assert got[-1].startswith("[100m] 25 steps in ")
    assert not (tmp_path / "port").exists()   # no checkpoint before step 100


def _run(ckpt_dir, record, stop_after=None, steps=125):
    """The port's example on the CPU; ``stop_after`` a step whose line ends
    the run there (its checkpoint written), as a crash would."""
    args = train_100m.build_parser().parse_args(
        ["--steps", str(steps), "--uneven-every", "25", "--ckpt-dir",
         str(ckpt_dir), "--device", "cpu"])
    gen = train_100m.train(args, record=record)
    lines = []
    for line in gen:
        lines.append(line)
        if stop_after is not None and line.startswith(
                f"[100m] step {stop_after:4d} "):
            gen.close()
    return lines


@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def test_train_100m_resume_is_bitwise_an_uninterrupted_run(tmp_path, small,
                                                           deterministic):
    straight, first, resumed = [], [], []
    lines_s = _run(tmp_path / "a", straight)
    lines_1 = _run(tmp_path / "b", first, stop_after=100)
    lines_2 = _run(tmp_path / "b", resumed)
    assert [s for s, _, _ in first] == list(range(1, 101))
    assert lines_1[-1].startswith("[100m] step  100 ")
    assert lines_2[1] == "[100m] resumed at step 100"
    assert [s for s, _, _ in resumed] == list(range(101, 126))
    # bitwise: every loss of steps 101-125, and the printed lines
    assert [l for _, l, _ in resumed] == [l for _, l, _ in straight[100:]]
    assert [l for _, l, _ in first] == [l for _, l, _ in straight[:100]]
    assert lines_2[2:-1] == lines_s[5:-1]
    assert lines_s[5] == lines_2[2] and "uneven counts=[1, 1, 1, 1]" in \
        lines_s[5]


def test_train_100m_full_config_counts_56m_parameters(reference):
    """The example's model is the reference's CFG, whose count is 56M
    (the reference's docstring says ~101M)."""
    assert dataclasses.asdict(train_100m.CFG) == dataclasses.asdict(
        reference.CFG)
    assert f"{train_100m.CFG.param_count() / 1e6:.0f}M" == "56M"
    assert train_100m.build_parser().parse_args([]).ckpt_dir.endswith(
        "repro_torch_100m")
