"""The slice as a whole: the port's continuous-batching engine over the
balanced trunk against the reference's, on the CPU.

Reduced llama2-7b (f32) with the reference's weights carried across, an
``ultra-125h`` virtual clock, two slots, prefill chunks of 4 and three
seeded Poisson requests (the set-up of ``tests/test_compiled.py``).  Every
trunk runs both ways: compiled (the port's against the reference's
``mode="compiled"``) and eager (the port's per-core shard dispatch against
the reference's ``jit_bridge=False`` engine, its Q4 blocks pinned to the
compiled ``bk``), for each of the Q4, int8 and fp32 weight paths.  The
greedy tokens, every request's virtual-clock timeline, the latency report
and every ratio table must be equal exactly: the clock and the tables are
float64 numpy in both packages, and the projections differ only in the
order of their f32 sums, far below what moves an argmax here.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.serving as ref_serving
import repro_torch.serving as port_serving
from repro.configs import reduced_config as ref_reduced
from repro.kernels.dispatch import HybridKernelDispatcher as RefDisp
from repro.models import BalancedTrunk as RefTrunk
from repro.models import init_params as ref_init_params
from repro_torch.configs import reduced_config
from repro_torch.kernels.dispatch import HybridKernelDispatcher as PortDisp
from repro_torch.launch import serve as port_serve
from repro_torch.models import BalancedTrunk, params_from_numpy

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def weights():
    cfg_r, cfg_p = ref_reduced("llama2-7b"), reduced_config("llama2-7b")
    params_r = ref_init_params(cfg_r, jax.random.key(0))
    params_p = params_from_numpy(jax.tree.map(np.asarray, params_r),
                                 device="cpu")
    return cfg_r, cfg_p, params_r, params_p


def _serve(pkg, weights, quant, mode="compiled"):
    """One serving run; ``quant`` None serves the dense model (no trunk)."""
    cfg_r, cfg_p, params_r, params_p = weights
    if pkg == "ref":
        cfg, params, serving = cfg_r, params_r, ref_serving
        disp = RefDisp.virtual("ultra-125h", execute=True)
        trunk_kw = ({"mode": "compiled"} if mode == "compiled" else
                    {"jit_bridge": False, "pin_q4_blocks": True})
        bt = (RefTrunk.from_params(cfg, params, disp, quant=quant,
                                   **trunk_kw) if quant else None)
        kw = {}
    else:
        cfg, params, serving = cfg_p, params_p, port_serving
        disp = PortDisp.virtual("ultra-125h", execute=mode == "eager")
        bt = (BalancedTrunk.from_params(cfg, params, disp, quant=quant,
                                        mode=mode, device="cpu")
              if quant else None)
        kw = {"device": "cpu"}
    engine = serving.ContinuousBatchingEngine(
        cfg, params, max_slots=2, max_seq=16, prefill_chunk=4,
        cost_model=serving.HybridPhaseCost("ultra-125h"), balanced_trunk=bt,
        **kw)
    requests = serving.poisson_requests(3, rate=100.0,
                                        vocab_size=cfg.vocab_size,
                                        prompt_len=6, max_new_tokens=4,
                                        seed=0)
    for r in requests:
        engine.submit(r)
    stats = engine.run_until_idle()
    report = serving.LatencyReport.from_requests(requests)
    return requests, disp, engine, report, stats


class _Runs(dict):
    """(package, trunk) -> serving run, each made on first use."""

    def __init__(self, weights):
        super().__init__()
        self.weights = weights

    def __missing__(self, key):
        pkg, trunk = key
        quant, mode = trunk if trunk else (None, "compiled")
        self[key] = _serve(pkg, self.weights, quant, mode)
        return self[key]


@pytest.fixture(scope="module")
def runs(weights):
    return _Runs(weights)


# (quant, mode) of the balanced trunk; None serves the dense model.  The
# ids of the first and last cases are those of the Q4-only tests before
# the int8 and fp32 trunks and the eager mode were ported.
TRUNKS = [("q4", "compiled"), ("int8", "compiled"), ("fp32", "compiled"),
          ("q4", "eager"), ("int8", "eager"), ("fp32", "eager"), None]
TRUNK_IDS = ["compiled-q4-trunk", "compiled-int8-trunk",
             "compiled-fp32-trunk", "eager-q4-trunk", "eager-int8-trunk",
             "eager-fp32-trunk", "dense"]


@pytest.mark.parametrize("trunk", TRUNKS, ids=TRUNK_IDS)
def test_greedy_tokens_equal(runs, trunk):
    ref, port = runs[("ref", trunk)][0], runs[("port", trunk)][0]
    assert [r.generated for r in ref] == [r.generated for r in port]
    assert all(r.n_generated == 4 for r in port)


@pytest.mark.parametrize("trunk", TRUNKS, ids=TRUNK_IDS)
def test_request_timelines_equal_exactly(runs, trunk):
    ref, port = runs[("ref", trunk)][0], runs[("port", trunk)][0]
    for a, b in zip(ref, port):
        for field in ("arrival_time", "admit_time", "first_token_time",
                      "finish_time", "request_id", "prefill_done"):
            assert getattr(a, field) == getattr(b, field), field
        assert a.finish_reason.value == b.finish_reason.value
    ref_steps = [(s.prefill_tokens, s.decode_tokens, s.now)
                 for s in runs[("ref", trunk)][4]]
    port_steps = [(s.prefill_tokens, s.decode_tokens, s.now)
                  for s in runs[("port", trunk)][4]]
    assert ref_steps == port_steps


@pytest.mark.parametrize("trunk", TRUNKS, ids=TRUNK_IDS)
def test_latency_report_equal(runs, trunk):
    ref, port = runs[("ref", trunk)][3], runs[("port", trunk)][3]
    assert ref.to_dict() == port.to_dict()
    assert ref.lines() == port.lines()


def test_every_ratio_table_key_equal(runs):
    """The kernel dispatcher's per-(phase ISA x layer kind) tables, fed by
    the compiled Q4 cost tape, and the phase cost model's tables."""
    _assert_tables_equal(runs[("ref", TRUNKS[0])], runs[("port", TRUNKS[0])])


@pytest.mark.parametrize("trunk", TRUNKS[1:-1], ids=TRUNK_IDS[1:-1])
def test_every_ratio_table_key_equal_for_each_trunk(runs, trunk):
    """The same for the int8 and fp32 compiled trunks, and for the eager
    trunks, whose projections plan and feed back when they are called
    (the head only where a token is sampled)."""
    _assert_tables_equal(runs[("ref", trunk)], runs[("port", trunk)])


def _assert_tables_equal(ref, port):
    kinds = ("attn_proj", "mlp_up", "mlp_down", "head")
    want = {f"{isa}/{k}" for isa in ("avx_vnni", "membw") for k in kinds}
    assert want <= set(port[1].table.keys())
    assert sorted(ref[1].table.keys()) == sorted(port[1].table.keys())
    for key in ref[1].table.keys():
        np.testing.assert_array_equal(ref[1].table.ratios(key),
                                      port[1].table.ratios(key))
    ct_r, ct_p = ref[2].cost_model.table, port[2].cost_model.table
    assert sorted(ct_r.keys()) == sorted(ct_p.keys())
    for key in ct_r.keys():
        np.testing.assert_array_equal(ct_r.ratios(key), ct_p.ratios(key))
    assert (ref[1].achieved_bandwidth_fraction()
            == port[1].achieved_bandwidth_fraction())
    spread = port[1].table.ratios("membw/mlp_up")
    assert spread.max() / spread.min() > 1.1        # the loop learned


def test_engine_state_reused_per_admission_is_fresh(runs):
    """Each admission prefills into its own zeroed batch-1 state (the
    caches are written in place): after the run every slot is free and no
    partial state is left."""
    engine = runs[("port", TRUNKS[0])][2]
    assert engine.manager.n_free == engine.max_slots
    assert engine._partial is None
    assert not engine.has_work


# ------------------------------------------------------- the serve CLI --
def test_serve_cli_tiny_on_cpu(capsys):
    rc = port_serve.main(["--device", "cpu", "--preset", "tiny",
                          "--balanced-trunk", "--trunk-quant", "q4",
                          "--requests", "3", "--steps", "4",
                          "--prompt-len", "6", "--batch", "2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "finished 3/3 requests" in out
    assert "trunk membw/mlp_up spread" in out
    assert "on cpu" in out


def test_serve_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = port_serve.build_parser().parse_args(["--preset", "tiny"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        port_serve.serve(args)


@pytest.mark.parametrize("quant", ["int8", "fp32"])
def test_serve_cli_tiny_on_cpu_other_trunks(capsys, quant):
    rc = port_serve.main(["--device", "cpu", "--preset", "tiny",
                          "--balanced-trunk", "--trunk-quant", quant,
                          "--requests", "3", "--steps", "4",
                          "--prompt-len", "6", "--batch", "2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "finished 3/3 requests" in out
    assert "trunk membw/mlp_up spread" in out


def test_serve_run_records_every_iteration():
    """``serve`` keeps each engine step's stats: a compiled trunk launches
    225 projections per trunk call at full depth, so the chip smoke counts
    kernel launches against these steps."""
    args = port_serve.build_parser().parse_args(
        ["--device", "cpu", "--balanced-trunk", "--requests", "3",
         "--steps", "4", "--prompt-len", "6", "--batch", "2"])
    run = port_serve.serve(args)
    assert sum(s.prefill_tokens for s in run.iterations) == 3 * 6
    assert sum(s.decode_tokens for s in run.iterations) == 3 * 3
    assert run.iterations[-1].now == run.engines[0].now


@pytest.mark.parametrize("flag", [["--arch", "musicgen-medium"]])
def test_unported_serve_modes_exit_with_a_message(flag):
    """The one serve mode left to the examples, not yet ported: an
    embed-input arch (the reference refuses it the same way)."""
    with pytest.raises(SystemExit, match="use examples/"):
        port_serve.main(["--device", "cpu", *flag])


# ---------------------------------------------------------------- imports --
def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 40
    bad = {str(f.relative_to(ROOT)): sorted(
               _imported_roots(f) & {"jax", "jaxlib", "repro", "benchmarks"})
           for f in files}
    assert {f: r for f, r in bad.items() if r} == {}


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No card (this process's torch has none, or the check is forced):
    non-zero exit and no result line, also when the script stands alone."""
    probe = ("import sys, runpy, torch; torch.cuda.is_available = lambda: "
             "False; sys.argv = ['chip_smoke.py']; "
             "runpy.run_path(sys.argv[0], run_name='__main__')")
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes((ROOT / "chip_smoke.py").read_bytes())
    for cwd in (ROOT, tmp_path):
        proc = subprocess.run([sys.executable, "-c", probe], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
