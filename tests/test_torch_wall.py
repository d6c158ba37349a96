"""The port's wall spans, on the CPU: the serving engine's iterations,
lanes, decode launches and cost-tape feedback recorded on the host's clock
through :data:`repro_torch.core.events.WALL`, the clock they share with
``torch.profiler``, the device-idle arithmetic over them, and what they
leave alone (the virtual trace, the race detector's events, the disabled
path).  Nothing here needs the reference package."""

import importlib.util
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import races
from repro_torch.configs import ModelConfig
from repro_torch.core import events
from repro_torch.kernels.dispatch import HybridKernelDispatcher
from repro_torch.models import BalancedTrunk, init_params
from repro_torch.obs import SpanTracer, validate_trace
from repro_torch.obs import trace as trace_mod
from repro_torch.obs.trace import WallSpan
from repro_torch.serving import (ContinuousBatchingEngine, HybridPhaseCost,
                                 LinearPhaseCost, Request)

ROOT = Path(__file__).resolve().parents[1]
CFG = ModelConfig(name="t", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                  dtype="float32")
PHASES = ("queued", "prefilling", "decoding")
# the spans each span may hold
CHILDREN = {
    "iteration": {"admit", "prefill", "decode"},
    "prefill": {"prefill.trunk", "pick", "prefill.sync", "feedback"},
    "prefill.trunk": {"attn", "mlp"},
    "decode": {"decode.inputs", "decode.launch", "pick", "feedback",
               "finish"},
    "decode.launch": {"attn", "mlp"},
    "feedback": {"feedback.fetch", "feedback.replay", "feedback.plan",
                 "feedback.upload"},
}


@pytest.fixture(autouse=True)
def _clean_hooks():
    yield
    events.install(None)
    events.install_wall(None)


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0), device="cpu")


def _engine(params, cost=None, lanes=1, n=3, new=4):
    trunk = BalancedTrunk.from_params(
        CFG, params, HybridKernelDispatcher.virtual("ultra-125h"),
        quant="q4", device="cpu")
    eng = ContinuousBatchingEngine(
        CFG, params, max_slots=2, max_seq=32, prefill_chunk=4,
        prefill_lanes=lanes, cost_model=cost, balanced_trunk=trunk,
        device="cpu")
    g = torch.Generator().manual_seed(1)
    reqs = [Request(prompt=torch.randint(0, CFG.vocab_size, (5 + i,),
                                         generator=g).numpy(),
                    max_new_tokens=new) for i in range(n)]
    return eng, reqs


def _traced_run(params, **kw):
    eng, reqs = _engine(params, **kw)
    tracer = SpanTracer()
    events.install_wall(tracer)
    try:
        for r in reqs:
            eng.submit(r)
        stats = eng.run_until_idle()
    finally:
        events.install_wall(None)
    return eng, reqs, stats, tracer


@pytest.mark.parametrize("cost,lanes", [(None, 1), ("linear", 1),
                                        ("linear", 2)],
                         ids=["wall", "virtual", "virtual-2-lanes"])
def test_engine_span_tree(params, cost, lanes):
    """Every iteration is a tree of spans, each inside its parent; each
    decode step has one ``decode.*`` set and one feedback with its four
    parts; each request has its three phases back to back; the counters
    are sampled once an iteration."""
    eng, reqs, stats, tracer = _traced_run(
        params, cost=LinearPhaseCost() if cost else None, lanes=lanes)
    spans = tracer.wall_spans()
    by_id = {sp.sid: sp for sp in spans}
    assert len(by_id) == len(spans)
    its = [sp for sp in spans if sp.name == "iteration"]
    assert len(its) == len(stats)
    kids = {}
    for sp in spans:
        assert sp.start <= sp.end
        if sp.parent:
            up = by_id[sp.parent]
            assert up.start <= sp.start and sp.end <= up.end
            assert sp.name in CHILDREN[up.name], (up.name, sp.name)
            kids.setdefault(sp.parent, []).append(sp.name)
        else:
            assert sp.name == "iteration" or sp.name in PHASES
    for it, st in zip(sorted(its, key=lambda s: s.start), stats):
        assert it.args["prefill_tokens"] == st.prefill_tokens
        assert it.args["decode_rows"] == st.decode_tokens
        assert it.args["launches"] == 0        # plain path on the CPU
        assert it.args["attn_launches"] == 0
    decodes = [sp for sp in spans if sp.name == "decode"]
    assert len(decodes) == sum(1 for st in stats if st.decode_tokens)
    for d in decodes:
        assert Counter(kids[d.sid]) == Counter(
            ["decode.inputs", "decode.launch", "pick", "feedback", "finish"])
    for f in (sp for sp in spans if sp.name == "feedback"):
        assert sorted(kids[f.sid]) == ["feedback.fetch", "feedback.plan",
                                       "feedback.replay", "feedback.upload"]
    chunks = [sp for sp in spans if sp.name == "prefill"]
    assert sum(sp.args["length"] * sp.args["lanes"] for sp in chunks) == \
        sum(r.prompt_len for r in reqs)
    assert all("prefill.trunk" in kids[sp.sid] for sp in chunks)
    assert Counter(sp.name for sp in spans
                   if sp.name in ("attn", "mlp")) == Counter(
        {"attn": CFG.n_layers * (len(chunks) + len(decodes)),
         "mlp": CFG.n_layers * (len(chunks) + len(decodes))})
    admits = [sp for sp in spans if sp.name == "admit"]
    assert sorted(sp.request for sp in admits) == \
        sorted(r.request_id for r in reqs)
    for r in reqs:
        phases = sorted((sp for sp in spans if sp.request == r.request_id
                         and sp.name in PHASES), key=lambda s: s.start)
        assert [sp.name for sp in phases] == list(PHASES)
        assert all(a.end == b.start for a, b in zip(phases, phases[1:]))
    assert [t for t, _, _ in tracer.samples] == ["queue", "slots"] * len(its)
    for track, _, values in tracer.samples:
        if track == "slots":
            assert values["live"] + values["free"] == eng.max_slots
    assert not tracer._stack and not tracer._phases
    path_events = tracer.to_chrome()
    assert validate_trace(path_events) == []


def test_wall_spans_written_in_a_process_of_their_own(params, tmp_path):
    _, _, _, tracer = _traced_run(params)
    path = tmp_path / "t.json"
    tracer.write(str(path))
    doc = json.loads(path.read_text())
    assert validate_trace(doc) == []
    procs = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert list(procs.values()) == ["wall"]
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == len(tracer.wall)
    assert min(e["ts"] for e in xs) == 0
    assert doc["otherData"]["wall_origin_ns"] == min(sp.start
                                                     for sp in tracer.wall)
    tracks = {e["args"]["name"] for e in doc["traceEvents"]
              if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"engine", "queue", "slots", "request 0"} <= tracks


def _virtual_run(params, tracer, wall):
    eng, reqs = _engine(params, cost=HybridPhaseCost("ultra-125h"))
    events.install(tracer)
    events.install_wall(wall)
    try:
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle()
    finally:
        events.install(None)
        events.install_wall(None)
    return [r.tokens.tolist() for r in reqs]


def test_wall_tracer_leaves_the_virtual_trace_and_races_alone(params):
    """The wall slot turns on no virtual hook: beside it, a virtual
    ``SpanTracer`` writes the same bytes and the race detector records the
    same events as without it."""
    out = []
    for wall in (None, SpanTracer()):
        virt, rec = SpanTracer(), races.Recorder()
        toks = _virtual_run(params, virt, wall)
        assert _virtual_run(params, rec, wall) == toks
        out.append((json.dumps(virt.to_chrome(), sort_keys=True),
                    rec.events, toks))
        if wall is not None:
            assert any(sp.name == "feedback.replay" for sp in wall.wall)
    assert out[0] == out[1]
    assert out[0][1] and virt.n_spans


def test_disabled_wall_hooks_read_no_clock(params, monkeypatch):
    """With no wall tracer the hook sites call nothing: no clock read, no
    span, no sample (the disabled path is a load and a ``None`` check)."""
    def refuse(*a, **k):
        raise AssertionError("a wall hook ran with no tracer installed")

    monkeypatch.setattr(trace_mod, "wall_ns", refuse)
    for name in ("begin", "end", "request_phase", "sample", "now"):
        monkeypatch.setattr(SpanTracer, name, refuse)
    assert events.WALL is None
    for cost in (None, LinearPhaseCost()):
        eng, reqs = _engine(params, cost=cost)
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle()
        assert all(r.n_generated == 4 for r in reqs)


def test_wall_clock_is_the_profilers():
    """A ``record_function`` range opened inside a wall span lies inside
    it on the profiler's own timestamps: the spans read the clock the
    profiler stamps its events with (``time.time_ns``, Unix-epoch ns)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    tracer = SpanTracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            sp = tracer.begin("outer")
            with record_function("inner"):
                torch.ones(4).sum()
            tracer.end(sp)
    inner = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name() == "inner")
    outer = sorted((sp.start, sp.end) for sp in tracer.wall)
    assert len(inner) == len(outer) == 5
    for (a, b), (s, e) in zip(outer, inner):
        assert a <= s <= e <= b


def test_wall_clock_reads_time_ns(monkeypatch):
    monkeypatch.setattr(trace_mod.time, "time_ns", lambda: 1234)
    t = SpanTracer()
    t.end(t.begin("x"))
    assert (t.wall[0].start, t.wall[0].end) == (1234, 1234)


def test_end_drops_children_left_open():
    t = SpanTracer()
    top = t.begin("iteration")
    t.begin("decode")          # an exception left it open
    t.end(top, rows=2)
    assert [(sp.name, sp.args) for sp in t.wall] == [("iteration",
                                                      {"rows": 2})]
    assert not t._stack and not t._open


def test_deferred_args_resolved_when_read():
    t = SpanTracer()
    calls = []
    t.end(t.begin("decode.launch"),
          device_ms=lambda: calls.append(1) or 2.5)
    assert calls == []
    assert t.wall_spans()[0].args == {"device_ms": 2.5}
    t.wall_spans()
    assert calls == [1]


# --------------------------------------------------- idle under the spans --
def _sp(sid, parent, name, start, end, request=None):
    return WallSpan(sid, parent, name, start, end, request)


SPANS = [_sp(1, 0, "iteration", 0, 50), _sp(2, 1, "prefill", 0, 30),
         _sp(3, 2, "prefill.trunk", 0, 20), _sp(4, 2, "feedback", 20, 30),
         _sp(5, 1, "decode", 30, 50), _sp(6, 5, "feedback", 40, 50),
         _sp(7, 0, "iteration", 50, 100), _sp(8, 7, "decode", 55, 95),
         _sp(9, 8, "pick", 70, 95), _sp(10, 0, "queued", 0, 80, request=3)]


def _load_script():
    spec = importlib.util.spec_from_file_location(
        "wall_spans_script", ROOT / "scripts" / "wall_spans.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _slice():
    """A profiler slice of 0-100 ns, its device busy 10-40, 60-70, 95-."""
    _load_script()                     # puts the benchmark on the path
    from perfbench.harness.trace import Slice

    return Slice(start=0, end=100,
                 device=[("a", 10, 30), ("b", 20, 40), ("a", 60, 70),
                         ("c", 95, 120)],
                 iterations=[(0, 50), (50, 100)])


def test_idle_arithmetic():
    script = _load_script()
    busy = _slice().busy_intervals()
    assert busy == [(10, 40), (60, 70), (95, 100)]
    assert script.idle_within(busy, 0, 100) == 55
    assert script.idle_within(busy, 45, 75) == 20
    assert script.idle_within(busy, 10, 40) == 0
    by = script.idle_by_span(SPANS, busy, 0, 100)
    # 0-10 under prefill.trunk; 40-50 feedback; 50-55 iteration; 55-60
    # decode; 70-95 pick; the request's own track is left out
    assert by == {"prefill.trunk": 10, "feedback": 10, "iteration": 5,
                  "decode": 5, "pick": 25}
    assert script.idle_by_span([], busy, 0, 100) == {"": 55}


def test_wall_spans_script_reads_a_synthetic_slice():
    """``scripts/wall_spans.py``'s per-layer readings on a synthetic
    profiler slice and program spans."""
    from types import SimpleNamespace

    script = _load_script()
    tracer = SpanTracer()
    tracer.wall = list(SPANS)
    req = SimpleNamespace(request=SimpleNamespace(request_id=3), due=1.0)
    out = script.analyse(_slice(), tracer, SimpleNamespace(
        requests=[req], origin=0.0, close=51.0))
    assert out["chunks"] == 1 and out["decode_steps"] == 2
    assert out["prefill_idle_ms"] == pytest.approx(10e-6)
    assert out["feedback_idle_ms"] == pytest.approx(10e-6 / 2)
    assert out["replay_idle_ms"] == 0
    assert out["admit_wait_ms"] == pytest.approx(80e-6)
    assert out["idle_s"] == pytest.approx(55e-9)
    assert out["idle_by_span_s"]["pick"] == pytest.approx(25e-9)
    assert out["idle_under_a_span_share"] == pytest.approx(50 / 55)
    assert out["ops"] == 4 and out["ops_outside_iteration"] == {}


# runs the script in a process of its own: the benchmark's harness refuses
# to run in one where JAX is loaded, as the reference tests load it
_RUN_SCRIPT = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("wall_spans", sys.argv[1])
script = importlib.util.module_from_spec(spec)
spec.loader.exec_module(script)
from perfbench.harness import cell
from repro_torch.core import events
base = cell.Profiler
assert script.main(sys.argv[2:]) == 0
assert events.WALL is None and cell.Profiler is base
"""


@pytest.mark.parametrize("cell,alternate", [("tiny.open", False),
                                            ("tiny.closed", True)])
def test_wall_spans_script_runs_a_cell(tmp_path, cell, alternate):
    """``scripts/wall_spans.py`` end to end on the CPU: the benchmark's
    traced run of a cut cell through its patched profiler, with the spans
    recorded over the window (or every other iteration) and the tracer
    and the harness's profiler put back afterwards."""
    _load_script()                     # puts the benchmark on the path
    from perfbench.tests.conftest import make_tiny_root

    root = make_tiny_root(tmp_path / "bench")
    out = tmp_path / "wall.json"
    argv = ["--workload", cell, "--seed", str(2 ** 31 + 7), "--seconds",
            "1.2", "--root", str(root), "--device", "cpu", "--out", str(out)]
    subprocess.run([sys.executable, "-c", _RUN_SCRIPT,
                    str(ROOT / "scripts" / "wall_spans.py"), *argv]
                   + ["--alternate"] * alternate, check=True, timeout=300,
                   capture_output=True)
    res = json.loads(out.read_text())
    assert res["correct"] is True
    if alternate:
        alt = res["alternate"]
        assert alt["iterations_on"] and alt["iterations_off"]
        assert alt["mean_on_ms"] > 0 and alt["mean_off_ms"] > 0
        return
    # the CPU profile has no device operation: the slice is idle whole,
    # and the idle lies under the engine's spans
    assert res["ops"] == 0 and res["idle_s"] == pytest.approx(res["slice_s"])
    assert res["decode_steps"] > 0 and res["feedback_idle_ms"] > 0
    assert res["admit_wait_requests"] > 0
    assert {"decode", "feedback.replay"} <= set(res["idle_by_span_s"])
    assert sum(res["idle_by_span_s"].values()) == pytest.approx(
        res["idle_s"])


def test_serve_wall_machine_trace_holds_the_engine_spans(tmp_path, capsys):
    """``serve --machine wall --trace PATH`` writes the engine's wall spans
    (a virtual machine's trace is held to the reference's bytes in
    ``test_torch_obs.py``)."""
    from repro_torch.launch import serve

    path = tmp_path / "t.json"
    serve.main(["--device", "cpu", "--preset", "tiny", "--requests", "3",
                "--steps", "4", "--prompt-len", "6", "--batch", "2",
                "--rate", "0", "--machine", "wall", "--balanced-trunk",
                "--trace", str(path)])
    assert "wall spans)" in capsys.readouterr().out
    doc = json.loads(path.read_text())
    assert validate_trace(doc) == []
    names = Counter(e["name"] for e in doc["traceEvents"] if e["ph"] == "X")
    assert names["iteration"] and names["decode.launch"] and names["pick"]
    assert names["queued"] == names["prefilling"] == names["decoding"] == 3
    assert events.WALL is None
