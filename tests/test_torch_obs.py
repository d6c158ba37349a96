"""The port's observability package against the reference's, on the CPU.

``repro_torch.obs`` is a copy of ``repro.obs`` (the Perfetto span tracer,
the metrics registry with its Prometheus exposition, the flight recorder)
installed through the port's own events shim, and
``LatencyReport.publish`` is ported beside it.  Both packages get the same
inputs — the same calls, or the same seeded run with the reference's
weights — and must write the same bytes: every timestamp, counter and
latency they record is on the virtual clock.  ``LatencyReport``'s
``wall_duration`` is the one field on the host's clock, and neither the
trace, the metrics nor the decision ring carries it.
"""

import contextlib
import io
import json
import sys

import jax
import numpy as np
import pytest

import repro.core.events as ref_events
import repro.fleet as ref_fleet
import repro.launch.serve as ref_serve_mod
import repro.obs as ref_obs
import repro.serving as ref_serving
import repro_torch.core.events as port_events
import repro_torch.fleet as port_fleet
import repro_torch.obs as port_obs
import repro_torch.serving as port_serving
from repro.analysis import invariants as ref_invariants
from repro.configs import reduced_config as ref_reduced
from repro.core.hybrid_sim import make_machine as ref_make_machine
from repro.models import BalancedTrunk as RefTrunk
from repro.models import init_params as ref_init_params
from repro.models.transformer import ModelConfig as RefConfig
from repro_torch.analysis import invariants as port_invariants
from repro_torch.configs import ModelConfig as PortConfig
from repro_torch.core.hybrid_sim import make_machine as port_make_machine
from repro_torch.launch import serve as port_serve
from repro_torch.models import params_from_numpy

PKG = {"ref": (ref_obs, ref_events, ref_fleet, ref_serving, ref_invariants,
               ref_make_machine),
       "port": (port_obs, port_events, port_fleet, port_serving,
                port_invariants, port_make_machine)}
CFG = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=128, vocab_size=128, dtype="float32")


@pytest.fixture(autouse=True)
def _clean_hooks():
    """No test may leak an installed tracer or recorder into the next."""
    yield
    for events in (ref_events, port_events):
        events.install(None)
        events.install_recorder(None)


@pytest.fixture(scope="module")
def model():
    params_r = ref_init_params(RefConfig(**CFG), jax.random.key(0))
    return {"ref": (RefConfig(**CFG), params_r, {}),
            "port": (PortConfig(**CFG),
                     params_from_numpy(jax.tree.map(np.asarray, params_r),
                                       device="cpu"),
                     {"device": "cpu"})}


def _both(fn):
    return [fn(*PKG[p]) for p in ("ref", "port")]


def _traced_fleet_run(model, pkg, *, recorder=None, n=10, seed=1):
    """The reference's two-node traced fleet run (``tests/test_obs.py``),
    optionally with a flight recorder; returns (tracer, router, done)."""
    obs, events, fleet, serving, _, _ = PKG[pkg]
    cfg, params, kw = model[pkg]
    cluster = fleet.Cluster.build(
        (fleet.NodeSpec("fast", "ultra-125h", max_slots=3),
         fleet.NodeSpec("mid", "core-12900k", max_slots=3)),
        cfg, params, max_seq=40, seed=0, **kw)
    router = fleet.FleetRouter(cluster, slo_ttft=2.0, slo_tpot=0.25)
    requests = fleet.fleet_requests(n, base_rate=8.0, vocab_size=128,
                                    prompt_len=(4, 12),
                                    max_new_tokens=(3, 5), seed=seed)
    tracer = obs.SpanTracer()
    prev = events.install(tracer)
    prev_rec = (events.install_recorder(recorder) if recorder is not None
                else None)
    try:
        done = router.run(requests)
    finally:
        events.install(prev)
        if recorder is not None:
            events.install_recorder(prev_rec)
    return tracer, router, done


# ------------------------------------------------------------------ tracer --
def test_tracer_calls_give_the_same_trace():
    def run(obs, *_):
        t = obs.SpanTracer()
        t.span("core0", "membw", 0.0, 1e-3, cat="pool")
        t.push_scope("node:big")
        t.push_scope("replica0")
        t.span("core0", "membw", 0.0, 2e-3, args={"units": 8})
        t.counter("queue", 1e-3, {"depth": 3})
        t.pop_scope()
        t.counter("ratio:socket:membw/head", 2e-3, {"s0": 0.4, "s1": 0.6})
        t.pop_scope()
        t.instant("fleet", "route:big", 2e-3, {"rid": 1})
        return (t.to_chrome(), t.n_spans, t.n_counters, t.n_instants,
                obs.validate_trace(t.to_chrome()))

    ref, port = _both(run)
    assert ref == port and port[4] == []


@pytest.mark.parametrize("bad", [
    {"traceEvents": [{"ph": "Z", "pid": 1, "tid": 1, "name": "x", "ts": 0},
                     {"ph": "X", "pid": 1, "tid": 1, "name": "y", "ts": -1,
                      "dur": 1}]},
    {"traceEvents": [{"ph": "M", "pid": 1, "tid": 0, "name": "thread_name",
                      "args": {}}, {"ph": "C", "pid": 2, "tid": 1,
                                    "name": "q", "ts": 1}]},
    {"nope": 1}, {"traceEvents": 3}, {"traceEvents": ["x"]}])
def test_validate_trace_flags_the_same_problems(bad):
    ref, port = _both(lambda obs, *_: obs.validate_trace(bad))
    assert ref == port and port


def test_fleet_trace_equal_and_valid(model, tmp_path):
    """A traced two-node fleet run writes the reference's file byte for
    byte: spans at every balancing level, counters, routing instants."""
    files = []
    for pkg in ("ref", "port"):
        tracer = _traced_fleet_run(model, pkg)[0]
        path = tmp_path / f"{pkg}.json"
        tracer.write(str(path))
        files.append(path.read_bytes())
    assert files[0] == files[1]
    trace = json.loads(files[1])
    assert port_obs.validate_trace(trace) == []
    procs = {e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert {"node:fast/replica0", "node:mid/replica0"} <= procs


def test_disabled_hooks_never_evaluate_payloads():
    """With nothing installed the port's hooks are one global load: the
    payload callables are never called."""
    calls = []
    port_events.install(None)
    port_events.emit_span("t", "n", 0.0, 1.0, args=lambda: calls.append(1))
    port_events.emit_counter("c", 0.0, lambda: calls.append(1))
    port_events.emit_instant("i", "n", 0.0, args=lambda: calls.append(1))
    assert calls == []


# ---------------------------------------------------------------- recorder --
def test_recorder_ring_equal():
    def run(obs, *_):
        r = obs.FlightRecorder(capacity=4)
        for i in range(10):
            r.record("ratio", f"k{i}", float(i), {"i": i})
        return len(r), r.snapshot("test")

    ref, port = _both(run)
    assert ref == port and port[1]["n_dropped"] == 6


@pytest.mark.parametrize("slo", [1e-6, 1e9], ids=["burning", "within-slo"])
def test_recorder_fleet_run_dumps_equal(model, tmp_path, slo):
    """The same decision ring (ratio reports, routes, latencies) and the
    same trips, dumped to the same bytes, on an SLO that burns and on one
    that does not."""
    dumps = []
    for pkg in ("ref", "port"):
        obs = PKG[pkg][0]
        path = tmp_path / f"{pkg}.json"
        rec = obs.FlightRecorder(path=str(path), slo_ttft=slo, slo_tpot=slo,
                                 burn_window=3)
        _traced_fleet_run(model, pkg, recorder=rec)
        if rec.last_dump is None:
            rec.trip("exit")
        dumps.append((path.read_bytes(), rec.trips))
    assert dumps[0] == dumps[1]
    dump = json.loads(dumps[1][0])
    assert dump["schema"] == "repro.obs.flight_recorder/1"
    assert {"latency", "ratio", "route"} <= {r["kind"]
                                             for r in dump["records"]}
    assert (dumps[1][1][0]["reason"].startswith("slo_burn")) == (slo < 1)


def test_contract_violation_trips_the_recorder(tmp_path):
    def run(obs, events, _f, _s, invariants, _m):
        path = tmp_path / f"{id(obs)}.json"
        rec = obs.FlightRecorder(path=str(path))
        rec.record("ratio", "membw/head", 1.0, {"ratios": [0.5, 0.5]})
        prev = events.install_recorder(rec)
        try:
            with pytest.raises(invariants.ContractViolation):
                invariants.check_ema_step([1.0], [1.0], [-1.0])
        finally:
            events.install_recorder(prev)
        return rec.trips, path.read_text()

    ref, port = _both(run)
    assert ref == port and port[0][0]["reason"].startswith("contract IV001")


def test_capacity_events_recorded_alike():
    def run(obs, events, _f, _s, _i, make_machine):
        rec = obs.FlightRecorder()
        prev = events.install_recorder(rec)
        try:
            m = make_machine("ultra-125h")
            m.park(0, t_start=1.0)
            m.set_freq_scale(1, 2.0, t_start=2.0, t_end=3.0)
            m.unpark(0)
        finally:
            events.install_recorder(prev)
        return [r.to_dict() for r in rec.records()]

    ref, port = _both(run)
    assert ref == port and {r["payload"]["action"] for r in port} >= {
        "park", "scale", "unpark"}
    json.dumps(port)


def test_recorder_trip_never_raises():
    rec = port_obs.FlightRecorder(path="/nonexistent-dir/nope/flight.json")
    rec.record("capacity", "core0", 0.0, {"action": "park"})
    assert rec.trip("test")["n_records"] == 1


# ----------------------------------------------------------------- metrics --
def _registry_ops(obs):
    reg = obs.MetricsRegistry()
    c = reg.counter("reqs_total", "requests")
    c.inc(outcome="served")
    c.inc(2, outcome="served")
    c.inc(outcome="shed")
    g = reg.gauge("queue_depth", "depth")
    g.set(5)
    g.inc(-2)
    h = reg.histogram("ttft_seconds", "ttft", buckets=obs.TTFT_BUCKETS)
    h.observe_many([0.05, 0.3, 99.0, 1.5, 2.0])
    h2 = reg.histogram("tpot_seconds", "tpot", buckets=obs.TPOT_BUCKETS)
    h2.observe_many(np.linspace(0.01, 1.0, 17))
    return reg


def test_registry_text_and_json_equal(tmp_path):
    out = []
    for pkg in ("ref", "port"):
        obs = PKG[pkg][0]
        reg = _registry_ops(obs)
        path = tmp_path / f"{pkg}.json"
        reg.write_json(str(path))
        text = reg.prometheus_text()
        out.append((text, path.read_text(), obs.lint_exposition(text),
                    list(reg.get("ttft_seconds").samples())))
    assert out[0] == out[1] and out[1][2] == []


def test_registry_refuses_alike():
    def run(obs, *_):
        reg = obs.MetricsRegistry()
        reg.counter("x_total", "x")
        errors = []
        for call in (lambda: reg.gauge("x_total"),
                     lambda: reg.counter("x_total").inc(-1),
                     lambda: reg.histogram("h", buckets=())):
            with pytest.raises(ValueError) as e:
                call()
            errors.append(str(e.value))
        return errors

    ref, port = _both(run)
    assert ref == port


@pytest.mark.parametrize("text", [
    "orphan_metric 1\n",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 5\nh_bucket{le=\"+Inf\"} 3\n"
    "h_sum 2\nh_count 3\n",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 5\nh_sum 2\nh_count 5\n",
    "# TYPE x counter\nx nope\n"])
def test_exposition_lint_equal(text):
    ref, port = _both(lambda obs, *_: obs.lint_exposition(text))
    assert ref == port and port


# --------------------------------------------------- LatencyReport.publish --
def test_latency_report_publish_equal(model):
    """A fleet run's report (served, degraded and shed requests) published
    into each package's registry: the same exposition and JSON."""
    out = []
    for pkg in ("ref", "port"):
        obs, _, fleet, serving, _, _ = PKG[pkg]
        cfg, params, kw = model[pkg]
        cluster = fleet.Cluster.build(
            (fleet.NodeSpec("fast", "ultra-125h", max_slots=2),), cfg,
            params, max_seq=40, **kw)
        router = fleet.FleetRouter(cluster, admission=fleet.
                                   AdmissionController(queue_cap=4,
                                                       degrade_depth=1))
        done = router.run([serving.Request(prompt=np.arange(6),
                                           max_new_tokens=4,
                                           arrival_time=0.0)
                           for _ in range(8)])
        report = serving.LatencyReport.from_requests(
            done, slo_ttft=2.0, slo_tpot=0.25, wall_duration=1.0 + len(pkg))
        reg = obs.MetricsRegistry()
        report.publish(reg)
        out.append((reg.prometheus_text(), json.dumps(reg.to_json(),
                                                      sort_keys=True),
                    report.n_shed, report.n_degraded))
    assert out[0] == out[1]
    assert out[1][2] > 0 and out[1][3] > 0
    assert port_obs.lint_exposition(out[1][0]) == []


# -------------------------------------------------------------- the serve --
OBS_FLAGS = ["--trace", "trace.json", "--metrics", "metrics.prom",
             "--flight-recorder", "recorder.json"]
SERVE_MODES = {"dense": [], "fleet": ["--fleet"],
               "fleet-admission": ["--fleet", "--fleet-admission"],
               "metrics-json": ["--metrics", "metrics.json"]}


def _cli(tmp_path, pkg, argv, monkeypatch, params_r=None):
    """Run one package's serve main in ``tmp_path / pkg``; returns the
    printed lines and the files it wrote."""
    out_dir = tmp_path / pkg
    out_dir.mkdir()
    monkeypatch.chdir(out_dir)
    buf = io.StringIO()
    if pkg == "ref":
        monkeypatch.setattr(ref_serve_mod, "init_params",
                            lambda cfg, key: params_r)
        monkeypatch.setattr(sys, "argv", ["serve"] + argv)
        with contextlib.redirect_stdout(buf):
            assert ref_serve_mod.main() == 0
    else:
        with contextlib.redirect_stdout(buf):
            assert port_serve.main(argv + ["--device", "cpu"]) == 0
    files = {p.name: p.read_bytes() for p in sorted(out_dir.iterdir())}
    return buf.getvalue().splitlines(), files


@pytest.fixture(scope="module")
def tiny_params():
    return ref_init_params(ref_reduced("llama2-7b"), jax.random.key(0))


@pytest.mark.parametrize("mode", list(SERVE_MODES))
def test_serve_observability_files_equal(tmp_path, monkeypatch, mode,
                                         tiny_params):
    """``serve --trace --metrics --flight-recorder`` writes the reference's
    three files byte for byte and prints the reference's lines about them
    (the dense model with the port's own weights: every recorded figure is
    on the virtual clock, so the weights do not enter)."""
    argv = ["--arch", "llama2-7b", "--preset", "tiny", "--requests", "4",
            "--steps", "4", "--prompt-len", "8"] + OBS_FLAGS
    argv += SERVE_MODES[mode]
    ref_lines, ref_files = _cli(tmp_path, "ref", argv, monkeypatch,
                                tiny_params)
    port_lines, port_files = _cli(tmp_path, "port", argv, monkeypatch)
    assert sorted(port_files) == sorted(ref_files)
    for name, data in ref_files.items():
        assert port_files[name] == data, name
    tail = [l for l in ref_lines if l.startswith(("[serve] wrote",
                                                  "[serve] flight"))]
    assert tail and port_lines[-len(tail):] == tail
    trace = json.loads(port_files["trace.json"])
    assert port_obs.validate_trace(trace) == []


def test_serve_topology_observability_files_equal(tmp_path, monkeypatch,
                                                  tiny_params):
    """The same under ``--topology dual-125h`` with the compiled Q4 trunk
    (the reference's trunk in compiled mode, on the shared weights): the
    two-level feedback replay's per-socket dispatch spans and per-core
    ratio counters included."""
    argv = ["--arch", "llama2-7b", "--preset", "tiny", "--topology",
            "dual-125h", "--requests", "3", "--steps", "3", "--prompt-len",
            "6", "--batch", "2"] + OBS_FLAGS

    class Trunk:
        @staticmethod
        def from_params(*a, **k):
            return RefTrunk.from_params(*a, mode="compiled", **k)

    monkeypatch.setattr(ref_serve_mod, "BalancedTrunk", Trunk)
    ref_lines, ref_files = _cli(tmp_path, "ref", argv, monkeypatch,
                                tiny_params)
    params_p = params_from_numpy(jax.tree.map(np.asarray, tiny_params),
                                 device="cpu")
    monkeypatch.setattr(port_serve, "init_params",
                        lambda cfg, gen, device: params_p)
    port_lines, port_files = _cli(tmp_path, "port", argv, monkeypatch)
    for name, data in ref_files.items():
        assert port_files[name] == data, name
    counters = [e for e in json.loads(port_files["trace.json"])
                ["traceEvents"] if e["ph"] == "C"
                and e["name"].startswith("ratio:membw/")]
    assert {len(e["args"]) for e in counters} == {14}   # cores per socket
    assert port_lines[:-3] == [l.replace("(virtual clock)",
                                         "(virtual clock) on cpu", 1)
                               for l in ref_lines[:-3]]
