"""The port's fleet package against the reference's, on the CPU.

``repro_torch.fleet`` is a copy of ``repro.fleet`` (traffic and node
events, admission control, the cluster of per-socket engines, the
recursive fleet router) over the port's serving engines, which take an
explicit ``device``.  Both packages serve the configurations of
``tests/test_fleet.py`` and ``tests/test_elastic.py`` — a tiny dense model
with the reference's weights, three or four heterogeneous nodes, seeded
diurnal heavy-tailed traffic, failure windows and capacity events — and
must route, requeue, shed, time and learn alike: the fleet runs on the
virtual clock in float64 numpy in both, so the routed counts, the latency
reports, the node ratio tables and every request's timeline are equal
exactly.  The latency reports are compared less ``wall_duration_s``, the
one field on the host's clock.
"""

import contextlib
import io
import sys

import jax
import numpy as np
import pytest

import repro.fleet as ref_fleet
import repro.launch.serve as ref_serve_mod
import repro.serving as ref_serving
import repro_torch.fleet as port_fleet
import repro_torch.serving as port_serving
from repro.configs import reduced_config as ref_reduced
from repro.models import init_params as ref_init_params
from repro.models.transformer import ModelConfig as RefConfig
from repro_torch.configs import ModelConfig as PortConfig
from repro_torch.configs import reduced_config
from repro_torch.launch import serve as port_serve
from repro_torch.models import params_from_numpy

CFG = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=128, vocab_size=128, dtype="float32")
THROTTLE = 3.0
SPECS = (("fast", "ultra-125h", dict(max_slots=3)),
         ("mid", "core-12900k", dict(max_slots=3)),
         ("slow", "ultra-125h", dict(max_slots=3, throttle=THROTTLE)))
NUMA_SPECS = (("big", "dual-125h", dict(max_slots=2, prefill_lanes=2)),
              ("mid", "2s-12900k", dict(max_slots=2, prefill_lanes=2)),
              ("flat", "ultra-125h", dict(max_slots=2)),
              ("slow", "ultra-125h", dict(max_slots=2, throttle=THROTTLE)))
SLO_TTFT, SLO_TPOT = 2.0, 0.25


@pytest.fixture(scope="module")
def model():
    cfg_r, cfg_p = RefConfig(**CFG), PortConfig(**CFG)
    params_r = ref_init_params(cfg_r, jax.random.key(0))
    params_p = params_from_numpy(jax.tree.map(np.asarray, params_r),
                                 device="cpu")
    return {"ref": (cfg_r, params_r, ref_fleet, ref_serving, {}),
            "port": (cfg_p, params_p, port_fleet, port_serving,
                     {"device": "cpu"})}


def _cluster(model, pkg, specs=SPECS, seed=0):
    cfg, params, fleet, _, kw = model[pkg]
    return fleet.Cluster.build([fleet.NodeSpec(n, t, **o)
                                for n, t, o in specs],
                               cfg, params, max_seq=48, seed=seed, **kw)


def _traffic(fleet, n=32, rate=8.0, seed=1):
    return fleet.fleet_requests(n, base_rate=rate, vocab_size=128,
                                prompt_len=(4, 20), max_new_tokens=(4, 8),
                                swing=0.6, period=4.0, seed=seed)


def _report_dict(report):
    d = report.to_dict()
    d.pop("wall_duration_s")   # the host's clock
    return d


def _request_rows(requests):
    return [(r.generated, r.arrival_time, r.admit_time, r.first_token_time,
             r.finish_time, r.finish_reason.value, r.max_new_tokens,
             r.degraded) for r in requests]


def _fleet_run(model, pkg, policy, events=(), admission=None, specs=SPECS,
               traffic=None):
    cfg, params, fleet, serving, kw = model[pkg]
    cluster = _cluster(model, pkg, specs)
    router = fleet.FleetRouter(
        cluster, policy=policy, slo_ttft=SLO_TTFT, slo_tpot=SLO_TPOT,
        admission=(fleet.AdmissionController(**admission)
                   if admission is not None else None))
    requests = (traffic or _traffic)(fleet)
    done = router.run(requests,
                      [fleet.NodeEvent(*e) for e in events])
    report = serving.LatencyReport.from_requests(done, slo_ttft=SLO_TTFT,
                                                 slo_tpot=SLO_TPOT)
    return router, done, report


def _assert_runs_equal(ref, port):
    (rr, dr, repr_), (rp, dp, repp) = ref, port
    assert rr.routed.tolist() == rp.routed.tolist()
    assert rr.n_requeued == rp.n_requeued
    assert rr.n_parked == rp.n_parked
    assert _report_dict(repr_) == _report_dict(repp)
    assert repr_.lines() == repp.lines()
    for phase in ("prefill", "decode"):
        np.testing.assert_array_equal(rr.table.ratios(phase),
                                      rp.table.ratios(phase))
        np.testing.assert_array_equal(rr.node_tps(phase), rp.node_tps(phase))
    assert _request_rows(dr) == _request_rows(dp)
    assert sorted(rr.last_stats) == sorted(rp.last_stats)
    for phase, st in rr.last_stats.items():
        assert len(st.children) == len(rp.last_stats[phase].children)
    for nr, np_ in zip(rr.cluster.nodes, rp.cluster.nodes, strict=True):
        for er, ep in zip(nr.engines, np_.engines, strict=True):
            assert er.now == ep.now
            for key in er.cost_model.table.keys():
                np.testing.assert_array_equal(er.cost_model.table.ratios(key),
                                              ep.cost_model.table.ratios(key))


# --------------------------------------------------------------- traffic --
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_fleet_traffic_equal(seed):
    ref, port = (_traffic(f, seed=seed) for f in (ref_fleet, port_fleet))
    assert [(list(r.prompt), r.arrival_time, r.max_new_tokens) for r in ref] \
        == [(list(r.prompt), r.arrival_time, r.max_new_tokens) for r in port]


def test_diurnal_rate_and_events_equal():
    ref, port = (f.diurnal_rate(10.0, swing=0.4, period=3.0)
                 for f in (ref_fleet, port_fleet))
    assert [ref(t) for t in np.linspace(0, 9, 37)] == \
        [port(t) for t in np.linspace(0, 9, 37)]
    assert ([vars(e) for e in ref_fleet.failure_window("a", 1.0, 2.0)]
            == [vars(e) for e in port_fleet.failure_window("a", 1.0, 2.0)])
    for fleet in (ref_fleet, port_fleet):
        with pytest.raises(ValueError):
            fleet.NodeEvent(time=0.0, node="a", kind="reboot")
        with pytest.raises(ValueError):
            fleet.failure_window("a", 2.0, 1.0)


# ------------------------------------------------------------- the cluster --
def test_cluster_shape_and_nominal_shares_equal(model):
    ref, port = (_cluster(model, p, NUMA_SPECS) for p in ("ref", "port"))
    assert [len(n.engines) for n in ref.nodes] == \
        [len(n.engines) for n in port.nodes] == [2, 2, 1, 1]
    np.testing.assert_array_equal(ref.nominal_shares(),
                                  port.nominal_shares())
    assert all(e.device.type == "cpu" for n in port.nodes
               for e in n.engines)


def test_cluster_validation(model):
    cfg, params, fleet, _, kw = model["port"]
    with pytest.raises(ValueError):
        fleet.NodeSpec("x", "ultra-125h", throttle=0.5)
    with pytest.raises(ValueError):
        fleet.Cluster.build([fleet.NodeSpec("a", "ultra-125h"),
                             fleet.NodeSpec("a", "core-12900k")],
                            cfg, params, max_seq=32, **kw)


# -------------------------------------------------------------- fleet runs --
# (policy, failure window, admission): every policy with the reference's
# mid-run outage of "mid", with and without the SLO-aware front door
RUNS = [("learned", True, None), ("round_robin", True, None),
        ("static", True, None), ("learned", False, None),
        ("learned", True, dict(queue_cap=6, degrade_depth=3)),
        ("round_robin", True, dict(queue_cap=6, degrade_depth=3)),
        ("static", False, dict(queue_cap=4))]
RUN_IDS = [f"{p}-{'outage' if o else 'steady'}-"
           f"{'admission' if a else 'open'}" for p, o, a in RUNS]


@pytest.mark.parametrize("policy,outage,admission", RUNS, ids=RUN_IDS)
def test_fleet_run_equal(model, policy, outage, admission):
    """Routed counts, requeues, the latency report, the node ratio tables,
    every request's tokens and timeline, and every engine's clock and
    per-core tables."""
    events = [(1.5, "mid", "fail"), (3.5, "mid", "recover")] if outage \
        else []
    ref, port = (_fleet_run(model, p, policy, events, admission)
                 for p in ("ref", "port"))
    _assert_runs_equal(ref, port)
    assert len(port[1]) == 32


def test_fleet_numa_nodes_equal(model):
    """Four nodes, two of them NUMA (one engine per socket): the default
    fleet's shape, with the flagship failing and recovering."""
    events = [(0.5, "big", "fail"), (1.2, "big", "recover")]
    ref, port = (_fleet_run(model, p, "learned", events, specs=NUMA_SPECS,
                            traffic=lambda f: _traffic(f, n=24, rate=12.0,
                                                       seed=3))
                 for p in ("ref", "port"))
    _assert_runs_equal(ref, port)
    assert port[0].n_requeued == ref[0].n_requeued


def test_fleet_wide_outage_parks_and_recovers(model):
    """Every node down: arrivals park at the router and flush through
    admission and routing on the first recovery, alike."""
    events = []
    for name, _, _ in SPECS:
        events += [(0.3, name, "fail"), (0.9, name, "recover")]
    ref, port = (_fleet_run(model, p, "learned", events,
                            traffic=lambda f: _traffic(f, n=16, rate=10.0,
                                                       seed=5))
                 for p in ("ref", "port"))
    _assert_runs_equal(ref, port)
    assert port[0].n_parked > 0


@pytest.mark.parametrize("case", ["shed", "degrade", "deadline"])
def test_admission_verdicts_equal(model, case):
    """Queue-cap shedding, graceful degradation and deadline shedding on a
    warmed estimator, from the reference's admission tests."""
    out = []
    for pkg in ("ref", "port"):
        cfg, params, fleet, serving, kw = model[pkg]
        cluster = _cluster(model, pkg)
        if case == "deadline":
            router = fleet.FleetRouter(
                cluster, admission=fleet.AdmissionController())
            router.run(_traffic(fleet, n=8, rate=50.0, seed=4))
            adm = fleet.AdmissionController()
            router.admission = adm
            reqs = [serving.Request(prompt=np.arange(16), max_new_tokens=8,
                                    arrival_time=router.now,
                                    deadline=router.now + d)
                    for d in (1e-4, 60.0)]
            verdicts = [router.submit(r) for r in reqs]
            router.run([])
            done = reqs
        else:
            adm = (fleet.AdmissionController(queue_cap=4) if case == "shed"
                   else fleet.AdmissionController(degrade_depth=0,
                                                  degrade_factor=0.5))
            router = fleet.FleetRouter(cluster, admission=adm)
            reqs = [serving.Request(prompt=np.arange(6),
                                    max_new_tokens=8 if case == "degrade"
                                    else 4, arrival_time=0.0)
                    for _ in range(12 if case == "shed" else 6)]
            done = router.run(reqs)
            verdicts = [r.finish_reason.value for r in done]
        report = serving.LatencyReport.from_requests(done)
        out.append((adm.n_shed, adm.n_degraded, verdicts,
                    _request_rows(done), _report_dict(report)))
    assert out[0] == out[1]
    assert out[1][0] + out[1][1] > 0


# -------------------------------------------------------- elastic capacity --
def _node(model, pkg, spec, seed=0):
    cfg, params, fleet, _, kw = model[pkg]
    return fleet.Node(fleet.NodeSpec(*spec[:2], **spec[2]), cfg, params,
                      max_seq=48, seed=seed, **kw)


def test_partial_park_shrinks_slot_budget(model):
    out = []
    for pkg in ("ref", "port"):
        node = _node(model, pkg, ("n0", "2s-12900k", dict(max_slots=4)))
        node.topology.park_core(0)
        node.topology.park_core(1)
        node.replan_capacity()
        out.append(([e.slot_budget for e in node.engines],
                    node.dispatcher.active.tolist(), node.nominal_capacity))
    assert out[0] == out[1]
    assert out[1][0] == [4, 4] or out[1][0][0] < 4


def test_full_socket_park_freezes_and_resumes(model):
    """A fully parked socket freezes its admitted work (never aborts it),
    its waiting requests move to the live socket, and unparking resumes
    it — alike, request by request."""
    out = []
    for pkg in ("ref", "port"):
        cfg, params, fleet, serving, kw = model[pkg]
        node = _node(model, pkg, ("n0", "2s-12900k", dict(max_slots=2)))
        reqs = [serving.Request(prompt=np.arange(5) + i, max_new_tokens=6,
                                arrival_time=0.0) for i in range(8)]
        for r in reqs:
            node.submit(r)
        for _ in range(3):
            node.step()
        node.topology.park_socket(1)
        node.replan_capacity()
        frozen = (node.dispatcher.active.tolist(),
                  [e.n_waiting for e in node.engines])
        for _ in range(6):
            node.step()
        node.topology.unpark_socket(1)
        node.replan_capacity()
        while node.has_work:
            node.step()
        out.append((frozen, _request_rows(reqs),
                    [e.now for e in node.engines]))
    assert out[0] == out[1]
    assert all(row[5] == "length" for row in out[1][1])


def test_all_sockets_parked_defers_to_pending(model):
    out = []
    for pkg in ("ref", "port"):
        cfg, params, fleet, serving, kw = model[pkg]
        node = _node(model, pkg, ("n0", "2s-12900k", dict(max_slots=2)))
        node.topology.park_socket(0)
        node.topology.park_socket(1)
        node.replan_capacity()
        reqs = [serving.Request(prompt=np.arange(5), max_new_tokens=3,
                                arrival_time=0.0) for _ in range(3)]
        for r in reqs:
            node.submit(r)
        pending = len(node.dispatcher.pending)
        node.topology.unpark_socket(0)
        node.topology.unpark_socket(1)
        node.replan_capacity()
        while node.has_work:
            node.step()
        out.append((pending, _request_rows(reqs)))
    assert out[0] == out[1] and out[1][0] == 3


def test_capacity_event_mid_fleet_run(model):
    """A socket of the NUMA flagship parked for a window mid-run, the node
    re-planned at the window's edges between router steps."""
    out = []
    for pkg in ("ref", "port"):
        cfg, params, fleet, serving, kw = model[pkg]
        cluster = _cluster(model, pkg, NUMA_SPECS)
        router = fleet.FleetRouter(cluster, slo_ttft=SLO_TTFT,
                                   slo_tpot=SLO_TPOT)
        big = cluster.by_name["big"]
        requests = _traffic(fleet, n=20, rate=12.0, seed=6)
        parked = False
        for r in requests:
            while router.has_work and router.now < r.arrival_time:
                router.step()
            if not parked and router.now > 0.4:
                big.topology.park_socket(1)
                big.replan_capacity()
                parked = True
            router.submit(r)
        big.topology.unpark_socket(1)
        big.replan_capacity()
        while router.has_work:
            router.step()
        done = router.finished + [r for n in cluster.nodes
                                  for r in n.poll_finished()]
        report = serving.LatencyReport.from_requests(done)
        out.append((router.routed.tolist(), _request_rows(requests),
                    _report_dict(report), parked))
    assert out[0] == out[1]
    assert out[1][3]


# -------------------------------------------------------------- the serve --
SERVE_FLEET = [[], ["--fleet-admission"], ["--fleet-policy", "round_robin"],
               ["--fleet-policy", "static", "--fleet-admission"]]


def _ref_fleet_lines(monkeypatch, params_r, argv):
    monkeypatch.setattr(ref_serve_mod, "init_params",
                        lambda cfg, key: params_r)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert ref_serve_mod.main() == 0
    return out.getvalue().splitlines()


@pytest.fixture(scope="module")
def tiny():
    cfg_r = ref_reduced("llama2-7b")
    params_r = ref_init_params(cfg_r, jax.random.key(0))
    return params_r, params_from_numpy(jax.tree.map(np.asarray, params_r),
                                       device="cpu")


@pytest.mark.parametrize("extra", SERVE_FLEET,
                         ids=["learned", "admission", "round-robin",
                              "static-admission"])
def test_serve_fleet_lines_equal(monkeypatch, tiny, extra):
    """``serve --fleet``: the default fleet (big and mid NUMA, flat, slow)
    under diurnal traffic and the flagship's outage — every printed line
    equal to the reference's (none of them is on the host's clock)."""
    argv = ["--arch", "llama2-7b", "--preset", "tiny", "--fleet",
            "--requests", "8", "--steps", "4", "--prompt-len", "12"] + extra
    want = _ref_fleet_lines(monkeypatch, tiny[0], argv)
    args = port_serve.build_parser().parse_args(argv + ["--device", "cpu"])
    run = port_serve.serve_fleet(args, params=tiny[1])
    assert port_serve.fleet_lines(args, run) == want
    assert len(run.cluster.nodes) == 4
    assert sum(len(n.engines) for n in run.cluster.nodes) == 6


def test_serve_fleet_ratio_store_roundtrip(monkeypatch, tiny, tmp_path):
    """``--fleet --ratios``: the node table is saved, then warm-starts the
    next run, with the reference's lines both times."""
    for pkg in ("ref", "port"):
        path = tmp_path / f"{pkg}.json"
        argv = ["--arch", "llama2-7b", "--preset", "tiny", "--fleet",
                "--requests", "6", "--steps", "3", "--prompt-len", "8",
                "--ratios", str(path)]
        runs = []
        for _ in range(2):
            if pkg == "ref":
                runs.append(_ref_fleet_lines(monkeypatch, tiny[0], argv))
            else:
                args = port_serve.build_parser().parse_args(
                    argv + ["--device", "cpu"])
                runs.append(port_serve.fleet_lines(
                    args, port_serve.serve_fleet(args, params=tiny[1])))
        if pkg == "ref":
            want = [[l.replace("ref.json", "port.json") for l in r]
                    for r in runs]
        else:
            assert runs == want
            assert runs[1][0].startswith("[serve] warm-started fleet node")


def test_serve_fleet_cli_on_cpu(capsys):
    rc = port_serve.main(["--device", "cpu", "--preset", "tiny", "--fleet",
                          "--requests", "6", "--steps", "3",
                          "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[serve] fleet ['big', 'mid', 'flat', 'slow'] policy=learned" \
        in out
    assert "node domains under the fleet table" in out
