"""The rest of the serving engine, port against reference, on the CPU:
multi-lane prefill, the balanced LM head, the seed-era ``ServeEngine`` /
``RoutedServer`` batch API and the serve CLI's modes for them, plus the
decode state and offset snapshot at fixed addresses that the captured
decode step reads.

Parity runs use the reduced llama2-7b (f32) with the reference's weights
carried across through ``params_from_numpy``, an ``ultra-125h`` virtual
clock and seeded traffic of mixed prompt lengths; greedy tokens, every
request's virtual-clock timeline, the latency report and every ratio
table must be equal exactly (see ``tests/test_torch_serving.py``).  The
legacy tests use the reference's 2-layer test model.
"""

import jax
import numpy as np
import pytest
import torch

import repro.serving as ref_serving
import repro_torch.serving as port_serving
from repro.configs import reduced_config as ref_reduced
from repro.configs.base import ModelConfig as RefModelConfig
from repro.kernels.dispatch import HybridKernelDispatcher as RefDisp
from repro.models import BalancedTrunk as RefTrunk
from repro.models import balanced_lm_head as ref_balanced_lm_head
from repro.models import init_params as ref_init_params
from repro_torch.configs import reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dispatch import HybridKernelDispatcher as PortDisp
from repro_torch.launch import serve as port_serve
from repro_torch.models import (BalancedTrunk, balanced_lm_head,
                                params_from_numpy)
from repro_torch.runtime import OffsetSnapshot, OffsetSpec
from repro_torch.serving.step_graph import StepGraph


@pytest.fixture(scope="module")
def weights():
    cfg_r, cfg_p = ref_reduced("llama2-7b"), reduced_config("llama2-7b")
    params_r = ref_init_params(cfg_r, jax.random.key(0))
    params_p = params_from_numpy(jax.tree.map(np.asarray, params_r),
                                 device="cpu")
    return cfg_r, cfg_p, params_r, params_p


def _traffic(serving, vocab):
    """Five requests of 4-12 prompt tokens arriving within a few virtual
    milliseconds, so up to four lanes prefill together with chunks of
    mixed lengths."""
    return serving.poisson_requests(5, rate=400.0, vocab_size=vocab,
                                    prompt_len=(4, 13), max_new_tokens=4,
                                    seed=2)


def _serve(pkg, weights, trunk, lanes=1, head=False):
    """One serving run.  ``trunk`` is (quant, mode) or None (the dense
    model); ``head`` adds a balanced LM head (over a trunk without one)."""
    cfg_r, cfg_p, params_r, params_p = weights
    quant, mode = trunk if trunk else (None, "compiled")
    if pkg == "ref":
        cfg, params, serving = cfg_r, params_r, ref_serving
        disp = RefDisp.virtual("ultra-125h", execute=True)
        kw = ({"mode": "compiled"} if mode == "compiled" else
              {"jit_bridge": False, "pin_q4_blocks": True})
        bt = (RefTrunk.from_params(cfg, params, disp, quant=quant,
                                   include_head=not head, **kw)
              if quant else None)
        bh = ref_balanced_lm_head(cfg, params, disp) if head else None
        dev = {}
    else:
        cfg, params, serving = cfg_p, params_p, port_serving
        disp = PortDisp.virtual("ultra-125h",
                                execute=mode == "eager" or head)
        bt = (BalancedTrunk.from_params(cfg, params, disp, quant=quant,
                                        mode=mode, include_head=not head,
                                        device="cpu") if quant else None)
        bh = (balanced_lm_head(cfg, params, disp, device="cpu") if head
              else None)
        dev = {"device": "cpu"}
    engine = serving.ContinuousBatchingEngine(
        cfg, params, max_slots=4, max_seq=24, prefill_chunk=4,
        prefill_lanes=lanes, cost_model=serving.HybridPhaseCost("ultra-125h"),
        balanced_trunk=bt, balanced_head=bh, **dev)
    requests = _traffic(serving, cfg.vocab_size)
    for r in requests:
        engine.submit(r)
    stats = engine.run_until_idle()
    report = serving.LatencyReport.from_requests(requests)
    return requests, disp, engine, report, stats


class _Runs(dict):
    """(package, trunk, lanes, head) -> serving run, made on first use."""

    def __init__(self, weights):
        super().__init__()
        self.weights = weights

    def __missing__(self, key):
        pkg, trunk, lanes, head = key
        self[key] = _serve(pkg, self.weights, trunk, lanes, head)
        return self[key]


@pytest.fixture(scope="module")
def runs(weights):
    return _Runs(weights)


def _both(runs, trunk, lanes, head=False):
    return runs[("ref", trunk, lanes, head)], runs[("port", trunk, lanes,
                                                    head)]


def _assert_requests_equal(ref, port):
    assert [r.generated for r in ref[0]] == [r.generated for r in port[0]]
    for a, b in zip(ref[0], port[0]):
        for field in ("arrival_time", "admit_time", "first_token_time",
                      "finish_time", "request_id", "prefill_done"):
            assert getattr(a, field) == getattr(b, field), field
        assert a.finish_reason.value == b.finish_reason.value
    assert ([(s.prefill_tokens, s.decode_tokens, s.now, s.admitted,
              s.finished) for s in ref[4]]
            == [(s.prefill_tokens, s.decode_tokens, s.now, s.admitted,
                 s.finished) for s in port[4]])


def _assert_tables_equal(ref, port):
    assert sorted(ref[1].table.keys()) == sorted(port[1].table.keys())
    for key in ref[1].table.keys():
        np.testing.assert_array_equal(ref[1].table.ratios(key),
                                      port[1].table.ratios(key))
    ct_r, ct_p = ref[2].cost_model.table, port[2].cost_model.table
    assert sorted(ct_r.keys()) == sorted(ct_p.keys())
    for key in ct_r.keys():
        np.testing.assert_array_equal(ct_r.ratios(key), ct_p.ratios(key))


# ------------------------------------------------------ multi-lane prefill --
# (quant, mode) of the balanced trunk; None serves the dense model
LANE_TRUNKS = [("q4", "compiled"), ("int8", "compiled"), ("fp32", "compiled"),
               ("q4", "eager"), None]
LANE_IDS = ["compiled-q4", "compiled-int8", "compiled-fp32", "eager-q4",
            "dense"]


@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("trunk", LANE_TRUNKS, ids=LANE_IDS)
def test_lanes_tokens_and_timelines_equal(runs, trunk, lanes):
    ref, port = _both(runs, trunk, lanes)
    _assert_requests_equal(ref, port)
    assert all(r.n_generated == 4 for r in port[0])
    # the lanes really ran together: some iteration prefilled several
    # prompts' chunks in one trunk call
    assert max(s.prefill_tokens for s in port[4]) > 4


@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("trunk", LANE_TRUNKS, ids=LANE_IDS)
def test_lanes_latency_report_equal(runs, trunk, lanes):
    ref, port = _both(runs, trunk, lanes)
    assert ref[3].to_dict() == port[3].to_dict()
    assert ref[3].lines() == port[3].lines()


@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("trunk", LANE_TRUNKS, ids=LANE_IDS)
def test_lanes_ratio_tables_equal(runs, trunk, lanes):
    ref, port = _both(runs, trunk, lanes)
    _assert_tables_equal(ref, port)
    if trunk is not None:
        assert (ref[1].achieved_bandwidth_fraction()
                == port[1].achieved_bandwidth_fraction())


@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("trunk", LANE_TRUNKS, ids=LANE_IDS)
def test_lanes_tokens_equal_one_lane(runs, trunk, lanes):
    """Batching prefills is a throughput change only: the port's tokens
    equal its one-lane run's, in fewer iterations."""
    one, many = runs[("port", trunk, 1, False)], runs[("port", trunk, lanes,
                                                       False)]
    assert [r.generated for r in one[0]] == [r.generated for r in many[0]]
    assert len(many[4]) < len(one[4])


@pytest.mark.parametrize("lanes", [2, 4])
def test_lanes_leave_no_partial_state(runs, lanes):
    engine = runs[("port", ("q4", "compiled"), lanes, False)][2]
    assert engine._partials == {} and engine._partial is None
    assert engine.manager.n_free == engine.max_slots
    assert not engine.has_work


# -------------------------------------------------------- balanced head --
@pytest.mark.parametrize("trunk", [None, ("q4", "compiled")],
                         ids=["dense", "compiled-q4-headless"])
def test_balanced_head_tokens_timelines_and_tables_equal(runs, trunk):
    """The engine decodes through the balanced Q4 head (eager per-core
    shards outside the step): requests finish, both phase ISA keys are
    learned from real shard dispatches, and tokens, timelines and every
    ratio table equal the reference's."""
    ref, port = _both(runs, trunk, 1, head=True)
    _assert_requests_equal(ref, port)
    _assert_tables_equal(ref, port)
    assert all(r.n_generated == 4 for r in port[0])
    disp = port[1]
    assert {"avx_vnni", "membw"} <= set(disp.table.keys())
    assert disp.achieved_bandwidth("membw") > 0
    assert (ref[1].achieved_bandwidth("membw")
            == disp.achieved_bandwidth("membw"))
    spread = disp.table.ratios("membw")
    assert spread.max() / spread.min() > 1.1  # hybrid cores differentiated


def test_balanced_head_keys_alone_without_trunk(runs):
    """A head over the dense model learns only the two phase ISA keys."""
    port = runs[("port", None, 1, True)]
    assert sorted(port[1].table.keys()) == ["avx_vnni", "membw"]


def test_balanced_head_and_trunk_head_refused(weights):
    cfg_p, params_p = weights[1], weights[3]
    disp = PortDisp.virtual("ultra-125h", execute=True)
    trunk = BalancedTrunk.from_params(cfg_p, params_p, disp, device="cpu")
    with pytest.raises(ValueError, match="either balanced_head"):
        port_serving.ContinuousBatchingEngine(
            cfg_p, params_p, max_slots=2, max_seq=16, balanced_trunk=trunk,
            balanced_head=balanced_lm_head(cfg_p, params_p, disp,
                                           device="cpu"),
            device="cpu")


# --------------------------------------- the reference's lane tests, ported --
CFG_R = RefModelConfig(name="t", family="dense", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                       dtype="float32")
CFG_P = ModelConfig(name="t", family="dense", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                    dtype="float32")


@pytest.fixture(scope="module")
def small():
    params_r = ref_init_params(CFG_R, jax.random.key(0))
    return params_r, params_from_numpy(jax.tree.map(np.asarray, params_r),
                                       device="cpu")


def _small_engine(pkg, small, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_seq", 32)
    if pkg == "ref":
        return ref_serving.ContinuousBatchingEngine(
            CFG_R, small[0], cost_model=ref_serving.LinearPhaseCost(), **kw)
    return port_serving.ContinuousBatchingEngine(
        CFG_P, small[1], cost_model=port_serving.LinearPhaseCost(),
        device="cpu", **kw)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_prefill_lanes_identical_tokens(small, pkg):
    """Batching queued prefills into one trunk call per iteration is a pure
    throughput change: per-request tokens are identical to the single-lane
    engine's, in fewer iterations (``tests/test_continuous_batching.py``);
    the port's tokens equal the reference's."""
    serving = ref_serving if pkg == "ref" else port_serving
    steps, tokens = {}, {}
    for lanes in (1, 2, 3):
        eng = _small_engine(pkg, small, max_slots=4, prefill_chunk=8,
                            prefill_lanes=lanes)
        reqs = [serving.Request(
            prompt=np.arange(n, dtype=np.int32) % CFG_P.vocab_size,
            max_new_tokens=4) for n in (5, 11, 7, 13)]
        for r in reqs:
            eng.submit(r)
        steps[lanes] = len(eng.run_until_idle(max_steps=200))
        tokens[lanes] = [r.tokens for r in reqs]
        assert all(r.state is serving.RequestState.FINISHED for r in reqs)
    for lanes in (2, 3):
        for a, b in zip(tokens[1], tokens[lanes]):
            np.testing.assert_array_equal(a, b)
        assert steps[lanes] < steps[1]
    if pkg == "port":
        ref_eng = _small_engine("ref", small, max_slots=4, prefill_chunk=8,
                                prefill_lanes=3)
        reqs = [ref_serving.Request(
            prompt=np.arange(n, dtype=np.int32) % CFG_R.vocab_size,
            max_new_tokens=4) for n in (5, 11, 7, 13)]
        for r in reqs:
            ref_eng.submit(r)
        ref_eng.run_until_idle(max_steps=200)
        for a, b in zip(reqs, tokens[3]):
            np.testing.assert_array_equal(a.tokens, b)


def test_prefill_lanes_abort_mid_prefill(small):
    """Aborting one lane mid-prefill frees its slot and partial state while
    the surviving lane finishes normally, with the tokens of a fresh
    single-lane run."""
    S = port_serving
    eng = _small_engine("port", small, prefill_chunk=2, prefill_lanes=2)
    a = S.Request(prompt=np.arange(12, dtype=np.int32) % 128,
                  max_new_tokens=3)
    b = S.Request(prompt=np.arange(10, dtype=np.int32) % 128,
                  max_new_tokens=3)
    eng.submit(a)
    eng.submit(b)
    eng.step()
    assert a.state is S.RequestState.PREFILL
    assert b.state is S.RequestState.PREFILL
    assert eng.n_prefilling == 2
    assert eng.abort(a) and a.finish_reason is S.FinishReason.ABORTED
    assert eng.n_prefilling == 1
    assert a.request_id not in eng._partials
    eng.run_until_idle(max_steps=100)
    assert b.state is S.RequestState.FINISHED
    assert eng.manager.n_free == 2
    ref = S.Request(prompt=np.arange(10, dtype=np.int32) % 128,
                    max_new_tokens=3)
    ref_eng = _small_engine("port", small, max_slots=1, prefill_chunk=2)
    ref_eng.submit(ref)
    ref_eng.run_until_idle(max_steps=100)
    np.testing.assert_array_equal(b.tokens, ref.tokens)


def test_prefill_lanes_must_be_positive(small):
    with pytest.raises(ValueError, match="prefill_lanes"):
        _small_engine("port", small, prefill_lanes=0)


# ------------------------------------------ ServeEngine and RoutedServer --
def _servers(pkg, small, batch_sizes, max_seq=16, **kw):
    serving = ref_serving if pkg == "ref" else port_serving
    if pkg == "ref":
        engines = [serving.ServeEngine(CFG_R, small[0], batch_size=b,
                                       max_seq=max_seq) for b in batch_sizes]
    else:
        engines = [serving.ServeEngine(CFG_P, small[1], batch_size=b,
                                       max_seq=max_seq, device="cpu")
                   for b in batch_sizes]
    return serving.RoutedServer(engines, **kw)


def test_serve_engine_generate_equals_reference(small):
    """Static-batch greedy generate: the same tokens as the reference's,
    and the last token the argmax of a full forward over the rest."""
    from repro_torch.models import forward

    prompts = np.random.default_rng(1).integers(0, 128, size=(2, 8),
                                                dtype=np.int32)
    ref = ref_serving.ServeEngine(CFG_R, small[0], batch_size=2,
                                  max_seq=32).generate(prompts, n_steps=4)
    port = port_serving.ServeEngine(CFG_P, small[1], batch_size=2,
                                    max_seq=32, device="cpu")
    got = port.generate(prompts, n_steps=4)
    assert got.tokens.shape == (2, 12) and got.steps == 4
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    full = forward(CFG_P, small[1], torch.as_tensor(got.tokens[:, :-1]))
    np.testing.assert_array_equal(
        got.tokens[:, -1], torch.argmax(full.logits[:, -1], -1).numpy())
    assert got.prefill_seconds > 0 and got.decode_seconds > 0


def test_routed_server_adapts_to_slow_replica_like_reference(small):
    """Replica 1 is 3x slower (injected times): both packages learn the
    same ~3:1 split round by round, with the same tokens."""
    prompts = np.random.default_rng(0).integers(0, 128, size=(8, 4),
                                                dtype=np.int32)
    speeds = np.array([3.0, 1.0])
    rounds = {}
    for pkg in ("ref", "port"):
        srv = _servers(pkg, small, [8, 8])
        log = []
        for _ in range(6):
            planned = srv.router.split(8)
            out, counts, times = srv.serve_batch(
                prompts, n_steps=2,
                times_override=np.maximum(planned, 1e-3) / speeds)
            log.append((counts.tolist(), times.tolist(), out))
        rounds[pkg] = (log, srv.runtime.ratios("serve_step"),
                       srv.router.split(8))
    (log_r, ratios_r, split_r), (log_p, ratios_p, split_p) = (
        rounds["ref"], rounds["port"])
    for (cr, tr, outr), (cp, tp, outp) in zip(log_r, log_p):
        assert cr == cp and tr == tp
        np.testing.assert_array_equal(outr, outp)
    np.testing.assert_array_equal(ratios_r, ratios_p)
    assert split_p.tolist() == split_r.tolist()
    assert split_p[0] >= 5 and split_p.sum() == 8


def test_routed_server_clamps_split_to_capacity_like_reference(small):
    prompts = np.random.default_rng(1).integers(0, 128, size=(8, 4),
                                                dtype=np.int32)
    outs = {}
    for pkg in ("ref", "port"):
        srv = _servers(pkg, small, [4, 4])
        srv.runtime.set("serve_step", np.array([7.0, 1.0]))
        out, counts, _ = srv.serve_batch(prompts, n_steps=2,
                                         times_override=np.array([1.0, 2.0]))
        outs[pkg] = (out, counts, srv.runtime.ratios("serve_step"))
        with pytest.raises(ValueError):  # beyond aggregate capacity
            srv.serve_batch(np.zeros((9, 4), dtype=np.int32), n_steps=1)
    np.testing.assert_array_equal(outs["ref"][0], outs["port"][0])
    assert outs["port"][1].tolist() == outs["ref"][1].tolist() == [4, 4]
    np.testing.assert_array_equal(outs["ref"][2], outs["port"][2])


def test_serve_batch_heterogeneous_capacities_with_overflow(small):
    srv = _servers("port", small, [2, 6])
    srv.runtime.set("serve_step", np.array([7.0, 1.0]))
    prompts = np.random.default_rng(1).integers(0, 128, size=(8, 4),
                                                dtype=np.int32)
    out, counts, _ = srv.serve_batch(prompts, n_steps=2)
    assert counts.tolist() == [2, 6]  # clamped + redistributed
    assert out.shape == (8, 6)


def test_zero_count_replica_masked_from_ema_and_telemetry(small):
    from repro_torch.runtime import ListSink

    sink = ListSink()
    srv = _servers("port", small, [4, 4], sink=sink)
    srv.runtime.set("serve_step", np.array([1e-6, 1.0]))
    prompts = np.random.default_rng(0).integers(0, 128, size=(4, 4),
                                                dtype=np.int32)
    before = srv.runtime.ratios("serve_step").copy()
    out, counts, times = srv.serve_batch(
        prompts, n_steps=2, times_override=np.array([123.0, 1.0]))
    assert counts[0] == 0 and counts[1] == 4
    assert out.shape == (4, 6)
    assert times[0] == 0.0
    assert srv.runtime.ratios("serve_step")[0] == pytest.approx(before[0])
    st = sink.records[-1]
    assert list(st.measured) == [False, True]
    assert st.makespan == pytest.approx(1.0)


def test_serve_batch_rejects_steps_beyond_max_seq(small):
    srv = _servers("port", small, [2], max_seq=8)
    with pytest.raises(ValueError, match="max_seq"):
        srv.serve_batch(np.zeros((2, 6), dtype=np.int32), n_steps=4)


def test_serve_batch_zero_steps_and_empty_batch(small):
    srv = _servers("port", small, [4])
    prompts = np.random.default_rng(3).integers(0, 128, size=(3, 4),
                                                dtype=np.int32)
    out, counts, times = srv.serve_batch(prompts, n_steps=0)
    np.testing.assert_array_equal(out, prompts)
    assert counts.sum() == 3 and times.sum() == 0.0
    out, counts, times = srv.serve_batch(np.zeros((0, 4), dtype=np.int32),
                                         n_steps=3)
    assert out.shape == (0, 7)
    assert counts.sum() == 0 and times.sum() == 0.0


def test_serve_batch_reuses_engines_across_rounds(small):
    srv = _servers("port", small, [4])
    prompts = np.random.default_rng(2).integers(0, 128, size=(3, 4),
                                                dtype=np.int32)
    for _ in range(3):
        out, counts, _ = srv.serve_batch(prompts, n_steps=2)
        assert out.shape == (3, 6)
        assert counts.sum() == 3
    assert srv._cb[0].finished == []
    assert srv._cb[0].manager.n_free == 4
    assert srv._cb[0].device.type == "cpu"


def test_tokens_per_second_uses_real_request_count():
    tokens = np.zeros((4, 10), dtype=np.int32)  # 2 real rows + 2 padding
    r = port_serving.GenerationResult(tokens=tokens, prefill_seconds=0.1,
                                      decode_seconds=1.0, steps=5,
                                      n_requests=2)
    assert r.tokens_per_second == pytest.approx(10.0)
    legacy = port_serving.GenerationResult(tokens=tokens, prefill_seconds=0.1,
                                           decode_seconds=1.0, steps=5)
    assert legacy.tokens_per_second == pytest.approx(20.0)


# --------------------------------------------------------- the serve CLI --
_TINY = ["--arch", "llama2-7b", "--device", "cpu", "--preset", "tiny",
         "--requests", "3", "--steps", "4", "--prompt-len", "6", "--batch",
         "2"]


def test_cli_legacy_batch(capsys):
    assert port_serve.main([*_TINY, "--legacy-batch", "--replicas", "2"]) == 0
    out = capsys.readouterr().out
    assert "[serve] legacy routed counts=[1, 1]" in out
    assert "[serve] generated shape=(2, 10)" in out


def test_cli_balanced_head(capsys):
    assert port_serve.main([*_TINY, "--balanced-head"]) == 0
    out = capsys.readouterr().out
    assert "finished 3/3 requests" in out
    assert "balanced-head kernel table (replica 0): membw spread=" in out


def test_cli_prefill_lanes(capsys):
    args = port_serve.build_parser().parse_args(
        [*_TINY, "--balanced-trunk", "--prefill-lanes", "3", "--rate", "0"])
    run = port_serve.serve(args)
    assert run.engines[0].prefill_lanes == 3
    # both slots' prompts (6 tokens, chunks of 4) prefill together
    assert max(s.prefill_tokens for s in run.iterations) == 8
    assert all(r.n_generated == 4 for r in run.requests)


@pytest.mark.parametrize("flags,message", [
    (["--balanced-head", "--balanced-trunk"],
     "--balanced-trunk already includes the head; drop --balanced-head"),
    (["--balanced-head", "--machine", "wall"],
     "--machine wall with --balanced-head is not ported yet"),
])
def test_cli_refuses_conflicting_modes(flags, message):
    with pytest.raises(SystemExit, match=message):
        port_serve.main([*_TINY, *flags])


# --------------------------------------- state at fixed addresses (CPU) --
def test_offset_snapshot_writes_in_place():
    """Every refresh rewrites the same tensors: fixed addresses, values
    that follow the plans, and a planner that raises mid-refresh leaves
    the host mirror and the device values as they were."""
    plans = {"a": np.array([2, 2, 4]), "b": np.array([1, 3, 0])}
    snap = OffsetSnapshot(lambda spec: plans[spec.name], device="cpu")
    snap.register(OffsetSpec("a", total=8))
    snap.register(OffsetSpec("b", total=4))
    first = snap.refresh()
    ptrs = {k: t.data_ptr() for k, t in first.items()}
    plans["a"], plans["b"] = np.array([0, 8, 0]), np.array([4, 0, 0])
    second = snap.refresh()
    assert second is first
    assert {k: t.data_ptr() for k, t in second.items()} == ptrs
    assert second["a"].tolist() == [0, 0, 8, 8]
    assert second["b"].tolist() == [0, 4, 4, 4]
    plans["a"] = np.array([1, 1, 6])
    plans["b"] = np.array([1, 1, 1])   # no longer covers its total
    with pytest.raises(ValueError):
        snap.refresh()
    assert second["a"].tolist() == [0, 0, 8, 8]      # device untouched
    assert snap.boundaries("a").tolist() == [0, 0, 8, 8]
    plans["b"] = np.array([1, 1, 1, 1])  # another worker count
    with pytest.raises(ValueError, match="workers"):
        snap.refresh()
    assert snap.boundaries("b").tolist() == [0, 4, 4, 4]


def test_compiled_tape_sizes_follow_the_refreshed_offsets(weights):
    """The cost tape's shard sizes are computed inside each step from the
    boundaries it reads, so a step after a refresh records the new plan
    (the sizes are no longer cached across refreshes)."""
    cfg_p, params_p = weights[1], weights[3]
    disp = PortDisp.virtual("ultra-125h")
    trunk = BalancedTrunk.from_params(cfg_p, params_p, disp, device="cpu")
    ctx = trunk._compiled()
    offs = ctx.refresh()
    x = torch.ones((2, cfg_p.d_model))
    name = ctx.spec_for(trunk.head, "membw", "head").name
    ptr = offs[name].data_ptr()
    sizes = []
    for _ in range(3):
        tape = ctx.tape_begin()
        ctx.apply(trunk.head, x, isa="membw", kind="head", offsets=offs)
        ctx.apply(trunk.head, x, isa="membw", kind="head", offsets=offs)
        recs = ctx.tape_end(tape)
        assert recs[0]["sizes"] is recs[1]["sizes"]   # once per step
        sizes.append(recs[0]["sizes"].tolist())
        np.testing.assert_array_equal(sizes[-1], ctx.snapshot.counts(name))
        offs = ctx.feedback(recs)
        assert offs[name].data_ptr() == ptr
    assert sizes[0] != sizes[-1]      # the plan moved and the tape saw it


@pytest.mark.parametrize("trunk", [("q4", "compiled"), None],
                         ids=["compiled-q4", "dense"])
def test_decode_state_stays_at_fixed_addresses(weights, trunk):
    """Decode steps leave the slot state's tensors in place (the captured
    step reads them at every replay) and advance its cache indices in
    place; on the CPU nothing is captured."""
    cfg_p, params_p = weights[1], weights[3]
    bt = None
    if trunk:
        bt = BalancedTrunk.from_params(cfg_p, params_p,
                                       PortDisp.virtual("ultra-125h"),
                                       device="cpu")
    engine = port_serving.ContinuousBatchingEngine(
        cfg_p, params_p, max_slots=2, max_seq=16, prefill_chunk=4,
        cost_model=port_serving.HybridPhaseCost("ultra-125h"),
        balanced_trunk=bt, device="cpu")
    assert engine.captured is False
    man = engine.manager
    tensors = [(c.k, c.v, c.idx) for c in man.state]
    for r in port_serving.poisson_requests(2, rate=0, vocab_size=cfg_p.vocab_size,
                                           prompt_len=4, max_new_tokens=6,
                                           seed=0):
        engine.submit(r)
    seen = []
    while engine.has_work:
        st = engine.step()
        if st.decode_tokens == 2 and not st.finished:
            seen.append(man.state[0].idx[:, 0].clone())
        assert [(c.k, c.v, c.idx) for c in man.state] == tensors
    assert len(seen) >= 3
    assert all(int((b - a).max()) == 1 and int((b - a).min()) == 1
               for a, b in zip(seen, seen[1:]))
    assert engine._graph is None


def test_step_graph_takes_only_cuda_inputs():
    with pytest.raises(ValueError, match="CUDA"):
        StepGraph(lambda x: x, [torch.zeros(2, dtype=torch.int32)])
