"""Serving the zoo: the port's continuous-batching engine on reduced
granite-8b (dense, GQA) and granite-moe-1b-a400m (MoE on every layer)
against the reference's, on the CPU, and ``serve``'s default ``--arch``.

The set-up of ``tests/test_torch_serving.py`` (the reference's weights
carried across, an ``ultra-125h`` virtual clock, two slots, prefill chunks
of 4, three seeded Poisson requests) for every trunk — Q4, int8 and fp32,
compiled and eager — and the dense model.  Greedy tokens, every request's
virtual-clock timeline, the latency report and every ratio table must be
equal exactly.  The MoE's routing is part of it: the port's experts
see the same tokens (its capacity set by the batched T, free slots'
rows routed too at decode) or the tokens part.
"""

import contextlib
import io
import sys

import jax
import numpy as np
import pytest

import repro.launch.serve as ref_serve_mod
import repro.serving as ref_serving
from repro.configs import reduced_config as ref_reduced
from repro.kernels.dispatch import HybridKernelDispatcher as RefDisp
from repro.models import BalancedTrunk as RefTrunk
from repro.models import init_params as ref_init_params
import repro_torch.serving as port_serving
from repro_torch.configs import reduced_config
from repro_torch.kernels.dispatch import HybridKernelDispatcher as PortDisp
from repro_torch.launch import serve as port_serve
from repro_torch.models import BalancedTrunk, params_from_numpy

ARCHS = ("granite-8b", "granite-moe-1b-a400m")
TRUNKS = [("q4", "compiled"), ("int8", "compiled"), ("fp32", "compiled"),
          ("q4", "eager"), ("int8", "eager"), ("fp32", "eager"), None]
TRUNK_IDS = ["compiled-q4", "compiled-int8", "compiled-fp32", "eager-q4",
             "eager-int8", "eager-fp32", "dense"]
CASES = [(a, t) for a in ARCHS for t in TRUNKS]
CASE_IDS = [f"{a}-{i}" for a in ARCHS for i in TRUNK_IDS]
TRUNK_CASES = [(a, t) for a, t in CASES if t is not None]
TRUNK_CASE_IDS = [i for (_, t), i in zip(CASES, CASE_IDS) if t is not None]


class _Weights(dict):
    """arch -> (reference cfg, port cfg, reference params, port params)."""

    def __missing__(self, arch):
        cfg_r, cfg_p = ref_reduced(arch), reduced_config(arch)
        params_r = ref_init_params(cfg_r, jax.random.key(0))
        params_p = params_from_numpy(jax.tree.map(np.asarray, params_r),
                                     device="cpu")
        self[arch] = cfg_r, cfg_p, params_r, params_p
        return self[arch]


def _serve(pkg, weights, trunk):
    """One serving run of three requests; ``trunk`` None serves the dense
    model (no balanced trunk)."""
    cfg_r, cfg_p, params_r, params_p = weights
    quant, mode = trunk if trunk else (None, "compiled")
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
    """(package, arch, trunk) -> serving run, each made on first use."""

    def __init__(self):
        super().__init__()
        self.weights = _Weights()

    def __missing__(self, key):
        pkg, arch, trunk = key
        self[key] = _serve(pkg, self.weights[arch], trunk)
        return self[key]

    def pair(self, arch, trunk):
        return self[("ref", arch, trunk)], self[("port", arch, trunk)]


@pytest.fixture(scope="module")
def runs():
    return _Runs()


@pytest.mark.parametrize("arch,trunk", CASES, ids=CASE_IDS)
def test_greedy_tokens_equal(runs, arch, trunk):
    ref, port = runs.pair(arch, trunk)
    assert [r.generated for r in ref[0]] == [r.generated for r in port[0]]
    assert all(r.n_generated == 4 for r in port[0])


@pytest.mark.parametrize("arch,trunk", CASES, ids=CASE_IDS)
def test_request_timelines_and_report_equal(runs, arch, trunk):
    ref, port = runs.pair(arch, trunk)
    for a, b in zip(ref[0], port[0], strict=True):
        for field in ("arrival_time", "admit_time", "first_token_time",
                      "finish_time", "request_id", "prefill_done"):
            assert getattr(a, field) == getattr(b, field), field
        assert a.finish_reason.value == b.finish_reason.value
    assert [(s.prefill_tokens, s.decode_tokens, s.now) for s in ref[4]] == \
        [(s.prefill_tokens, s.decode_tokens, s.now) for s in port[4]]
    assert ref[3].to_dict() == port[3].to_dict()
    assert ref[3].lines() == port[3].lines()


@pytest.mark.parametrize("arch,trunk", TRUNK_CASES, ids=TRUNK_CASE_IDS)
def test_every_ratio_table_key_equal(runs, arch, trunk):
    """The kernel dispatcher's per-(phase ISA x layer kind) tables (no
    MLP kinds for the MoE, whose experts are not banked) and the phase
    cost model's tables."""
    ref, port = runs.pair(arch, trunk)
    keys = set(port[1].table.keys())
    assert sorted(ref[1].table.keys()) == sorted(keys)
    assert {"membw/attn_proj", "membw/head"} <= keys
    assert ("membw/mlp_up" in keys) == (arch == "granite-8b")
    for key in keys:
        np.testing.assert_array_equal(ref[1].table.ratios(key),
                                      port[1].table.ratios(key))
    ct_r, ct_p = ref[2].cost_model.table, port[2].cost_model.table
    assert sorted(ct_r.keys()) == sorted(ct_p.keys())
    for key in ct_r.keys():
        np.testing.assert_array_equal(ct_r.ratios(key), ct_p.ratios(key))
    assert (ref[1].achieved_bandwidth_fraction()
            == port[1].achieved_bandwidth_fraction())


# ------------------------------------------------------- the serve CLI --
_ARGV = ["--preset", "tiny", "--balanced-trunk", "--requests", "3",
         "--steps", "4", "--prompt-len", "6", "--batch", "2"]


def _ref_serve_lines(monkeypatch, params_r, argv):
    """The reference's ``serve`` main on ``argv`` with ``params_r`` and its
    trunk compiled (the port's trunk mode); returns (lines, requests)."""
    made = []

    class Trunk:
        @staticmethod
        def from_params(*a, **k):
            return RefTrunk.from_params(*a, **{**k, "mode": "compiled"})

    def requests(*a, **k):
        made.extend(ref_serving.poisson_requests(*a, **k))
        return made

    monkeypatch.setattr(ref_serve_mod, "BalancedTrunk", Trunk)
    monkeypatch.setattr(ref_serve_mod, "poisson_requests", requests)
    monkeypatch.setattr(ref_serve_mod, "init_params",
                        lambda cfg, key: params_r)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert ref_serve_mod.main() == 0
    return out.getvalue().splitlines(), made


def test_serve_default_arch_is_the_references(monkeypatch, runs):
    """With no ``--arch`` both ``serve``s take granite-8b; on the same
    weights every printed line — the sampled tokens, the latency report,
    the trunk's spreads — and every request's timeline are equal."""
    assert port_serve.build_parser().parse_args([]).arch == "granite-8b"
    params_r, params_p = runs.weights["granite-8b"][2:]
    want, ref_reqs = _ref_serve_lines(monkeypatch, params_r, _ARGV)
    args = port_serve.build_parser().parse_args(_ARGV + ["--device", "cpu"])
    run = port_serve.serve(args, params=params_p)
    assert run.cfg.name == "granite-8b"
    lines = port_serve.report_lines(args, run)
    assert lines[0].endswith(" on cpu")
    lines[0] = lines[0].replace(" on cpu", "")
    assert lines == want
    assert [r.generated for r in ref_reqs] == \
        [r.generated for r in run.requests]
    for a, b in zip(ref_reqs, run.requests, strict=True):
        for field in ("arrival_time", "admit_time", "first_token_time",
                      "finish_time"):
            assert getattr(a, field) == getattr(b, field), field


def test_serve_refuses_embed_input_archs_as_the_reference(monkeypatch):
    argv = ["--arch", "musicgen-medium", "--preset", "tiny"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(SystemExit) as ref:
        ref_serve_mod.main()
    with pytest.raises(SystemExit) as port:
        port_serve.main(argv + ["--device", "cpu"])
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "chatglm3-6b",
                                  "starcoder2-15b", "olmo-1b",
                                  "internvl2-26b",
                                  "llama4-maverick-400b-a17b"])
def test_serve_cli_tiny_on_cpu_for_the_zoo(capsys, arch):
    """Every servable arch of the zoo through the port's own CLI (its own
    weights), compiled Q4 trunk."""
    rc = port_serve.main(["--arch", arch, "--device", "cpu", *_ARGV])
    out = capsys.readouterr().out
    assert rc == 0
    assert "finished 3/3 requests" in out
    assert "trunk membw/attn_proj spread" in out


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-1.3b"])
def test_serve_recurrent_archs_raise(arch):
    with pytest.raises(NotImplementedError, match="next slice"):
        port_serve.main(["--arch", arch, "--device", "cpu", *_ARGV])
