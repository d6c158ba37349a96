"""Serving the recurrent architectures: the port's continuous-batching engine
on reduced jamba-1.5-large-398b (mamba and attention mixers, dense and MoE
FFNs) and xlstm-1.3b (mLSTM and sLSTM blocks), one period of 8 layers
each, against the reference's, on the CPU; multi-lane prefill of a mixed
attention/mamba state; and ``serve --arch`` for both.

The set-up of ``tests/test_torch_zoo_serving.py`` (the reference's weights
carried across, an ``ultra-125h`` virtual clock, two slots, prefill chunks
of 4, three seeded Poisson requests) for every trunk — Q4, int8 and fp32,
compiled and eager — and the dense model.  Greedy tokens, every request's
virtual-clock timeline, the latency report and every ratio table must be
equal exactly.  The recurrent rows' state moves between the detached
prefill state, the lanes' stacked state and the decode slots as the
reference's does, and free slots keep stepping on their last token.
"""

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as ref_serving
from repro.configs import reduced_config as ref_reduced
from repro.configs.base import ModelConfig as RefModelConfig
from repro.configs.base import SSMConfig as RefSSMConfig
from repro.kernels.dispatch import HybridKernelDispatcher as RefDisp
from repro.models import BalancedTrunk as RefTrunk
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
import repro_torch.serving as port_serving
from repro_torch.configs import ModelConfig, SSMConfig, reduced_config
from repro_torch.kernels.dispatch import HybridKernelDispatcher as PortDisp
from repro_torch.launch import serve as port_serve
from repro_torch.models import BalancedTrunk, forward, params_from_numpy

ARCHS = ("jamba-1.5-large-398b", "xlstm-1.3b")
TRUNKS = [("q4", "compiled"), ("int8", "compiled"), ("fp32", "compiled"),
          ("q4", "eager"), ("int8", "eager"), ("fp32", "eager"), None]
TRUNK_IDS = ["compiled-q4", "compiled-int8", "compiled-fp32", "eager-q4",
             "eager-int8", "eager-fp32", "dense"]
CASES = [(a, t) for a in ARCHS for t in TRUNKS]
CASE_IDS = [f"{a}-{i}" for a in ARCHS for i in TRUNK_IDS]
TRUNK_CASES = [(a, t) for a, t in CASES if t is not None]
TRUNK_CASE_IDS = [i for (_, t), i in zip(CASES, CASE_IDS) if t is not None]
# the ratio-table kinds each arch's trunk banks: jamba's attention and
# dense FFN projections and the head; xlstm's head alone
KINDS = {"jamba-1.5-large-398b": {"attn_proj", "mlp_up", "mlp_down", "head"},
         "xlstm-1.3b": {"head"}}


class _Weights(dict):
    """arch -> (reference cfg, port cfg, reference params, port params), at
    one period of the reduced config (8 layers: every (mixer, ffn) pair of
    the arch once)."""

    def __missing__(self, arch):
        cfg_r, cfg_p = (dataclasses.replace(make(arch), n_layers=8)
                        for make in (ref_reduced, reduced_config))
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
    """The kernel dispatcher's per-(phase ISA x layer kind) tables — only
    the kinds the arch banks — and the phase cost model's tables."""
    ref, port = runs.pair(arch, trunk)
    keys = set(port[1].table.keys())
    assert sorted(ref[1].table.keys()) == sorted(keys)
    assert {k.split("/")[1] for k in keys} == KINDS[arch]
    for key in keys:
        np.testing.assert_array_equal(ref[1].table.ratios(key),
                                      port[1].table.ratios(key))
    ct_r, ct_p = ref[2].cost_model.table, port[2].cost_model.table
    assert sorted(ct_r.keys()) == sorted(ct_p.keys())
    for key in ct_r.keys():
        np.testing.assert_array_equal(ct_r.ratios(key), ct_p.ratios(key))
    assert (ref[1].achieved_bandwidth_fraction()
            == port[1].achieved_bandwidth_fraction())


# ------------------------------------------- lanes over a hybrid state --
# the reference's mixed attention/mamba model of
# tests/test_continuous_batching.py::test_prefill_lanes_hybrid_state_stacking
_HYBRID = dict(name="h", family="hybrid", n_layers=2, d_model=64, n_heads=4,
               n_kv_heads=2, d_ff=128, vocab_size=64, dtype="float32",
               mixer_pattern=("attn", "mamba"))


@pytest.fixture(scope="module")
def hybrid():
    cfg_r = RefModelConfig(**_HYBRID, ssm=RefSSMConfig())
    cfg_p = ModelConfig(**_HYBRID, ssm=SSMConfig())
    params_r = ref_init_params(cfg_r, jax.random.key(1))
    return cfg_r, cfg_p, params_r, params_from_numpy(
        jax.tree.map(np.asarray, params_r), device="cpu")


@pytest.mark.parametrize("lanes", [1, 2, 3])
def test_prefill_lanes_hybrid_state_stacking(hybrid, lanes):
    """Multi-lane prefill stacks and re-slices a *mixed* state (KV caches
    and mamba states) without corruption: every request's tokens equal the
    reference engine's, and its last token is the argmax of the whole
    sequence's forward in both packages."""
    cfg_r, cfg_p, params_r, params_p = hybrid
    out = {}
    for pkg, cfg, params, serving, kw in (
            ("ref", cfg_r, params_r, ref_serving, {}),
            ("port", cfg_p, params_p, port_serving, {"device": "cpu"})):
        eng = serving.ContinuousBatchingEngine(
            cfg, params, max_slots=3, max_seq=24, prefill_chunk=4,
            prefill_lanes=lanes, cost_model=serving.LinearPhaseCost(), **kw)
        rng = np.random.default_rng(5)
        reqs = [serving.Request(prompt=rng.integers(0, 64, size=n),
                                max_new_tokens=3) for n in (4, 7, 5)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle(max_steps=200)
        out[pkg] = reqs
    assert [r.generated for r in out["port"]] == \
        [r.generated for r in out["ref"]]
    for r in out["port"]:
        toks = r.tokens
        full = forward(cfg_p, params_p, torch.from_numpy(
            np.asarray(toks[None, :-1], np.int32)))
        assert toks[-1] == int(torch.argmax(full.logits[0, -1], -1))
        full_r = ref_forward(cfg_r, params_r, jnp.asarray(toks[None, :-1]))
        assert toks[-1] == int(np.asarray(jnp.argmax(full_r.logits[0, -1])))


# ------------------------------------------------------- the serve CLI --
_ARGV = ["--preset", "tiny", "--balanced-trunk", "--requests", "3",
         "--steps", "4", "--prompt-len", "6", "--batch", "2"]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_tiny_on_cpu(arch):
    """Both recurrent archs through the port's own CLI (its own weights),
    compiled Q4 trunk: every request finishes, and the trunk reports the
    head's spread (xlstm banks nothing else)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_serve.main(["--arch", arch, "--device", "cpu", *_ARGV])
    text = out.getvalue()
    assert rc == 0
    assert "finished 3/3 requests" in text
    assert "trunk membw/head spread" in text
    assert ("trunk membw/attn_proj spread" in text) == \
        arch.startswith("jamba")
