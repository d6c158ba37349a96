"""The port's kernel tuner front end and threaded dispatcher against the
reference, on the CPU at reduced sizes.

* ``TunedMatmul.q4`` / ``.int8`` against the reference's ``TunedMatmul``
  (Pallas in interpret mode) on the same numpy inputs, call after call
  while the tuners explore: Q4 within the reference's f32 tolerances
  (rtol 2e-5, atol 2e-5·K: the two sum in other orders), int8 bitwise
  (exact integer sums).  On the CPU every launch variant is the plain
  version, so the output cannot depend on the tuner's choice; that every
  variant gives the same bits on the card is ``test_torch_gpu.py``'s.
* The tuner's exploration and argmin over injected times, and the
  variant tables through ``TunerStore`` both ways between the packages
  (a reference cache's MXU block tuples sit in the port's tables unused:
  ``select`` ranks only the candidates it is given).
* ``HybridKernelDispatcher.threaded`` (2 and 4 workers, wall-clock shard
  times) against the virtual dispatcher: f32, int8 and Q4 outputs
  bitwise equal, one region per call, the tuner filled from the workers.
* ``serve --machine wall --balanced-trunk|--balanced-head --tuner-cache``
  run twice: the second run warm-starts, and each request's tokens equal
  the virtual clock's eager run's (arrivals at t = 0, so both clocks run
  the same schedule).
* ``from_params(pin_q4_blocks=True)`` skips the tuner.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tuner import KernelTuner as RefTuner
from repro.core.tuner import TunerStore as RefStore
from repro.kernels.ops import TunedMatmul as RefTuned
from repro.quant import int8 as RI8
from repro.quant import q4 as RQ4
from repro_torch.configs import reduced_config
from repro_torch.core.tuner import KernelTuner, TunerStore, shape_class
from repro_torch.kernels import HybridKernelDispatcher, ops
from repro_torch.launch import serve as port_serve
from repro_torch.models import BalancedTrunk, init_params
from repro_torch.quant.int8 import quantize_s8_symmetric, quantize_u8_dynamic
from repro_torch.quant.q4 import QuantizedLinear, quantize_q4_0

Q4_RTOL = 2e-5
Q4_ATOL_PER_K = 2e-5
CALLS = 6    # past both kernels' exploration (2 trials per candidate)


def _q4_pair(m, n, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((n, k)).astype(np.float32)
    ref_qw = RQ4.quantize_q4_0(jnp.asarray(w))
    qw = QuantizedLinear(torch.from_numpy(np.array(ref_qw.packed)),
                         torch.from_numpy(np.array(ref_qw.scales)))
    return x, ref_qw, qw


def _i8_pair(m, n, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((n, k)).astype(np.float32)
    ra, rw = RI8.quantize_u8_dynamic(jnp.asarray(x)), \
        RI8.quantize_s8_symmetric(jnp.asarray(w))
    # the port's quantizers give the reference's codes bit for bit
    # (tests/test_torch_int8.py)
    return ra, rw, quantize_u8_dynamic(torch.from_numpy(x)), \
        quantize_s8_symmetric(torch.from_numpy(w))


# ----------------------------------------------------------- TunedMatmul --
@pytest.mark.parametrize("m,n,k", [(1, 64, 256), (4, 96, 512)])
def test_tuned_q4_equals_the_references(m, n, k):
    x, ref_qw, qw = _q4_pair(m, n, k, seed=m + n)
    ref, port = RefTuned(interpret=True), ops.TunedMatmul()
    for _ in range(CALLS):
        want = np.asarray(ref.q4(jnp.asarray(x), ref_qw))
        got = port.q4(torch.from_numpy(x), qw).numpy()
        np.testing.assert_allclose(got, want, rtol=Q4_RTOL,
                                   atol=Q4_ATOL_PER_K * k)
    key = ("q4_matmul", shape_class(m, n, k))
    tab = port.tuner._tables[key]
    assert set(tab) == set(ops.Q4_CANDIDATES)
    assert all(e.count >= port.tuner.min_trials for e in tab.values())


@pytest.mark.parametrize("m,n,k", [(1, 48, 128), (8, 80, 256), (32, 64, 96)])
def test_tuned_int8_equals_the_references_bitwise(m, n, k):
    ra, rw, a, wq = _i8_pair(m, n, k, seed=3 * m + n)
    ref, port = RefTuned(interpret=True), ops.TunedMatmul()
    calls = 2 * len(ops.INT8_CANDIDATES) + 1
    for _ in range(calls):
        want = np.asarray(ref.int8(ra, rw))
        got = port.int8(a, wq).numpy()
        np.testing.assert_array_equal(got, want)
    tab = port.tuner._tables[("int8_gemm", shape_class(m, n, k))]
    assert set(tab) == set(ops.INT8_CANDIDATES)


def test_tuner_explores_then_takes_the_argmin(monkeypatch):
    """Injected times: every candidate is tried ``min_trials`` times
    first (the least-measured one next), then the EMA argmin is taken on
    every call."""
    times = {("direct",): 3e-6, ("ring",): 2e-6}
    picked = []

    def fake_time(fn, device):
        out = fn()
        return out, times[picked[-1]]

    tuned = ops.TunedMatmul(KernelTuner(min_trials=2))
    real_variant = ops.q4_variant

    def spy(x, qw, variant, **kw):
        picked.append(variant)
        return real_variant(x, qw, variant, **kw)

    monkeypatch.setattr(ops, "time_call", fake_time)
    monkeypatch.setattr(ops, "q4_variant", spy)
    x, _, qw = _q4_pair(2, 32, 64, seed=0)
    for _ in range(8):
        tuned.q4(torch.from_numpy(x), qw)
    assert sorted(picked[:4]) == sorted(ops.Q4_CANDIDATES * 2)
    assert picked[4:] == [("ring",)] * 4
    key = ("q4_matmul", shape_class(2, 32, 64))
    assert tuned.tuner.best(key) == ("ring",)
    # the environment drifts: ring slows down, the EMA moves to direct
    times[("ring",)] = 9e-6
    for _ in range(4):
        tuned.q4(torch.from_numpy(x), qw)
    assert picked[-1] == ("direct",)


def test_int8_variant_must_be_compiled():
    a = torch.zeros((2, 32), dtype=torch.uint8)
    w = torch.zeros((8, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="not one of"):
        ops.int8_gemm(a, w, variant=(3, 1, 6))
    with pytest.raises(ValueError, match="not one of"):
        ops.q4_variant(torch.zeros((1, 32)), quantize_q4_0(
            torch.zeros((8, 32))), ("bk", 256))


# ------------------------------------------------------------- the store --
def _mxu_tuner():
    """A reference tuner with MXU block tables, as its cache holds them."""
    t = RefTuner()
    key = ("q4_matmul", (8, 256, 4096))
    for cfg, s in (((8, 256, 512), 2e-3), ((8, 512, 1024), 1e-3)):
        for _ in range(2):
            t.report(key, cfg, s)
    return t, key


def test_tuner_store_both_ways(tmp_path):
    ref, key = _mxu_tuner()
    RefStore(str(tmp_path / "ref.json")).save(ref)
    port = KernelTuner()
    assert TunerStore(str(tmp_path / "ref.json")).load_into(port)
    # the MXU tuples sit unused: select ranks only the variants offered
    assert port.best(key) == (8, 512, 1024)
    for _ in range(2 * len(ops.Q4_CANDIDATES)):
        cfg = port.select(key, ops.Q4_CANDIDATES)
        assert cfg in ops.Q4_CANDIDATES
        port.report(key, cfg, 1e-4 if cfg == ("ring",) else 2e-4)
    assert port.select(key, ops.Q4_CANDIDATES) == ("ring",)
    # and back: the reference loads the port's file, variants and all
    TunerStore(str(tmp_path / "port.json")).save(port)
    back = RefTuner()
    assert RefStore(str(tmp_path / "port.json")).load_into(back)
    assert back.select(key, [(8, 256, 512), (8, 512, 1024)]) == \
        (8, 512, 1024)
    assert json.loads((tmp_path / "port.json").read_text())["tables"] == \
        json.loads(port.to_json())["tables"]


# ------------------------------------------------- the threaded dispatcher --
@pytest.mark.parametrize("workers", [2, 4])
@pytest.mark.parametrize("kernel", ["f32", "int8", "q4"])
def test_threaded_dispatch_equals_virtual(workers, kernel):
    rng = np.random.default_rng(workers)
    m, n, k = 3, 200, 128
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    virt = HybridKernelDispatcher.virtual("ultra-125h", execute=True)
    thr = HybridKernelDispatcher.threaded(workers)
    try:
        outs = []
        for d in (virt, thr):
            if kernel == "f32":
                outs.append(d.f32_matmul(x, w))
            elif kernel == "int8":
                outs.append(d.int8_gemm(quantize_u8_dynamic(x).q,
                                        quantize_s8_symmetric(w).q))
            else:
                outs.append(d.q4_matmul(x, quantize_q4_0(w)))
        # f32 shards may sum in another order than each other's BLAS call
        # (the plain monolithic product's), but Q4 and int8 are bitwise
        if kernel == "f32":
            torch.testing.assert_close(outs[1], outs[0], rtol=1e-6,
                                       atol=1e-5)
        else:
            assert torch.equal(outs[1], outs[0])
        st = thr.last_stats
        assert int(np.asarray(st.counts).sum()) == n
        assert (np.asarray(st.times) >= 0).all()
        if kernel != "f32":
            assert thr.tuner._tables   # the workers reported their shards
    finally:
        virt.close()
        thr.close()


def test_threaded_dispatch_learns_from_wall_times():
    """Shard times come from the wall clock: a worker slowed on purpose
    gets a smaller share once the EMA has seen it."""
    import time

    d = HybridKernelDispatcher.threaded(2)
    from repro_torch.runtime import KernelSpec

    def fn(start, size):
        if start == 0:   # worker 0's shard: slow
            time.sleep(2e-4 * size)

    try:
        spec = KernelSpec("gemv", isa="membw", granularity=1)
        for _ in range(4):
            d.dispatch(spec, 64, fn)
        assert d.table.ratios("membw")[0] < d.table.ratios("membw")[1]
        assert d.last_stats.counts[0] < 32
    finally:
        d.close()


# --------------------------------------------------------------- serving --
_TINY = ["--device", "cpu", "--preset", "tiny", "--requests", "3",
         "--steps", "4", "--prompt-len", "6", "--batch", "2", "--rate", "0"]


class _EagerTrunk:
    """``BalancedTrunk`` as ``serve`` builds it, in eager mode: the virtual
    clock's comparison run for the wall clock's eager trunk."""

    @staticmethod
    def from_params(*args, **kwargs):
        return BalancedTrunk.from_params(*args, **dict(kwargs, mode="eager"))


@pytest.mark.parametrize("mode", ["--balanced-trunk", "--balanced-head"])
def test_serve_wall_clock_with_a_tuner_cache(tmp_path, capsys, monkeypatch,
                                             mode):
    cache = str(tmp_path / "tuner.json")
    argv = [*_TINY, mode, "--machine", "wall", "--tuner-cache", cache]
    runs = []
    for i in range(2):
        assert port_serve.main(argv) == 0
        out = capsys.readouterr().out
        assert ("warm-started kernel tuner from" in out) == (i == 1), out
        assert f"saved kernel tuner tables to {cache}" in out
        assert "(wall clock)" in out
        doc = json.loads((tmp_path / "tuner.json").read_text())
        kernels = {rec["key"][0] for rec in doc["tables"]}
        assert kernels == {"q4_matmul"}, kernels
        runs.append(port_serve.serve(
            port_serve.build_parser().parse_args(argv)))
    monkeypatch.setattr(port_serve, "BalancedTrunk", _EagerTrunk)
    virt = port_serve.serve(
        port_serve.build_parser().parse_args([*_TINY, mode]))
    if mode == "--balanced-trunk":
        assert virt.engines[0].balanced_trunk.mode == "eager"
    want = {r.request_id: list(r.tokens) for r in virt.requests}
    for run in runs:
        assert run.clock == "wall"
        assert {r.request_id: list(r.tokens) for r in run.requests} == want
    assert isinstance(runs[0].dispatchers[0].tuner, KernelTuner)
    assert runs[0].dispatchers[0]._streams is not None   # threaded


def test_default_trunk_fills_no_tuner_table(tmp_path, capsys):
    """The compiled trunk consults no tuner: the cache is saved empty."""
    cache = str(tmp_path / "tuner.json")
    assert port_serve.main([*_TINY, "--balanced-trunk",
                            "--tuner-cache", cache]) == 0
    assert f"saved kernel tuner tables to {cache}" in capsys.readouterr().out
    assert json.loads((tmp_path / "tuner.json").read_text())["tables"] == []


@pytest.mark.parametrize("pin", [False, True])
def test_pin_q4_blocks_skips_the_tuner(pin):
    cfg = reduced_config("granite-8b")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    d = HybridKernelDispatcher.virtual("ultra-125h", execute=True)
    trunk = BalancedTrunk.from_params(cfg, params, d, mode="eager",
                                      pin_q4_blocks=pin, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, cfg.d_model)).astype(np.float32))
    y = trunk.apply_head(x, isa="membw")
    assert trunk.head.variant == (("ring",) if pin else None)
    assert bool(d.tuner._tables) != pin
    unpinned = BalancedTrunk.from_params(
        cfg, params, HybridKernelDispatcher.virtual("ultra-125h",
                                                    execute=True),
        mode="eager", device="cpu")
    assert torch.equal(y, unpinned.apply_head(x, isa="membw"))
