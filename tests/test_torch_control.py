"""The port's control plane against the reference's.

The ratio tables, balancers, kernel dispatcher, offset snapshot and phase
cost model of ``repro_torch`` are copies (or, for the offsets, a torch
translation) of ``repro``'s.  Here both packages get the same inputs, made
from a numpy seed, and must give the same numbers exactly: the control
plane is float64 numpy arithmetic in both, in the same order.
"""

import numpy as np
import pytest
import torch

import repro.kernels.dispatch as ref_dispatch
import repro.runtime as ref_rt
import repro.serving as ref_serving
import repro_torch.kernels.dispatch as port_dispatch
import repro_torch.runtime as port_rt
import repro_torch.serving as port_serving
from repro.kernels.compiled import CompiledDispatcher as RefCompiled
from repro.models.layers import BalancedQuantLinear as RefBQL
from repro_torch.kernels.compiled import CompiledDispatcher as PortCompiled
from repro_torch.models.layers import BalancedQuantLinear as PortBQL

PACKAGES = {"ref": (ref_rt, ref_dispatch, ref_serving),
            "port": (port_rt, port_dispatch, port_serving)}


def _both(fn):
    """``fn(runtime, dispatch, serving)`` run once per package."""
    return [fn(*PACKAGES[name]) for name in ("ref", "port")]


# ------------------------------------------------------------ RatioTable --
@pytest.mark.parametrize("normalize", ["mean", "sum"])
def test_ratio_table_same_after_same_updates(normalize):
    rng = np.random.default_rng(0)
    steps = [("gemv", rng.uniform(0.5, 2.0, 6), None),
             ("gemm", rng.uniform(0.5, 2.0, 6), rng.integers(0, 9, 6)),
             ("gemv", rng.uniform(0.5, 2.0, 6), None),
             ("share", None, None)]
    share = rng.dirichlet(np.ones(6))

    def run(rt, _d, _s):
        t = rt.RatioTable(6, alpha=0.3, normalize=normalize)
        for key, times, units in steps:
            if times is None:
                t.observe(key, share)
            else:
                t.update(key, times, units=units)
        return t

    ref, port = _both(run)
    assert ref.keys() == port.keys()
    for key in ref.keys():
        np.testing.assert_array_equal(ref.ratios(key), port.ratios(key))
    assert ref.to_json() == port.to_json()


# --------------------------------------------------------------- Balancer --
@pytest.mark.parametrize("granularity", [1, 8])
def test_balancer_plans_equal(granularity):
    rng = np.random.default_rng(granularity)
    speeds = rng.uniform(0.4, 1.6, 8)

    def run(rt, _d, _s):
        table = rt.RatioTable(8, alpha=0.3)
        bal = rt.Balancer(rt.ProportionalPolicy(table, key="k",
                                                granularity=granularity))
        plans = []
        for total in (4096, 4096, 1000, 11008, 4096):
            plan = bal.plan(total)
            plans.append(np.asarray(plan.counts).copy())
            bal.report(plan, plan.counts / speeds)
        return plans, table.ratios("k")

    (ref_plans, ref_r), (port_plans, port_r) = _both(run)
    for a, b in zip(ref_plans, port_plans):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ref_r, port_r)


# ---------------------------------------------- HybridKernelDispatcher --
@pytest.mark.parametrize("machine", ["ultra-125h", "core-12900k"])
def test_virtual_dispatcher_replay_equal(machine):
    """``dispatch(plan=)``: the compiled path's replay of a split the
    device executed, then fresh plans — same ratios, same bandwidth."""
    rng = np.random.default_rng(3)

    def run(rt, d, _s):
        disp = d.HybridKernelDispatcher.virtual(machine)
        n = disp.n_workers
        spec = rt.KernelSpec("q4_matmul", isa=d.GEMV_ISA, granularity=8,
                             work_per_unit=4096 * 0.5625,
                             key=d.kernel_key(d.GEMV_ISA, "mlp_up"))
        counts = rng.multinomial(11008 // 8, np.ones(n) / n) * 8
        plan = rt.Plan(counts=counts, key=spec.table_key, granularity=8)
        disp.dispatch(spec, 11008, None, bytes_per_unit=2304.0, plan=plan)
        for _ in range(3):
            disp.dispatch(spec, 11008, None, bytes_per_unit=2304.0)
        return (disp.table.ratios(spec.table_key).copy(),
                disp.achieved_bandwidth_fraction(d.GEMV_ISA),
                np.asarray(disp.capacity_mask()).copy())

    rng_state = rng.bit_generator.state
    ref = run(*PACKAGES["ref"])
    rng.bit_generator.state = rng_state
    port = run(*PACKAGES["port"])
    np.testing.assert_array_equal(ref[0], port[0])
    assert ref[1] == port[1] and ref[1] > 0
    np.testing.assert_array_equal(ref[2], port[2])


def test_dispatcher_keys_and_constants_equal():
    for name in ("GEMM_ISA", "GEMV_ISA", "TRUNK_KINDS"):
        assert getattr(ref_dispatch, name) == getattr(port_dispatch, name)
    for isa in ("membw", "avx_vnni"):
        for kind in (None, "attn_proj", "head"):
            assert (ref_dispatch.kernel_key(isa, kind)
                    == port_dispatch.kernel_key(isa, kind))


def test_virtual_dispatcher_capacity_mask_after_park():
    def run(_rt, d, _s):
        disp = d.HybridKernelDispatcher.virtual("ultra-125h")
        disp.set_active(1, False)
        disp.machine.park(5)
        spec = _rt.KernelSpec("q4_matmul", isa=d.GEMV_ISA, granularity=8,
                              work_per_unit=1.0, key="k")
        st = disp.dispatch(spec, 4096, None)
        return np.asarray(disp.capacity_mask()), np.asarray(st.counts)

    (m_ref, c_ref), (m_port, c_port) = _both(run)
    np.testing.assert_array_equal(m_ref, m_port)
    np.testing.assert_array_equal(c_ref, c_port)
    assert c_port[1] == 0 and c_port[5] == 0


# -------------------------------------------------------- OffsetSnapshot --
def test_offset_snapshot_boundaries_equal_and_on_device():
    plans = {"a": np.array([3, 5, 0]), "b": np.array([4, 4, 4])}

    def run(rt, _d, _s, **kw):
        snap = rt.OffsetSnapshot(lambda spec: plans[spec.name], **kw)
        snap.register(rt.OffsetSpec("a", total=8))
        snap.register(rt.OffsetSpec("a", total=8))  # idempotent
        snap.register(rt.OffsetSpec("b", total=12))
        with pytest.raises(ValueError):
            snap.register(rt.OffsetSpec("a", total=9))
        return snap, snap.refresh()

    ref_snap, ref_dev = run(*PACKAGES["ref"])
    port_snap, port_dev = run(*PACKAGES["port"], device="cpu")
    assert sorted(ref_dev) == sorted(port_dev) == ["a", "b"]
    for name in ("a", "b"):
        t = port_dev[name]
        assert isinstance(t, torch.Tensor) and t.dtype == torch.int32
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(np.asarray(ref_dev[name]), t.numpy())
        np.testing.assert_array_equal(ref_snap.boundaries(name),
                                      port_snap.boundaries(name))
        np.testing.assert_array_equal(ref_snap.counts(name),
                                      port_snap.counts(name))


def test_offset_snapshot_commit_is_atomic():
    """A planner that fails part-way leaves both mirrors at the last
    complete snapshot."""
    plans = {"a": np.array([2, 2]), "b": np.array([1, 3])}
    snap = port_rt.OffsetSnapshot(lambda spec: plans[spec.name],
                                  device="cpu")
    snap.register(port_rt.OffsetSpec("a", total=4))
    snap.register(port_rt.OffsetSpec("b", total=4))
    before = snap.refresh()
    plans["a"] = np.array([4, 0])
    plans["b"] = np.array([1, 1])      # no longer covers its total
    with pytest.raises(ValueError):
        snap.refresh()
    np.testing.assert_array_equal(snap.boundaries("a"), [0, 2, 4])
    assert snap.device() is before


# --------------------------------------------- compiled feedback replay --
def test_compiled_feedback_replay_equal():
    """The compiled lowering's cost tape, replayed after the step, moves
    both packages' ratio tables and snapshots identically."""
    w = np.random.default_rng(0).standard_normal((64, 256)).astype(np.float32)
    x = np.random.default_rng(1).standard_normal((2, 256)).astype(np.float32)

    import jax.numpy as jnp

    def run(which):
        if which == "ref":
            disp = ref_dispatch.HybridKernelDispatcher.virtual("ultra-125h")
            cd = RefCompiled(disp)
            layer = RefBQL.from_dense(w, disp)
            xin = jnp.asarray(x)
        else:
            disp = port_dispatch.HybridKernelDispatcher.virtual("ultra-125h")
            cd = PortCompiled(disp, device="cpu")
            layer = PortBQL.from_dense(torch.from_numpy(w), disp)
            xin = torch.from_numpy(x)
        spec = cd.spec_for(layer, "membw", "attn_proj")
        offs = cd.refresh()
        counts = []
        for _ in range(4):
            tape = cd.tape_begin()
            cd.apply(layer, xin, isa="membw", kind="attn_proj", offsets=offs)
            recs = cd.tape_end(tape)
            offs = cd.feedback(recs)
            counts.append(cd.snapshot.counts(spec.name).copy())
        return counts, disp.table.ratios(spec.key).copy(), spec.name

    ref, port = run("ref"), run("port")
    assert ref[2] == port[2]
    for a, b in zip(ref[0], port[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ref[1], port[1])
    assert port[1].max() > 1.0


# --------------------------------------------------------- phase costs --
@pytest.mark.parametrize("machine", ["ultra-125h", "core-12900k"])
def test_hybrid_phase_cost_seconds_equal(machine):
    def run(_rt, _d, s):
        cost = s.HybridPhaseCost(machine, seed=1)
        secs = []
        for i in range(6):
            secs.append(cost.prefill_seconds(8, ctx=8 * (i + 1)))
            secs.append(cost.decode_seconds(1 + i % 4, ctx=64 + i))
        return (secs, cost.ratios(s.PREFILL).copy(),
                cost.ratios(s.DECODE).copy(),
                cost.achieved_bandwidth_fraction())

    ref, port = _both(run)
    assert ref[0] == port[0]
    np.testing.assert_array_equal(ref[1], port[1])
    np.testing.assert_array_equal(ref[2], port[2])
    assert ref[3] == port[3]
