"""The port's NUMA topology package against the reference's, on the CPU.

``repro_torch.topology`` is a copy of ``repro.topology`` (the machine
model, the two-level dispatcher, the trunk placement) with the per-socket
outputs of its eager kernels concatenated by ``torch.cat``; the compiled
dispatcher's socket-local and oblivious branches and the engine's topology
adoption are ported beside it.  Both packages get the same inputs, made
from a numpy seed (weights from the reference's ``init_params``), and must
give the same numbers: the machine model, the socket and per-core ratio
tables and the bandwidth fractions are float64 numpy arithmetic in both,
so they are equal exactly.  Kernel outputs are held to the tolerances of
``tests/test_torch_trunks.py``: Q4 to the reference's kernel tolerance
(rtol 2e-5, atol 2e-5 * K), int8 accumulators exactly, fp32 within 1e-6
of the output's scale.

The serve runs use reduced llama2-7b with the reference's weights, three
seeded Poisson requests and two slots; the reference's ``serve`` is run
with its trunk in compiled mode (or eager, ``jit_bridge=False`` with its
Q4 blocks pinned) instead of its default io_callback bridge, which the
port does not carry.  The printed lines are compared whole, less the
port's " on <device>" suffix of the first line.
"""

import contextlib
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as ref_serve_mod
import repro.serving as ref_serving
import repro.topology as ref_topology
import repro_torch.serving as port_serving
import repro_torch.topology as port_topology
from repro.analysis import invariants as ref_invariants
from repro.configs import reduced_config as ref_reduced
from repro.core.hybrid_sim import make_machine as ref_make_machine
from repro.kernels.compiled import CompiledDispatcher as RefCompiled
from repro.models import BalancedTrunk as RefTrunk
from repro.models import init_params as ref_init_params
from repro.quant.int8 import quantize_s8_symmetric as ref_s8
from repro.quant.q4 import quantize_q4_0 as ref_q4
from repro.runtime import KernelSpec as RefSpec
from repro_torch.analysis import invariants as port_invariants
from repro_torch.configs import reduced_config
from repro_torch.core.hybrid_sim import make_machine as port_make_machine
from repro_torch.kernels.compiled import CompiledDispatcher as PortCompiled
from repro_torch.launch import serve as port_serve
from repro_torch.models import BalancedTrunk, params_from_numpy
from repro_torch.quant.int8 import quantize_s8_symmetric as port_s8
from repro_torch.quant.q4 import quantize_q4_0 as port_q4
from repro_torch.runtime import KernelSpec as PortSpec

PACKAGES = {"ref": (ref_topology, RefSpec), "port": (port_topology, PortSpec)}
TOPOLOGIES = ["dual-125h", "2s-12900k", "ultra-125h"]


def _close(got, want, tol):
    """Within ``tol`` of the output's scale."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _tables_equal(a, b):
    assert sorted(a.keys()) == sorted(b.keys())
    for key in a.keys():
        np.testing.assert_array_equal(a.ratios(key), b.ratios(key))


def _dispatchers_equal(ref, port):
    """Socket and per-core tables and every bandwidth fraction."""
    if ref.socket_local:
        _tables_equal(ref.table, port.table)
        for dr, dp in zip(ref.socket_dispatchers, port.socket_dispatchers,
                          strict=True):
            _tables_equal(dr.table, dp.table)
        for s in range(ref.n_sockets):
            assert (ref.achieved_bandwidth_fraction(socket=s)
                    == port.achieved_bandwidth_fraction(socket=s))
    else:
        _tables_equal(ref.flat.table, port.flat.table)
    for isa in ("membw", "avx_vnni"):
        assert (ref.achieved_bandwidth_fraction(isa)
                == port.achieved_bandwidth_fraction(isa))


@pytest.fixture(scope="module")
def model():
    cfg_r, cfg_p = ref_reduced("llama2-7b"), reduced_config("llama2-7b")
    params_r = ref_init_params(cfg_r, jax.random.key(0))
    params_p = params_from_numpy(jax.tree.map(np.asarray, params_r),
                                 device="cpu")
    return cfg_r, cfg_p, params_r, params_p


# ------------------------------------------------------ the machine model --
@pytest.mark.parametrize("name", TOPOLOGIES + ["core-12900k",
                                               "homogeneous-8"])
def test_make_topology_equal(name):
    ref, port = (PACKAGES[p][0].make_topology(name, seed=3)
                 for p in ("ref", "port"))
    assert (ref.name, ref.n_sockets, ref.n_cores) == \
        (port.name, port.n_sockets, port.n_cores)
    assert [tuple(vars(d).values()) for d in ref.domains()] == \
        [tuple(vars(d).values()) for d in port.domains()]
    assert [[c.name for c in s.cores] for s in ref.sockets] == \
        [[c.name for c in s.cores] for s in port.sockets]
    np.testing.assert_array_equal(ref.bandwidth_shares(),
                                  port.bandwidth_shares())
    assert ref.aggregate_bandwidth == port.aggregate_bandwidth
    assert ref.oblivious_blend == port.oblivious_blend
    assert ref.cross_socket_penalty == port.cross_socket_penalty
    assert [m.seed for m in ref.machines] == [m.seed for m in port.machines]
    fr, fp = ref.flattened(), port.flattened()
    assert (fr.n_cores, fr.socket_bandwidth) == (fp.n_cores,
                                                 fp.socket_bandwidth)
    for core in (0, ref.n_cores - 1):
        assert ref.socket_of(core) == port.socket_of(core)


def test_make_machine_resolves_topology_names():
    """``make_machine`` resolves flat names and topology names alike (the
    reference's lazy import), and names both registries when it fails."""
    for name in ("dual-125h", "2s-12900k"):
        ref, port = ref_make_machine(name, seed=2), port_make_machine(name,
                                                                      seed=2)
        assert type(port).__name__ == "MachineTopology"
        assert (ref.n_cores, ref.seed) == (port.n_cores, port.seed)
    errors = []
    for make in (ref_make_machine, port_make_machine):
        with pytest.raises(KeyError) as e:
            make("quad-9000")
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("n,shares,granularity", [
    (4096, [0.5, 0.5], 1), (11008, [0.3, 0.7], 8), (32000, [1.0], 16),
    (100, [0.2, 0.3, 0.5], 8), (7, [0.5, 0.5], 1), (0, [0.5, 0.5], 8)])
def test_place_rows_equal(n, shares, granularity):
    assert (ref_topology.place_rows(n, shares, granularity)
            == port_topology.place_rows(n, shares, granularity))


def test_capacity_events_equal():
    """Parking cores and sockets routes to the same socket machines and
    leaves the same masks and active bandwidth."""
    out = []
    for pkg in ("ref", "port"):
        topo = PACKAGES[pkg][0].make_topology("2s-12900k")
        topo.park_core(17, t_start=1.0)
        topo.park_socket(0, t_start=0.5, t_end=2.0)
        got = [topo.active_mask(t).tolist() for t in (0.0, 0.7, 1.5, 3.0)]
        got += [topo.active_bandwidth(t) for t in (0.0, 0.7, 1.5, 3.0)]
        topo.unpark_socket(0)
        topo.unpark_core(17)
        got.append(topo.active_mask(1.5).tolist())
        out.append(got)
    assert out[0] == out[1]


# -------------------------------------------------- the two-level dispatcher --
def _dispatch_sequence(pkg, name, local):
    """A fixed sequence of modelled regions: decode GEMVs of three kinds
    (one with a registered placement off the bandwidth split), a prefill
    GEMM, and, socket-local, a socket parked mid-sequence."""
    topology, Spec = PACKAGES[pkg]
    disp = topology.TopologyDispatcher(name, socket_local=local, seed=1)
    pinned = object()
    if local:
        n = disp.n_sockets
        cuts = [0] + [int(11008 * (i + 1) / (n + 1)) for i in range(n - 1)]
        disp.register_placement(pinned, [(lo, hi) for lo, hi in
                                         zip(cuts, cuts[1:] + [11008])])
    specs = [
        (Spec("q4_matmul", isa="membw", granularity=8, work_per_unit=2304.0,
              key="membw/attn_proj"), 4096, 2304.0, None),
        (Spec("q4_matmul", isa="membw", granularity=8, work_per_unit=2304.0,
              key="membw/mlp_up"), 11008, 2304.0, pinned),
        (Spec("int8_gemm", isa="avx_vnni", granularity=16,
              work_per_unit=2.0 * 4 * 4096, key="avx_vnni/mlp_up"),
         11008, 4096.0, None),
        (Spec("f32_matmul", isa="membw", granularity=1,
              work_per_unit=4.0 * 4096, key="membw/head"), 32000,
         4.0 * 4096, None),
    ]
    makespans = []
    for step in range(8):
        if local and step == 4 and disp.n_sockets > 1:
            disp.topology.park_socket(1)
        for spec, total, bpu, weight in specs:
            kw = {"weight": weight} if local else {}
            st = disp.dispatch(spec, total, bytes_per_unit=bpu, **kw)
            makespans.append(st.makespan)
    return disp, makespans


@pytest.mark.parametrize("local", [True, False],
                         ids=["socket-local", "oblivious"])
@pytest.mark.parametrize("name", TOPOLOGIES)
def test_topology_dispatch_sequence_equal(name, local):
    (ref, mr), (port, mp) = (_dispatch_sequence(p, name, local)
                             for p in ("ref", "port"))
    assert mr == mp
    _dispatchers_equal(ref, port)
    if local:
        for key in ref.table.keys():
            np.testing.assert_array_equal(ref.socket_ratios(key),
                                          port.socket_ratios(key))
        np.testing.assert_array_equal(ref.socket_mask(), port.socket_mask())
    assert len(ref.stats) == len(port.stats)


def test_socket_split_follows_the_placement():
    """A weight pinned two thirds to socket 1 pulls the learned split
    toward socket 1 (the fabric penalty), in both packages alike."""
    (ref, _), (port, _) = (_dispatch_sequence(p, "dual-125h", True)
                           for p in ("ref", "port"))
    split = port.socket_ratios("membw/mlp_up")
    np.testing.assert_array_equal(split, ref.socket_ratios("membw/mlp_up"))
    assert split[1] > split[0]


# ---------------------------------------------------------------- placement --
QUANTS = ["q4", "int8", "fp32"]


@pytest.mark.parametrize("name", ["dual-125h", "2s-12900k"])
@pytest.mark.parametrize("quant", QUANTS)
def test_place_trunk_equal(model, quant, name):
    """``place_trunk`` pins every banked projection and the head to the
    same ranges and prints the same lines; each range is registered under
    the object the layer hands to the kernel entry points."""
    cfg_r, cfg_p, params_r, params_p = model
    ref_trunk = RefTrunk.from_params(
        cfg_r, params_r, ref_topology.TopologyDispatcher(name),
        quant=quant, mode="compiled")
    port_trunk = BalancedTrunk.from_params(
        cfg_p, params_p, port_topology.TopologyDispatcher(name),
        quant=quant, device="cpu")
    ref = ref_topology.place_trunk(ref_trunk)
    port = port_topology.place_trunk(port_trunk)
    assert ref.entries == port.entries
    np.testing.assert_array_equal(ref.socket_bytes, port.socket_bytes)
    assert ref.lines() == port.lines()
    head = port_trunk.head
    handle = {"q4": lambda l: l.qw, "int8": lambda l: l.w.q,
              "fp32": lambda l: l.w}[quant](head)
    assert (port_trunk.dispatcher.placement_for(handle, head.out_features)
            == dict(port.entries)["head"])


def test_place_trunk_needs_a_socket_local_topology(model):
    cfg_p, params_p = model[1], model[3]
    from repro_torch.kernels.dispatch import HybridKernelDispatcher

    for disp in (HybridKernelDispatcher.virtual("ultra-125h"),
                 port_topology.TopologyDispatcher("dual-125h",
                                                  socket_local=False)):
        trunk = BalancedTrunk.from_params(cfg_p, params_p, disp,
                                          device="cpu")
        with pytest.raises(ValueError):
            port_topology.place_trunk(trunk)


# ------------------------------------------------------ eager kernels --
def _eager_inputs(seed):
    rng = np.random.default_rng(seed)
    k = 256
    x = rng.standard_normal((4, k)).astype(np.float32)
    w = rng.standard_normal((600, k)).astype(np.float32)
    return x, w, k


def _eager_run(pkg, name, kernel, x, w):
    topology = PACKAGES[pkg][0]
    disp = topology.TopologyDispatcher(name, execute=True)
    outs = []
    for _ in range(3):
        if pkg == "ref":
            if kernel == "q4":
                y = disp.q4_matmul(jnp.asarray(x), ref_q4(jnp.asarray(w)))
            elif kernel == "int8":
                a = jnp.asarray(np.clip(np.round(x * 40 + 128), 0, 255),
                                jnp.uint8)
                y = disp.int8_gemm(a, ref_s8(jnp.asarray(w)).q)
            else:
                y = disp.f32_matmul(x, w)
        else:
            if kernel == "q4":
                y = disp.q4_matmul(torch.from_numpy(x),
                                   port_q4(torch.from_numpy(w)))
            elif kernel == "int8":
                a = torch.from_numpy(np.clip(np.round(x * 40 + 128), 0, 255)
                                     .astype(np.uint8))
                y = disp.int8_gemm(a, port_s8(torch.from_numpy(w)).q)
            else:
                y = disp.f32_matmul(torch.from_numpy(x), torch.from_numpy(w))
        outs.append(np.asarray(y))
    return disp, outs


@pytest.mark.parametrize("kernel", QUANTS)
@pytest.mark.parametrize("name", ["dual-125h", "2s-12900k"])
def test_eager_topology_kernels_match_reference(name, kernel):
    """Eager sharded kernels through the socket split (outputs concatenated
    along N): Q4 within the reference's tolerance, int8 exact, fp32 within
    1e-6 of the scale; the same socket and per-core tables after three
    calls, since shard times come from the machine model alone."""
    x, w, k = _eager_inputs(seed=len(name))
    (ref, want), (port, got) = (_eager_run(p, name, kernel, x, w)
                                for p in ("ref", "port"))
    for g, r in zip(got, want):
        if kernel == "q4":
            np.testing.assert_allclose(g, r, rtol=2e-5, atol=2e-5 * k)
        elif kernel == "int8":
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, r)
        else:
            _close(g, r, 1e-6)
    _dispatchers_equal(ref, port)
    split = port.socket_ratios("membw" if kernel != "int8" else "avx_vnni")
    assert split.shape == (2,)


def test_eager_topology_shards_equal_one_call():
    """Within the port, the socket-then-core int8 shards give the bits of
    one unsharded call (exact integer sums), and the Q4 shards agree with
    one call within the kernel tolerance (on the CPU the plain version's
    float sums may follow the shard's width; on the card the kernels give
    the same bits, ``tests/test_torch_gpu.py``)."""
    from repro_torch.kernels import ops

    x, w, k = _eager_inputs(seed=9)
    disp = port_topology.TopologyDispatcher("dual-125h", execute=True)
    disp.table.set("membw", np.array([1.0, 3.0]))
    disp.table.set("avx_vnni", np.array([3.0, 1.0]))
    xt, qw = torch.from_numpy(x), port_q4(torch.from_numpy(w))
    torch.testing.assert_close(disp.q4_matmul(xt, qw),
                               ops.q4_matmul(xt, qw), rtol=2e-5,
                               atol=2e-5 * k)
    s8 = port_s8(torch.from_numpy(w))
    a = torch.from_numpy(np.clip(np.round(x * 40 + 128), 0, 255)
                         .astype(np.uint8))
    assert torch.equal(disp.int8_gemm(a, s8.q), ops.int8_gemm(a, s8.q))
    shards = [int((d.last_stats.counts > 0).sum())
              for d in disp.socket_dispatchers]
    assert min(shards) > 0 and sum(shards) > 16


# ------------------------------------------------ the compiled dispatcher --
def _compiled_rounds(pkg, name, local, w, x):
    topology = PACKAGES[pkg][0]
    disp = topology.TopologyDispatcher(name, socket_local=local)
    if pkg == "ref":
        from repro.models.layers import BalancedQuantLinear
        cd = RefCompiled(disp)
        layer = BalancedQuantLinear.from_dense(jnp.asarray(w), disp)
        xin = jnp.asarray(x)
    else:
        from repro_torch.models.layers import BalancedQuantLinear
        cd = PortCompiled(disp, device="cpu")
        layer = BalancedQuantLinear.from_dense(torch.from_numpy(w), disp)
        xin = torch.from_numpy(x)
    if local:
        topology.place_trunk(type("T", (), {"dispatcher": disp,
                                            "bank": {(0, "attn", "wq"):
                                                     [layer]},
                                            "head": None})())
    spec = cd.spec_for(layer, "membw", "attn_proj")
    offs = cd.refresh()
    counts = []
    for _ in range(5):
        tape = cd.tape_begin()
        cd.apply(layer, xin, isa="membw", kind="attn_proj", offsets=offs)
        recs = cd.tape_end(tape)
        offs = cd.feedback(recs)
        counts.append(cd.snapshot.counts(spec.name).copy())
    return disp, cd, counts


@pytest.mark.parametrize("local", [True, False],
                         ids=["socket-local", "oblivious"])
@pytest.mark.parametrize("name", TOPOLOGIES)
def test_compiled_feedback_over_topology_equal(name, local):
    """The compiled lowering over a topology dispatcher: the snapshot holds
    one count per core of the machine (socket plans concatenated, outer
    split first), and the two-level feedback replay leaves the same plans,
    socket and per-core tables and bandwidth fractions as the
    reference's."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((1000, 128)).astype(np.float32)
    x = rng.standard_normal((3, 128)).astype(np.float32)
    (ref, cr, counts_r), (port, cp, counts_p) = (
        _compiled_rounds(p, name, local, w, x) for p in ("ref", "port"))
    assert cp.n_workers == cr.n_workers == ref.topology.n_cores
    for a, b in zip(counts_r, counts_p):
        np.testing.assert_array_equal(a, b)
        assert len(b) == port.topology.n_cores and b.sum() == 1000
    _dispatchers_equal(ref, port)


def test_compiled_snapshot_keeps_its_tensors():
    """Under a topology the offset snapshot still rewrites each spec's
    boundary tensor in place (a captured step reads it at replay time)."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((1000, 128)).astype(np.float32)
    x = rng.standard_normal((3, 128)).astype(np.float32)
    disp, cd, _ = _compiled_rounds("port", "2s-12900k", True, w, x)
    snap = cd.snapshot.device()
    ptrs = {n: t.data_ptr() for n, t in snap.items()}
    disp.table.set("membw/attn_proj", np.array([4.0, 1.0]))
    again = cd.refresh()
    assert {n: t.data_ptr() for n, t in again.items()} == ptrs
    assert all(t.numel() == 33 for t in again.values())


# --------------------------------------------------- invariants self-test --
def test_invariants_self_test_passes():
    """The invariants pass, two-level bytes conservation included, finds
    nothing in either package."""
    assert port_invariants.run_pass() == []
    assert ref_invariants.run_pass() == []


def test_bytes_conservation_contract_checks_the_split():
    """With contracts on, a socket split whose inner accounting loses bytes
    trips IV005 in the port as in the reference."""
    for pkg, inv in (("ref", ref_invariants), ("port", port_invariants)):
        topology, Spec = PACKAGES[pkg]
        disp = topology.TopologyDispatcher("dual-125h")
        inner = disp.socket_dispatchers[1]
        account = inner._account
        inner._account = lambda isa, moved, busy: account(isa, moved / 2,
                                                          busy)
        with inv.contracts(True), pytest.raises(inv.ContractViolation):
            disp.dispatch(Spec("gemv", isa="membw"), 4096,
                          bytes_per_unit=2048.0)


# -------------------------------------------------------------- the engine --
def test_engine_adopts_the_topology_and_places_the_trunk(model):
    cfg_p, params_p = model[1], model[3]
    disp = port_topology.TopologyDispatcher("dual-125h")
    trunk = BalancedTrunk.from_params(cfg_p, params_p, disp, device="cpu")
    engine = port_serving.ContinuousBatchingEngine(
        cfg_p, params_p, max_slots=2, max_seq=16, balanced_trunk=trunk,
        topology="dual-125h", device="cpu")
    assert engine.topology is disp.topology
    assert engine.placement.n_layers == len(
        [l for ls in trunk.bank.values() for l in ls]) + 1
    oblivious = BalancedTrunk.from_params(
        cfg_p, params_p,
        port_topology.TopologyDispatcher("dual-125h", socket_local=False),
        device="cpu")
    engine = port_serving.ContinuousBatchingEngine(
        cfg_p, params_p, max_slots=2, max_seq=16, balanced_trunk=oblivious,
        device="cpu")
    assert engine.topology.name == "dual-125h" and engine.placement is None


@pytest.mark.parametrize("case", ["no-trunk", "flat-trunk", "other-name"])
def test_engine_topology_validation_matches_reference(model, case):
    """``topology=`` without a topology trunk, or naming another machine,
    raises the reference's ValueError."""
    cfg_r, cfg_p, params_r, params_p = model
    from repro.kernels.dispatch import HybridKernelDispatcher as RefDisp
    from repro_torch.kernels.dispatch import HybridKernelDispatcher as PDisp

    messages = []
    for pkg in ("ref", "port"):
        if pkg == "ref":
            cfg, params, serving, Trunk = cfg_r, params_r, ref_serving, RefTrunk
            flat, topo = RefDisp.virtual("ultra-125h"), ref_topology
            kw, tkw = {}, {"mode": "compiled"}
        else:
            cfg, params, serving, Trunk = (cfg_p, params_p, port_serving,
                                           BalancedTrunk)
            flat, topo = PDisp.virtual("ultra-125h"), port_topology
            kw, tkw = {"device": "cpu"}, {"device": "cpu"}
        trunk = {"no-trunk": None,
                 "flat-trunk": Trunk.from_params(cfg, params, flat, **tkw),
                 "other-name": Trunk.from_params(
                     cfg, params, topo.TopologyDispatcher("dual-125h"),
                     **tkw)}[case]
        with pytest.raises(ValueError) as e:
            serving.ContinuousBatchingEngine(
                cfg, params, max_slots=2, max_seq=16, balanced_trunk=trunk,
                topology="2s-12900k", **kw)
        messages.append(str(e.value).replace("repro_torch.", "repro."))
    assert messages[0] == messages[1]


# -------------------------------------------------------------- the serve --
# (topology, trunk quant, trunk mode): both dual topologies on every trunk
# compiled, eager on each trunk once, and a flat machine name (the
# 1-socket special case)
SERVE_CASES = [("dual-125h", "q4", "compiled"),
               ("dual-125h", "int8", "compiled"),
               ("dual-125h", "fp32", "compiled"),
               ("2s-12900k", "q4", "compiled"),
               ("2s-12900k", "int8", "compiled"),
               ("2s-12900k", "fp32", "compiled"),
               ("dual-125h", "q4", "eager"),
               ("2s-12900k", "int8", "eager"),
               ("dual-125h", "fp32", "eager"),
               ("ultra-125h", "q4", "compiled")]
SERVE_IDS = ["-".join(c) for c in SERVE_CASES]


def _serve_argv(topology, quant):
    return ["--arch", "llama2-7b", "--preset", "tiny", "--topology",
            topology, "--trunk-quant", quant, "--requests", "3", "--steps",
            "4", "--prompt-len", "6", "--batch", "2"]


def _ref_serve(monkeypatch, params_r, argv, mode):
    """The reference's ``serve`` main on ``argv`` with the shared weights and
    its trunk in ``mode``; returns (lines, requests, dispatchers)."""
    made, dispatchers = [], []

    class Trunk:
        @staticmethod
        def from_params(*a, **k):
            if mode == "compiled":
                k["mode"] = "compiled"
            else:
                k.update(jit_bridge=False, pin_q4_blocks=True)
            return RefTrunk.from_params(*a, **k)

    def requests(*a, **k):
        made.extend(ref_serving.poisson_requests(*a, **k))
        return made

    def topology_dispatcher(*a, **k):
        dispatchers.append(ref_topology.TopologyDispatcher(*a, **k))
        return dispatchers[-1]

    monkeypatch.setattr(ref_serve_mod, "BalancedTrunk", Trunk)
    monkeypatch.setattr(ref_serve_mod, "poisson_requests", requests)
    monkeypatch.setattr(ref_serve_mod, "TopologyDispatcher",
                        topology_dispatcher)
    monkeypatch.setattr(ref_serve_mod, "init_params",
                        lambda cfg, key: params_r)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert ref_serve_mod.main() == 0
    return out.getvalue().splitlines(), made, dispatchers


def _force_port_eager(monkeypatch):
    """Run the port's ``serve`` trunk as eager per-core kernel shards, the
    way :func:`_ref_serve` forces the reference's trunk mode."""
    class Trunk:
        @staticmethod
        def from_params(*a, **k):
            return BalancedTrunk.from_params(*a, **{**k, "mode": "eager"})

    def topology_dispatcher(*a, **k):
        return port_topology.TopologyDispatcher(*a, **{**k, "execute": True})

    monkeypatch.setattr(port_serve, "BalancedTrunk", Trunk)
    monkeypatch.setattr(port_serve, "TopologyDispatcher",
                        topology_dispatcher)


@pytest.fixture(scope="module")
def serve_runs(model):
    """(topology, quant, mode) -> (reference run, port run), each made on
    first use."""
    params_r, params_p = model[2], model[3]
    cache = {}

    def get(case):
        if case not in cache:
            topology, quant, mode = case
            argv = _serve_argv(topology, quant)
            with pytest.MonkeyPatch.context() as mp:
                ref = _ref_serve(mp, params_r, argv, mode)
            args = port_serve.build_parser().parse_args(
                argv + ["--device", "cpu"])
            with pytest.MonkeyPatch.context() as mp:
                if mode == "eager":
                    _force_port_eager(mp)
                run = port_serve.serve(args, params=params_p)
            lines = port_serve.report_lines(args, run)
            lines[0] = lines[0].replace(" on cpu", "")
            cache[case] = ref, (lines, run)
        return cache[case]

    return get


@pytest.mark.parametrize("case", SERVE_CASES, ids=SERVE_IDS)
def test_serve_topology_lines_equal(serve_runs, case):
    """Every printed line: the latency report, the replica and core ratio
    spreads, the topology, the placement, the socket split per trunk kind,
    the per-socket and aggregate bandwidth fractions, the sampled tokens."""
    (ref_lines, _, _), (port_lines, _) = serve_runs(case)
    assert f"[serve] topology {case[0]}: " in "\n".join(port_lines)
    assert port_lines == ref_lines


@pytest.mark.parametrize("case", SERVE_CASES, ids=SERVE_IDS)
def test_serve_topology_tokens_and_timelines_equal(serve_runs, case):
    (_, ref_reqs, _), (_, run) = serve_runs(case)
    assert [r.generated for r in ref_reqs] == \
        [r.generated for r in run.requests]
    for a, b in zip(ref_reqs, run.requests, strict=True):
        for field in ("arrival_time", "admit_time", "first_token_time",
                      "finish_time"):
            assert getattr(a, field) == getattr(b, field), field
    assert run.engines[0].topology.name == case[0]
    assert run.engines[0].balanced_trunk.mode == case[2]


@pytest.mark.parametrize("case", SERVE_CASES, ids=SERVE_IDS)
def test_serve_topology_socket_splits_and_tables_equal(serve_runs, case):
    """The socket split of every key, each socket's per-core tables and
    every bandwidth fraction of the trunk's dispatcher."""
    (_, _, ref_disps), (_, run) = serve_runs(case)
    _dispatchers_equal(ref_disps[0], run.dispatchers[0])
    assert len(ref_disps[0].table.keys()) >= 8


# ------------------------------------------------------------ the flags --
@pytest.mark.parametrize("argv", [
    ["--topology", "dual-125h", "--machine", "core-12900k"],
    ["--topology", "dual-125h", "--balanced-head"],
    ["--topology", "dual-125h", "--fleet"],
    ["--fleet", "--balanced-trunk"],
])
def test_serve_flag_rules_match_reference(monkeypatch, argv, model):
    """``--topology`` excludes ``--machine`` and ``--balanced-head``;
    ``--fleet`` is a standalone mode: the reference's messages."""
    monkeypatch.setattr(ref_serve_mod, "init_params",
                        lambda cfg, key: model[2])
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "llama2-7b"] + argv)
    with pytest.raises(SystemExit) as ref:
        ref_serve_mod.main()
    with pytest.raises(SystemExit) as port:
        port_serve.main(["--device", "cpu"] + argv)
    assert str(port.value) == str(ref.value)


def test_serve_topology_cli_on_cpu(capsys):
    rc = port_serve.main(["--device", "cpu", "--preset", "tiny",
                          "--topology", "2s-12900k", "--requests", "2",
                          "--steps", "3", "--prompt-len", "6"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[serve] topology 2s-12900k: 2 socket(s)" in out
    assert "[serve] socket split membw/mlp_up" in out
    assert "finished 2/2 requests" in out
