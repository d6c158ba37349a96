"""The port's dry run and roofline against the reference's, on the CPU.

* ``models.abstract_params`` / ``abstract_state``: every leaf's path,
  shape and dtype equal to the reference's ``jax.eval_shape`` trees, for
  all 10 archs.
* ``launch.analytic``: exactly the reference's numbers on all 40 cells,
  on 256 and 512 devices, with and without remat.
* ``launch.dryrun.input_specs``: the reference's shapes and dtypes for
  every cell (the reference's module sets ``XLA_FLAGS`` when imported, so
  it runs in a subprocess).
* ``launch.roofline``: ``_wire_factor`` bit for bit, the terms on the H100
  constants, the link a group crosses, ``to_dict``'s keys; the
  recorder on a hand-reckoned case (one all-gather of a known sharded
  weight on a fake (4, 4) world, and DTensor's all-to-all on a mesh of
  device type "cuda"); the memory count on a chain whose peak is known by
  hand.
* A fake 16x16 world of 256 ranks: one period of granite-8b (kv heads
  that "model" does not divide) and xlstm-1.3b (4 heads, the gates'
  log-sigmoid) train steps at full width on a short sequence, and of
  olmo-1b's decode step on its sequence-sharded 32k cache, traces and
  reports the collectives it issued.

The subprocesses start together, once per module.
"""

import json
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
ARCHS = ("granite-moe-1b-a400m", "llama4-maverick-400b-a17b", "granite-8b",
         "chatglm3-6b", "starcoder2-15b", "olmo-1b", "xlstm-1.3b",
         "jamba-1.5-large-398b", "internvl2-26b", "musicgen-medium")
TIMEOUT = 600

REF_SPECS = textwrap.dedent("""
    import json, sys
    from repro.configs import ARCHS, SHAPES, get_config
    from repro.launch.dryrun import input_specs

    out = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES:
            for n_micro in (8, 2):
                specs = input_specs(cfg, SHAPES[shape], n_micro=n_micro)
                flat = {}
                for k, v in specs.items():
                    for kk, vv in (v.items() if isinstance(v, dict)
                                   else [(None, v)]):
                        flat[k if kk is None else f"{k}/{kk}"] = [
                            list(vv.shape), str(vv.dtype)]
                out[f"{arch}/{shape}/{n_micro}"] = flat
    json.dump(out, open(sys.argv[1], "w"))
""")

# one period of each repaired arch at full width on the fake 16x16 world
TRACE = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch.configs import SHAPES, ShapeSpec, get_config
    from repro_torch.launch.dryrun import (init_fake_world, production_mesh,
                                           trace_cell)

    init_fake_world(256)
    mesh = production_mesh()
    short = ShapeSpec("train_16x32", "train", 32, 16)
    cases = {"granite-8b/train": ("granite-8b", short, 1),
             "xlstm-1.3b/train": ("xlstm-1.3b", short, 1),
             "olmo-1b/decode_32k": ("olmo-1b", SHAPES["decode_32k"], 8)}
    out = {}
    for key, (arch, shape, n_micro) in cases.items():
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=len(full.period()))
        got = trace_cell(cfg, shape, mesh, arch=arch, n_micro=n_micro)
        rec = got["recorder"]
        out[key] = {"roofline": got["roofline"].to_dict(),
                    "issued": len(rec.records),
                    "groups": sorted({n for _, _, n, _, _, _ in rec.records}),
                    "seconds": got["trace_seconds"]}
    json.dump(out, open(sys.argv[1], "w"))
""")

# the recorder on a hand-reckoned case, on a fake (4, 4) world
RECORDER = textwrap.dedent("""
    import json, sys
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.dryrun import init_fake_world
    from repro_torch.launch.roofline import StepRecorder

    init_fake_world(16)
    mesh = init_device_mesh("cuda", (4, 4), mesh_dim_names=("data", "model"))
    out = {}
    for name, placements, target in (
            ("gather_model", [Replicate(), Shard(0)],
             [Replicate(), Replicate()]),
            ("gather_data", [Shard(0), Replicate()],
             [Replicate(), Replicate()]),
            ("all_to_all", [Replicate(), Shard(0)],
             [Replicate(), Shard(1)])):
        # a (64, 32) bf16 weight: 4,096 bytes whole, 1,024 a shard
        w = DTensor.from_local(torch.empty(16, 32, dtype=torch.bfloat16,
                                           device="meta"), mesh, placements,
                               run_check=False)
        rec = StepRecorder()
        with rec:
            w.redistribute(mesh, target)
        out[name] = {"ops": rec.stats.ops, "raw": rec.stats.raw_bytes,
                     "wire": rec.stats.wire_bytes,
                     "seconds": rec.stats.seconds,
                     "records": [r[:4] for r in rec.records]}
    json.dump(out, open(sys.argv[1], "w"))
""")


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module")
def runs():
    """The reference's ``input_specs``, the fake-16x16 traces and the
    recorder's hand-reckoned case, in three subprocesses started
    together; their results."""
    with tempfile.TemporaryDirectory() as tmp:
        popen = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                     text=True, env=_env(), cwd=tmp)
        procs = {name: subprocess.Popen(
            [sys.executable, "-c", script, f"{tmp}/{name}.json"], **popen)
            for name, script in (("specs", REF_SPECS), ("trace", TRACE),
                                 ("recorder", RECORDER))}
        out = {}
        for name, proc in procs.items():
            try:
                _, err = proc.communicate(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                _, err = proc.communicate()
            assert proc.returncode == 0, f"{name} failed:\n{err[-4000:]}"
            with open(f"{tmp}/{name}.json") as f:
                out[name] = json.load(f)
        yield out


# ------------------------------------------------------ abstract trees ---
def _ref_leaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(p).strip("[].'") for p in path):
            (tuple(leaf.shape), str(leaf.dtype)) for path, leaf in flat}


def _port_leaves(tree) -> dict:
    from repro_torch.tree import leaves_with_path

    return {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in leaves_with_path(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_equal_the_references(arch):
    """Every leaf's path, shape and dtype, parameters and a (2, 64)
    state; the port's leaves are on the meta device."""
    import repro.configs as ref_configs
    import repro.models as ref_models

    from repro_torch.configs import get_config
    from repro_torch.models import abstract_params, abstract_state
    from repro_torch.tree import leaves

    cfg = get_config(arch)
    params = abstract_params(cfg)
    state = abstract_state(cfg, 2, 64)
    assert all(t.device.type == "meta" for t in leaves(params)
               + leaves(state))
    ref_cfg = ref_configs.get_config(arch)
    assert _port_leaves(params) == _ref_leaves(
        ref_models.abstract_params(ref_cfg))
    assert _port_leaves(state) == _ref_leaves(
        ref_models.abstract_state(ref_cfg, 2, 64))


def test_resolve_device_takes_meta():
    from repro_torch.device import resolve_device

    assert resolve_device("meta").type == "meta"
    with pytest.raises(ValueError):
        resolve_device("mps")


# ------------------------------------------------------------ analytic ---
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_equals_the_references(arch):
    """``analyze_cell`` on each of the arch's 4 shapes (skipped ones too)
    on 256 and 512 devices, with and without remat, and the per-token,
    state and parameter counts: exactly the reference's."""
    import repro.configs as ref_configs
    from repro.launch import analytic as ref

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import analytic as port

    cfg, ref_cfg = get_config(arch), ref_configs.get_config(arch)
    for name, shape in SHAPES.items():
        ref_shape = ref_configs.SHAPES[name]
        for n in (256, 512):
            for remat in (True, False):
                a = port.analyze_cell(cfg, shape, n, remat=remat)
                b = ref.analyze_cell(ref_cfg, ref_shape, n, remat=remat)
                assert (a.flops, a.hbm_bytes) == (b.flops, b.hbm_bytes), \
                    (name, n, remat)
        assert port.state_bytes_per_seq(cfg, shape.seq) == \
            ref.state_bytes_per_seq(ref_cfg, shape.seq)
        assert port.forward_flops(cfg, shape.batch * shape.seq,
                                  shape.seq / 2, shape.batch) == \
            ref.forward_flops(ref_cfg, shape.batch * shape.seq,
                              shape.seq / 2, shape.batch)
    assert port.param_bytes(cfg) == ref.param_bytes(ref_cfg)
    assert port.active_param_bytes(cfg) == ref.active_param_bytes(ref_cfg)


def test_model_flops_equal_the_references():
    import repro.configs as ref_configs
    from repro.launch import roofline as ref

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import roofline as port

    for arch in ARCHS:
        for name, shape in SHAPES.items():
            for n in (256, 512):
                assert port.model_flops_per_device(
                    get_config(arch), shape, n) == ref.model_flops_per_device(
                    ref_configs.get_config(arch), ref_configs.SHAPES[name], n)


# --------------------------------------------------------- input specs ---
def test_input_specs_equal_the_references(runs):
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import input_specs

    want = runs["specs"]
    assert len(want) == len(ARCHS) * len(SHAPES) * 2
    for key, flat in want.items():
        arch, shape, n_micro = key.split("/")
        specs = input_specs(get_config(arch), SHAPES[shape],
                            n_micro=int(n_micro))
        got = {}
        for k, v in specs.items():
            for kk, vv in (v.items() if isinstance(v, dict) else [(None, v)]):
                assert vv.device.type == "meta"
                got[k if kk is None else f"{k}/{kk}"] = [
                    list(vv.shape), str(vv.dtype).replace("torch.", "")]
        assert got == flat, key


# ------------------------------------------------------------ roofline ---
def test_wire_factors_equal_the_references():
    from repro.launch import roofline as ref

    from repro_torch.launch import roofline as R

    assert R._wire_factor("all-reduce", 4) == pytest.approx(1.5)
    assert R._wire_factor("all-gather", 4) == pytest.approx(0.75)
    assert R._wire_factor("collective-permute", 2) == 1.0
    assert R._wire_factor("all-reduce", 1) == 0.0
    for kind in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                 "collective-permute", "broadcast"):
        for n in range(0, 33):
            assert R._wire_factor(kind, n) == ref._wire_factor(kind, n)


def test_roofline_terms_on_the_h100():
    from repro_torch.launch import roofline as R

    assert (R.PEAK_FLOPS, R.HBM_BW) == (989.4e12, 3.35e12)
    assert (R.NVLINK_BW, R.INTER_NODE_BW) == (450e9, 50e9)
    r = R.Roofline(arch="a", shape="s", mesh="16x16",
                   flops=989.4e12, hbm_bytes=3.35e12 / 2,
                   wire_bytes=50e9 * 2, per_device_output_bytes=0,
                   model_flops=494.7e12)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(0.5)
    # no per-link time: every wire byte at the slowest link
    assert r.t_collective == pytest.approx(2.0)
    assert r.bottleneck == "collective"
    assert r.t_bound == pytest.approx(2.0)
    assert r.roofline_fraction == pytest.approx(0.5)
    assert r.useful_flops_fraction == pytest.approx(0.5)
    r.collective_seconds = 0.25
    assert r.bottleneck == "compute" and r.roofline_fraction == 1.0


def test_to_dict_keeps_the_references_keys():
    """The reference's keys, less the two that corrected XLA's CPU
    backend (``wire_bytes_tpu``, ``t_collective_tpu``)."""
    from repro.launch import roofline as ref

    from repro_torch.launch import roofline as R

    kw = dict(arch="a", shape="s", mesh="m", flops=1.0, hbm_bytes=1.0,
              wire_bytes=1.0, per_device_output_bytes=0.0, model_flops=1.0)
    want = set(ref.Roofline(**kw).to_dict()) - {"wire_bytes_tpu",
                                                "t_collective_tpu"}
    assert set(R.Roofline(**kw).to_dict()) == want


def test_link_of_a_group():
    """Inside one node of 8 consecutive ranks NVLink, else the inter-node
    port; on the 16x16 mesh (row-major ranks) rank 0's "model" group spans
    2 nodes and its "data" group 16."""
    from repro_torch.launch import roofline as R

    assert R.link_bandwidth(range(8)) == R.NVLINK_BW
    assert R.link_bandwidth([8, 9, 15]) == R.NVLINK_BW
    assert R.link_bandwidth(range(4, 12)) == R.INTER_NODE_BW
    grid = np.arange(256).reshape(16, 16)
    model, data = grid[0], grid[:, 0]
    assert len({r // 8 for r in model}) == 2
    assert len({r // 8 for r in data}) == 16
    assert R.link_bandwidth(model) == R.INTER_NODE_BW
    assert R.link_bandwidth(data) == R.INTER_NODE_BW


def test_recorder_on_a_hand_reckoned_all_gather(runs):
    """A (64, 32) bf16 weight (4,096 bytes) sharded 4 ways, made whole: one
    all-gather whose output is the whole weight, 4,096 × 3/4 bytes on the
    wire.  Over "model" (ranks 0-3, one node) at NVLink's rate; over
    "data" (ranks 0, 4, 8, 12: two nodes) at the inter-node rate."""
    from repro_torch.launch import roofline as R

    got = runs["recorder"]
    for name, bw in (("gather_model", R.NVLINK_BW),
                     ("gather_data", R.INTER_NODE_BW)):
        r = got[name]
        assert r["ops"] == {"all-gather": 1}
        assert r["raw"] == {"all-gather": 4096}
        assert r["wire"] == 4096 * 3 / 4
        assert r["seconds"] == pytest.approx(4096 * 3 / 4 / bw)
        assert r["records"] == [[3072.0, "all-gather", 4, 4096]]


def test_recorder_sees_the_cards_all_to_all(runs):
    """On a mesh of device type "cuda" DTensor moves a shard from one dim to
    another by an all-to-all (over a "cpu" mesh it would gather and chunk):
    the recorder counts one all-to-all of the local 1,024 bytes."""
    r = runs["recorder"]["all_to_all"]
    assert r["ops"] == {"all-to-all": 1}
    assert r["raw"] == {"all-to-all": 1024}
    assert r["wire"] == 1024 * 3 / 4


def test_memory_count_on_a_known_chain():
    """a (4,000 bytes) held; x = a * 2, y = x + 1, x dropped, z = y * 3 and
    v a view of z: live 4,000 -> 8,000 -> 12,000 -> 8,000 -> 12,000, so
    the peak is 12,000 bytes; a view adds none, and what is dropped after
    the trace is freed."""
    from repro_torch.launch.roofline import StepRecorder

    a = torch.empty(1000, device="meta")
    rec = StepRecorder()
    rec.hold([a])
    assert rec.live == 4000
    with rec:
        x = a * 2
        y = x + 1
        del x
        z = y * 3
        v = z.view(10, 100)
    assert rec.peak == 12000 and rec.live == 12000
    assert rec.op_bytes == 3 * 8000
    del y, z, v
    assert rec.live == 4000


# ------------------------------------------------- the fake 16x16 world --
@pytest.mark.parametrize("case", ["granite-8b/train", "xlstm-1.3b/train",
                                  "olmo-1b/decode_32k"])
def test_repaired_arch_traces_on_the_production_mesh(runs, case):
    """One period at full width on the fake 16x16 world of 256 ranks:
    granite-8b (8 kv heads against "model" = 16) and xlstm-1.3b (4 heads,
    the mLSTM and sLSTM gates) train, olmo-1b decodes on its
    sequence-sharded 32k cache.  Each traces, and reports the collectives
    it issued: every one of the reference's kinds, over groups of the
    mesh's axes (16 ranks)."""
    got = runs["trace"][case]
    roof = got["roofline"]
    print(f"{case}: {got['issued']} collectives {roof['collective_ops']}, "
          f"wire {roof['wire_bytes']:.4g} B, t_collective "
          f"{roof['t_collective']:.4g} s, peak {roof['peak_mem_bytes']:.4g} "
          f"B, traced in {got['seconds']:.1f} s")
    assert got["issued"] > 0
    assert sum(roof["collective_ops"].values()) == got["issued"]
    assert set(roof["collective_ops"]) <= {"all-gather", "all-reduce",
                                           "reduce-scatter", "all-to-all"}
    assert got["groups"] == [16]
    assert roof["mesh"] == "16x16"
    assert roof["wire_bytes"] > 0 and roof["t_collective"] > 0
    assert roof["peak_mem_bytes"] > 0 and roof["hlo_flops_raw"] > 0
    if case.endswith("train"):
        # FSDP: weights gathered over "data", gradients reduce-scattered
        assert roof["collective_ops"]["all-gather"] > 0
        assert roof["collective_ops"]["reduce-scatter"] > 0
