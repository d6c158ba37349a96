"""The port's data stream, checkpoints, pipeline planner and training
driver against the reference's, on the CPU.

``SyntheticLM`` is a numpy-only copy and must give the reference's batches
bit for bit.  Checkpoints keep the reference's layout and key spelling, so
a checkpoint of float32 and integer leaves crosses between the packages in
both directions.  ``python -m repro_torch.launch.train`` resumes bitwise:
four steps straight equal two steps and two resumed ones.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as ref_restore
from repro.checkpoint import save as ref_save
from repro.configs import get_config as ref_get_config
from repro.core.pipeline import choose_microbatches as ref_choose
from repro.core.pipeline import layer_costs_from_config as ref_layer_costs
from repro.core.pipeline import plan_stages as ref_plan_stages
from repro.data import DataConfig as RefDataConfig
from repro.data import Prefetcher as RefPrefetcher
from repro.data import SyntheticLM as RefSyntheticLM
from repro.training import init_opt_state as ref_init_opt_state
from repro_torch.checkpoint import all_steps, latest_step, restore, save
from repro_torch.configs import get_config
from repro_torch.core import (choose_microbatches, layer_costs_from_config,
                              plan_stages)
from repro_torch.data import DataConfig, Prefetcher, SyntheticLM
from repro_torch.launch import train as train_mod
from repro_torch.training import AdamWConfig, init_opt_state
from repro_torch.tree import leaves_with_path


# --------------------------------------------------------------- data --
@pytest.mark.parametrize("kw", [
    dict(vocab_size=128, seq_len=16, global_batch=8, microbatch=4),
    dict(vocab_size=50304, seq_len=33, global_batch=6, microbatch=3, seed=7),
    dict(vocab_size=97, seq_len=8, global_batch=8, microbatch=2, host_id=1,
         n_hosts=2),
    dict(vocab_size=64, seq_len=12, global_batch=4, microbatch=2,
         structured=False, seed=3),
], ids=["default", "olmo-vocab", "host-1-of-2", "uniform"])
def test_synthetic_stream_equals_reference(kw):
    """The port's stream, its seek and its host shard give the reference's
    batches bit for bit, through the Prefetcher too."""
    ours, ref = SyntheticLM(DataConfig(**kw)), RefSyntheticLM(
        RefDataConfig(**kw))
    ours.seek(5)
    ref.seek(5)
    a, b = Prefetcher(iter(ours), depth=2), RefPrefetcher(iter(ref), depth=2)
    try:
        for _ in range(3):
            x, y = next(a), next(b)
            assert x.keys() == y.keys() == {"tokens", "labels"}
            for k in x:
                assert x[k].dtype == y[k].dtype == np.int32
                np.testing.assert_array_equal(x[k], y[k])
    finally:
        a.close()
        b.close()


def test_synthetic_stream_rejects_uneven_splits():
    with pytest.raises(ValueError, match="hosts"):
        SyntheticLM(DataConfig(vocab_size=8, seq_len=4, global_batch=5,
                               microbatch=1, n_hosts=2))
    with pytest.raises(ValueError, match="microbatch"):
        SyntheticLM(DataConfig(vocab_size=8, seq_len=4, global_batch=6,
                               microbatch=4))


# -------------------------------------------------------- checkpoints --
def _tree():
    g = torch.Generator().manual_seed(0)
    params = {"embed": {"tok": torch.randn((6, 4), generator=g)},
              "period": [{"mixer": {"wq": torch.randn((2, 4, 4),
                                                      generator=g)},
                          "norm1": {}}],
              "final_norm": {"w": torch.randn((4,), generator=g)}}
    return {"params": params, "opt": init_opt_state(params)}


def test_checkpoint_round_trip_keeps_keys_and_dtypes(tmp_path):
    """save/restore returns every leaf bitwise in the template's dtype; a
    bfloat16 leaf is written as float32 (numpy has no bfloat16) and cast
    back exactly; keys are the reference's spelling."""
    tree = _tree()
    tree["params"]["embed"]["tok"] = tree["params"]["embed"]["tok"].to(
        torch.bfloat16)
    tree["opt"] = tree["opt"]._replace(step=torch.tensor(7, dtype=torch.int32))
    path = save(str(tmp_path), 7, tree, extra={"data_step": 9})
    assert os.path.basename(path) == "step_00000007"
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta["step"] == 7 and meta["extra"] == {"data_step": 9}
    assert meta["keys"] == sorted(k for k, _ in leaves_with_path(tree))
    assert "params/period/0/mixer/wq" in meta["keys"]
    assert "opt/mu/embed/tok" in meta["keys"] and "opt/step" in meta["keys"]
    with np.load(os.path.join(path, "arrays.npz")) as z:
        assert z["params/embed/tok"].dtype == np.float32
        assert z["opt/step"].dtype == np.int32
    got, meta2 = restore(str(tmp_path), 7, tree, device="cpu")
    assert meta2 == meta
    for (k, a), (_, b) in zip(leaves_with_path(got), leaves_with_path(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert type(got["opt"]).__name__ == "OptState"


def test_restore_rejects_a_shape_mismatch_and_cuda_without_a_card(tmp_path):
    tree = _tree()
    save(str(tmp_path), 1, tree)
    bad = _tree()
    bad["params"]["final_norm"]["w"] = torch.zeros((5,))
    with pytest.raises(ValueError, match="shape mismatch"):
        restore(str(tmp_path), 1, bad, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            restore(str(tmp_path), 1, tree)


def test_keep_last_and_atomic_tmp(tmp_path):
    """keep_last bounds the steps kept; a stale .tmp directory (a writer
    that died) is neither a step nor in the way of the next save."""
    d = str(tmp_path)
    tree = _tree()
    stale = os.path.join(d, "step_00000005.tmp")
    os.makedirs(stale)
    open(os.path.join(stale, "arrays.npz"), "w").write("torn")
    for s in (1, 2, 3, 4):
        save(d, s, tree, keep_last=2)
    assert all_steps(d) == [3, 4] and latest_step(d) == 4
    save(d, 5, tree, keep_last=2)
    assert not os.path.exists(stale)
    assert all_steps(d) == [4, 5]
    assert sorted(os.listdir(d)) == ["step_00000004", "step_00000005"]
    assert latest_step(str(tmp_path / "none")) is None


def _ref_tree():
    params = {"embed": {"tok": jnp.arange(24, dtype=jnp.float32)
                        .reshape(6, 4)},
              "period": [{"mixer": {"wq": jnp.ones((2, 4, 4)) * 0.5}}],
              "final_norm": {"w": jnp.full((4,), -1.25)}}
    return {"params": params, "opt": ref_init_opt_state(params)}


def test_port_checkpoint_restored_by_reference(tmp_path):
    """A checkpoint the port writes (float32 and int32 leaves) restores
    into the reference's tree of the same layout, leaf for leaf."""
    tree = _tree()
    save(str(tmp_path), 3, tree, extra={"data_step": 3})
    template = jax.eval_shape(lambda: jax.tree.map(
        lambda t: jnp.zeros(t.shape, jnp.float32 if t.is_floating_point()
                            else jnp.int32), tree))
    got, meta = ref_restore(str(tmp_path), 3, template)
    assert meta["extra"] == {"data_step": 3}
    want = {k: v for k, v in leaves_with_path(tree)}
    for path, leaf in jax.tree_util.tree_flatten_with_path(got)[0]:
        key = "/".join(str(p).strip("[].'") for p in path)
        np.testing.assert_array_equal(np.asarray(leaf), want[key].numpy())
    assert len(want) == len(jax.tree.leaves(got))


def test_reference_checkpoint_restored_by_port(tmp_path):
    """A checkpoint the reference writes restores into the port's tree of
    the same layout; its bfloat16 leaves (numpy's raw |V2) are read as
    bfloat16 bits into a bfloat16 template and refused elsewhere."""
    ref_tree = _ref_tree()
    ref_save(str(tmp_path), 2, ref_tree)
    template = {"params": {"embed": {"tok": torch.zeros((6, 4))},
                           "period": [{"mixer": {
                               "wq": torch.zeros((2, 4, 4))}}],
                           "final_norm": {"w": torch.zeros((4,))}}}
    template["opt"] = init_opt_state(template["params"])
    got, _ = restore(str(tmp_path), 2, template, device="cpu")
    want = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    assert len(want) == len(leaves_with_path(got))
    for (k, a), (_, b) in zip(leaves_with_path(got), want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)

    bf = {"w": jnp.asarray([1.5, -2.0, 3.140625], jnp.bfloat16)}
    ref_save(str(tmp_path / "bf"), 1, bf)
    got, _ = restore(str(tmp_path / "bf"), 1,
                     {"w": torch.zeros((3,), dtype=torch.bfloat16)},
                     device="cpu")
    assert got["w"].dtype == torch.bfloat16
    assert got["w"].tolist() == [1.5, -2.0, 3.140625]
    with pytest.raises(ValueError, match="bfloat16"):
        restore(str(tmp_path / "bf"), 1, {"w": torch.zeros((3,))},
                device="cpu")


# ----------------------------------------------------------- pipeline --
@pytest.mark.parametrize("costs,n_stages,ratios", [
    ([1.0] * 16, 4, None),
    ([1.0] * 12, 2, [2.0, 1.0]),
    ([1, 1, 1, 10, 1, 1], 2, None),
    ([0.5, 3.0, 1.0, 2.5, 0.1, 7.0, 1.5], 3, [1.0, 0.5, 2.0]),
    ([1.0], 1, None),
], ids=["uniform", "heterogeneous-pods", "one-huge-layer", "mixed", "single"])
def test_plan_stages_equals_reference(costs, n_stages, ratios):
    """The port's stage plans (boundaries, stage costs and times, bubble,
    microbatch choice) are the reference's on the cases of
    tests/test_pipeline.py."""
    ours = plan_stages(costs, n_stages, stage_ratios=ratios)
    ref = ref_plan_stages(costs, n_stages, stage_ratios=ratios)
    assert ours.boundaries == ref.boundaries
    assert ours.stage_costs == ref.stage_costs
    assert ours.stage_times == ref.stage_times
    assert ours.makespan_per_microbatch == ref.makespan_per_microbatch
    assert ours.bubble_fraction(32) == ref.bubble_fraction(32)
    assert choose_microbatches(ours, max_bubble=0.1) == ref_choose(
        ref, max_bubble=0.1)


def test_plan_stages_reads_a_ratio_table_and_validates():
    from repro_torch.runtime import RatioTable

    table = RatioTable(n_workers=2)
    table.update("pipeline_stage", np.array([1.0, 2.0]))
    plan = plan_stages([1.0] * 12, 2, table=table)
    assert plan.stage_ratios == tuple(float(r) for r in
                                      table.ratios("pipeline_stage"))
    with pytest.raises(ValueError):
        plan_stages([1.0] * 3, 4)
    with pytest.raises(ValueError):
        plan_stages([1.0] * 4, 2, stage_ratios=[1.0])


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "olmo-1b",
                                  "xlstm-1.3b", "llama4-maverick-400b-a17b"])
def test_layer_costs_equal_reference(arch):
    """The port's copy of the analytic per-layer costs, and the 8-stage
    plan over them, equal the reference's."""
    ours = layer_costs_from_config(get_config(arch))
    ref = ref_layer_costs(ref_get_config(arch))
    assert ours == ref
    n = min(8, len(ours))
    assert plan_stages(ours, n).boundaries == ref_plan_stages(ref,
                                                              n).boundaries


# ------------------------------------------------------ launch.train --
TRAIN_ARGV = ["--device", "cpu", "--preset", "tiny", "--global-batch", "4",
              "--microbatch", "2", "--seq-len", "16", "--log-every", "1",
              "--ckpt-every", "2"]


def _train(capsys, ckpt_dir, steps):
    assert train_mod.main(TRAIN_ARGV + ["--steps", str(steps),
                                        "--ckpt-dir", str(ckpt_dir)]) == 0
    return capsys.readouterr().out.splitlines()


def _loss_lines(lines):
    return [ln.split(" tok/s=")[0] for ln in lines
            if ln.startswith("[train] step ")]


def test_train_resume_is_bitwise(capsys, tmp_path):
    """Four steps straight equal two steps and two resumed ones: the same
    logged losses, lr and grad norms, and the same checkpoint bytes at
    steps 2 and 4; the resumed run warm-starts ratios.json and its stream
    resumes after the two consumed batches."""
    straight = _train(capsys, tmp_path / "a", 4)
    first = _train(capsys, tmp_path / "b", 2)
    resumed = _train(capsys, tmp_path / "b", 4)
    assert resumed[0] == "[train] resumed from step 2"
    assert resumed[1] == ("[train] warm-started performance ratios from "
                          f"{tmp_path / 'b' / 'ratios.json'}")
    assert not any("warm-started" in ln for ln in first)
    assert _loss_lines(straight) == _loss_lines(first) + _loss_lines(resumed)
    assert len(_loss_lines(straight)) == 4
    for step in (2, 4):
        name = f"step_{step:08d}"
        a = np.load(tmp_path / "a" / name / "arrays.npz")
        b = np.load(tmp_path / "b" / name / "arrays.npz")
        assert a.files and sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), (step, k)
        meta = json.load(open(tmp_path / "b" / name / "meta.json"))
        assert meta["extra"] == {"data_step": step}
    assert os.path.exists(tmp_path / "a" / "ratios.json")


def test_train_refuses_stub_frontend_archs_and_cuda_without_a_card():
    with pytest.raises(SystemExit, match="stub-frontend"):
        train_mod.main(["--device", "cpu", "--arch", "musicgen-medium",
                        "--steps", "1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_mod.main(["--steps", "1"])


class _Parsed(Exception):
    pass


def test_train_flags_are_the_references(monkeypatch):
    """Every flag of the reference's parser, with its default and choices,
    plus --device (default cuda)."""
    import argparse

    import repro.launch.train as ref_train

    def flags(parser):
        return {a.dest: (a.default, a.choices) for a in parser._actions
                if not isinstance(a, argparse._HelpAction)}

    ours = flags(train_mod.build_parser())
    seen = {}

    def grab(self, *args, **kwargs):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed):
        ref_train.main()
    assert ours.pop("device") == ("cuda", None)
    assert ours == flags(seen["parser"])
