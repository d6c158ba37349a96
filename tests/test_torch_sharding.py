"""The port's sharding layer against the reference's, on the CPU.

* Placements as data: ``repro.sharding``'s PartitionSpecs, computed in a
  subprocess on 8 forced host devices over meshes built with Auto axes,
  equal the port's specs entry for entry, on mesh layouts of the same
  names and sizes (no process group).
* Multi-rank: 4 gloo processes (a file rendezvous under the test's
  temporary directory, no port) hold three meshes, (2, 2), (4, 1) and
  (1, 4), and run the sharded train step, both MoE mesh branches, a
  checkpoint saved from one mesh and restored onto the other,
  ``constrain``, and the three places where the plain operation raises
  on DTensors (head reshapes over a model axis that does not divide the
  heads, the mLSTM/sLSTM log-sigmoid's backward, the decode cache write
  on a sequence-sharded cache); the reference runs the same train steps, MoE
  layers and decode on its Auto meshes of the same shapes in the same
  subprocess as the placements, from the same numpy inputs.  All of it
  starts together, once per module, with the 2-rank ``launch.train``
  run.

Tolerances:

* The sharded train step (reduced granite-8b, 2 microbatches,
  ``grad_shardings``) against the port's plain step and the reference's
  sharded step: loss and grad norm 1e-5 relative; parameters parting by a
  learning rate or more (an Adam sign flip parts them by 2·lr) on at most
  1e-5 of the elements.  The sharded step adds partial products and
  gradients across ranks in another order, so it is not bitwise.
* The MoE branches: ``y`` and the gradients 1e-5 of their scale,
  ``lb_loss`` 1e-5, ``load`` exact.  ``dropped`` is the per-shard share,
  computed here from each shard's expert counts; the reference's reading,
  which compares the summed counts with one shard's capacity, is asserted
  beside it.
* The restore onto another mesh, bitwise.  The 2-rank launch, 1e-5 of
  the 1-rank run's losses.
* The repairs on (1, 4): reduced granite-moe-1b-a400m's train step (2 kv
  heads against a model axis of 4) as the sharded train step above;
  reduced xlstm-1.3b cut to one period (seven mLSTM blocks and an sLSTM,
  4 heads) likewise, except its grad norm, held at 2e-3 relative, and
  the parameters parting by lr or more, on at most 1e-4 of the elements:
  random mLSTM blocks amplify a rounding difference block by block, and
  the reference's own sharded step parts from its plain one by 7e-4 in
  grad norm there (``tests/test_torch_training.py`` holds xlstm's
  gradients at the same 2e-3, 100 times the dense archs' 2e-5, so 100
  times as many near-zero gradients may take the other sign and move
  their parameter 2·lr the other way under Adam's first step; measured
  5 of 332,024 against the plain step).  Reduced granite-8b's prefill of 8 tokens and 3 decode steps on
  (2, 2) and (1, 4), serve-mode parameters, the caches laid out by
  ``state_shardings(phase="decode")`` (the sequence over "model"):
  logits 1e-5 of their scale; the gathered caches within 1e-5 of their
  scale of the plain run's and the reference's (the sharded projections
  sum in another order, so not bitwise), with every position past the
  written ones still zero.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")

MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "8x1": ((8, 1), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
ARCHS = ("granite-moe-1b-a400m", "llama4-maverick-400b-a17b", "granite-8b",
         "chatglm3-6b", "starcoder2-15b", "olmo-1b", "xlstm-1.3b",
         "jamba-1.5-large-398b", "internvl2-26b", "musicgen-medium")
STATE_ARCHS = ("granite-8b", "jamba-1.5-large-398b", "xlstm-1.3b")
BATCHES = {0: {"tokens": (8, 16), "embeds": (6, 16, 64), "mask": (3, 16)},
           1: {"tokens": (2, 8, 16), "labels": (2, 8, 16),
               "embeds": (2, 6, 16, 64)}}

TRAIN_ARCH = "granite-8b"
MOE_ARCH = "granite-moe-1b-a400m"
# the repairs: (key, arch, layers) of the train steps on (1, 4)
REPAIR_STEPS = (("moe14", MOE_ARCH, None), ("xlstm14", "xlstm-1.3b", 8))
XLSTM_GRAD_TOL = 2e-3
XLSTM_PARTED_SHARE = 1e-4
DEC_B, DEC_S, DEC_PROMPT, DEC_STEPS = 4, 16, 8, 3
DEC_MESHES = {"2x2": ((2, 2), ("data", "model")),
              "1x4": ((1, 4), ("data", "model"))}
MOE_X = (4, 16, 64)
MOE_MESHES = {"2x2": ((2, 2), ("data", "model")),
              "4x1": ((4, 1), ("data", "model"))}
MOE_RUNS = {"local": "4x1", "ep": "2x2"}   # branch -> mesh that takes it
CAPS = {"default": None, "12": 12}
LR = 1e-3
STEP_TOL = 1e-5
PARTED_SHARE = 1e-5
MOE_TOL = 1e-5
LAUNCH_ARGV = ["--device", "cpu", "--steps", "3", "--global-batch", "4",
               "--microbatch", "2", "--seq-len", "16", "--log-every", "1"]
TIMEOUT = 600


def _spec_json(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


# ------------------------------------------------------------ reference --
REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import math
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import AxisType

    import dataclasses
    from repro.configs import reduced_config
    from repro.models import (abstract_params, abstract_state, forward,
                              init_state, moe as M)
    from repro.sharding import (activation_sharding, batch_shardings,
                                opt_shardings, param_shardings,
                                state_shardings)
    from repro.training import AdamWConfig, init_opt_state, make_train_step

    inp, out_dir = sys.argv[1], sys.argv[2]
    cfgj = json.loads(sys.argv[3])
    data = np.load(inp)

    def mesh(shape, names):
        n = math.prod(shape)
        return jax.make_mesh(tuple(shape), tuple(names),
                             axis_types=(AxisType.Auto,) * len(shape),
                             devices=jax.devices()[:n])

    def path_str(path):
        return "/".join(str(p).strip("[].'") for p in path)

    def specs(tree):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        return {path_str(p): [list(e) if isinstance(e, tuple) else e
                              for e in s.spec] for p, s in flat}

    out = {"params": {}, "state": {}, "batch": {}, "opt": {}}
    for name, (shape, names) in cfgj["meshes"].items():
        m = mesh(shape, names)
        for arch in cfgj["archs"]:
            ap = abstract_params(reduced_config(arch))
            for mode in ("train", "serve"):
                out["params"][f"{name}/{arch}/{mode}"] = specs(
                    param_shardings(m, ap, mode=mode))
        for arch in cfgj["state_archs"]:
            c = reduced_config(arch)
            for b in (4, 1):
                st = abstract_state(c, b, 32)
                for phase in ("decode", "prefill"):
                    out["state"][f"{name}/{arch}/{b}/{phase}"] = specs(
                        state_shardings(m, st, b, phase=phase))
        for bd, leaves in cfgj["batches"].items():
            ab = {k: jax.ShapeDtypeStruct(tuple(v), jnp.int32)
                  for k, v in leaves.items()}
            out["batch"][f"{name}/{bd}"] = specs(
                batch_shardings(m, ab, batch_dim=int(bd)))
        for arch in ("granite-8b", "jamba-1.5-large-398b"):
            ap = abstract_params(reduced_config(arch))
            ps = param_shardings(m, ap)
            for fac in (False, True):
                ao = jax.eval_shape(lambda: init_opt_state(
                    ap, AdamWConfig(factored=fac)))
                out["opt"][f"{name}/{arch}/{fac}"] = specs(
                    opt_shardings(m, ao, ps))
    with open(os.path.join(out_dir, "ref_specs.json"), "w") as f:
        json.dump(out, f)

    res = {}
    # the sharded train step on the (2, 2) mesh
    cfg = reduced_config(cfgj["train_arch"])
    m22 = mesh((2, 2), ("data", "model"))
    ap = abstract_params(cfg)
    params = jax.tree_util.tree_map_with_path(
        lambda p, l: jnp.asarray(data["train/" + path_str(p)]), ap)
    opt_cfg = AdamWConfig(lr=cfgj["lr"], warmup_steps=1, total_steps=10)
    opt = init_opt_state(params, opt_cfg)
    batch = {"tokens": jnp.asarray(data["train_batch/tokens"]),
             "labels": jnp.asarray(data["train_batch/labels"])}
    ps = param_shardings(m22, ap)
    step = make_train_step(cfg, opt_cfg, remat=True, grad_shardings=ps)
    with m22, activation_sharding(m22):
        b_sh = batch_shardings(m22, jax.eval_shape(lambda: batch),
                               batch_dim=1)
        p2, _, m2 = jax.jit(step, in_shardings=(ps, None, b_sh))(
            params, opt, batch)
    res["train/loss"] = np.asarray(m2["loss"])
    res["train/grad_norm"] = np.asarray(m2["grad_norm"])
    for p, leaf in jax.tree_util.tree_flatten_with_path(p2)[0]:
        res["train/new/" + path_str(p)] = np.asarray(leaf)

    # the MoE layer under each mesh and capacity
    mcfg = reduced_config(cfgj["moe_arch"])
    mp = {k: jnp.asarray(data["moe/" + k]) for k in ("router", "wi", "wg",
                                                     "wo")}
    x = jnp.asarray(data["moe/x"])
    ct = jnp.asarray(data["moe/ct"])
    for branch, name in cfgj["moe_runs"].items():
        shape, names = cfgj["moe_meshes"][name]
        mm = mesh(shape, names)
        for cap_name, cap in cfgj["caps"].items():
            def f(x, p):
                y, aux = M.moe_fwd(mcfg, p, x, cap)
                return jnp.sum(y * ct), (y, aux)
            with mm, activation_sharding(mm):
                (_, (y, aux)), (gx, gp) = jax.jit(
                    jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
                        x, mp)
            key = f"moe/{branch}/{cap_name}/"
            res[key + "y"] = np.asarray(y)
            for a in ("lb_loss", "load", "dropped"):
                res[key + a] = np.asarray(aux[a])
            res[key + "grad/x"] = np.asarray(gx)
            for k, g in gp.items():
                res[key + "grad/" + k] = np.asarray(g)

    # the repairs: train steps on the (1, 4) mesh
    m14 = mesh((1, 4), ("data", "model"))
    for key, arch, n_layers in cfgj["repair_steps"]:
        rcfg = reduced_config(arch)
        if n_layers:
            rcfg = dataclasses.replace(rcfg, n_layers=n_layers)
        rap = abstract_params(rcfg)
        rparams = jax.tree_util.tree_map_with_path(
            lambda p, l: jnp.asarray(data[key + "/" + path_str(p)]), rap)
        rps = param_shardings(m14, rap)
        rstep = make_train_step(rcfg, opt_cfg, remat=True, grad_shardings=rps)
        with m14, activation_sharding(m14):
            b_sh = batch_shardings(m14, jax.eval_shape(lambda: batch),
                                   batch_dim=1)
            rp2, _, rm = jax.jit(rstep, in_shardings=(rps, None, b_sh))(
                rparams, init_opt_state(rparams, opt_cfg), batch)
        res[key + "/loss"] = np.asarray(rm["loss"])
        res[key + "/grad_norm"] = np.asarray(rm["grad_norm"])
        for p, leaf in jax.tree_util.tree_flatten_with_path(rp2)[0]:
            res[key + "/new/" + path_str(p)] = np.asarray(leaf)

    # the repairs: prefill and decode on a sequence-sharded cache
    db, ds = cfgj["dec_b"], cfgj["dec_s"]
    for name, (shape, names) in cfgj["dec_meshes"].items():
        dm = mesh(shape, names)
        ps_s = param_shardings(dm, ap, mode="serve")
        ss = state_shardings(dm, abstract_state(cfg, db, ds), db,
                             phase="decode")

        def dec(p, t, s, off):
            out = forward(cfg, p, t, state=s, pos_offset=off,
                          logits_mode="last")
            return out.logits, out.state

        st = init_state(cfg, db, ds)
        with dm, activation_sharding(dm):
            f = jax.jit(dec, in_shardings=(ps_s, None, ss, None))
            lo, st = f(params, jnp.asarray(data["dec/prompt"]), st, 0)
            res[f"dec/{name}/logits/0"] = np.asarray(lo)
            for i, t in enumerate(data["dec/next"]):
                lo, st = f(params, jnp.asarray(t), st,
                           cfgj["dec_prompt"] + i)
                res[f"dec/{name}/logits/{i + 1}"] = np.asarray(lo)
        for j, c in enumerate(st):
            res[f"dec/{name}/k/{j}"] = np.asarray(c.k)
            res[f"dec/{name}/v/{j}"] = np.asarray(c.v)
    np.savez(os.path.join(out_dir, "ref.npz"), **res)
""")


# ---------------------------------------------------------------- port ---
def _worker(rank: int, world: int, tmp: str) -> None:
    """One gloo rank: every multi-rank case, results written by rank 0."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.checkpoint import restore, save
    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import forward, init_params, init_state
    from repro_torch.models import moe as M
    from repro_torch.sharding import (activation_sharding, batch_shardings,
                                      constrain, distribute, opt_shardings,
                                      param_shardings, state_shardings)
    from repro_torch.sharding.specs import Sharding
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)
    from repro_torch.tree import leaves_with_path, map_with_path

    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world)
    meshes = {"2x2": make_debug_mesh(2, 2, device="cpu"),
              "4x1": make_debug_mesh(4, 1, device="cpu"),
              "1x4": make_debug_mesh(1, 4, device="cpu")}
    data = np.load(f"{tmp}/inputs.npz")
    res = {}

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    # constrain: a no-op outside the context and on plain tensors
    m22 = meshes["2x2"]
    x = torch.ones(4, 8)
    xd = distribute({"x": x}, {"x": Sharding(m22, (None, None))})["x"]
    ok = constrain(xd, ("dp", None)) is xd
    with activation_sharding(m22):
        ok = ok and constrain(x, ("dp", None)) is x
        moved = constrain(xd, ("dp", None))
    res["constrain"] = bool(ok and moved.placements == (Shard(0),
                                                        Replicate()))

    # the sharded train step on the (2, 2) mesh
    cfg = reduced_config(TRAIN_ARCH)
    template = init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    params = map_with_path(
        lambda p, _: torch.from_numpy(data["train/" + p]), template)
    opt_cfg = AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)
    opt = init_opt_state(params, opt_cfg)
    batch = {k: torch.from_numpy(data["train_batch/" + k])
             for k in ("tokens", "labels")}
    ps = param_shardings(m22, params)
    dparams = distribute(params, ps)
    dopt = distribute(opt, opt_shardings(m22, opt, ps))
    dbatch = distribute(batch, batch_shardings(m22, batch, batch_dim=1))
    step = make_train_step(cfg, opt_cfg, remat=True, grad_shardings=ps)
    with activation_sharding(m22):
        new_p, new_opt, metrics = step(dparams, dopt, dbatch)
    res["train/loss"] = float(metrics["loss"])
    res["train/grad_norm"] = float(metrics["grad_norm"])
    # the same on reduced granite-moe: its MoE layers take the ep branch,
    # inside the remat recompute too
    mcfg = reduced_config(MOE_ARCH)
    mparams = init_params(mcfg, torch.Generator().manual_seed(2),
                          device="cpu")
    mopt = init_opt_state(mparams, opt_cfg)
    mps = param_shardings(m22, mparams)
    with activation_sharding(m22):
        mnew, _, mm = make_train_step(
            mcfg, opt_cfg, remat=True, grad_shardings=mps)(
                distribute(mparams, mps),
                distribute(mopt, opt_shardings(m22, mopt, mps)), dbatch)
    res["moe_train/loss"] = float(mm["loss"])
    res["moe_train/grad_norm"] = float(mm["grad_norm"])
    for p, leaf in leaves_with_path(mnew):
        res["moe_train/new/" + p] = full(leaf)
    res["train/placements"] = all(
        tuple(leaf.placements) == s.placements for (_, leaf), (_, s) in
        zip(leaves_with_path(new_p), leaves_with_path(ps)))
    for p, leaf in leaves_with_path(new_p):
        res["train/new/" + p] = full(leaf)

    # a checkpoint of the (2, 2) run restored onto (4, 1), and plain
    tree = {"params": new_p, "opt": new_opt}
    save(f"{tmp}/ckpt", 1, tree)
    m41 = meshes["4x1"]
    ps41 = param_shardings(m41, params)
    sh41 = {"params": ps41, "opt": opt_shardings(m41, opt, ps41)}
    onto, _ = restore(f"{tmp}/ckpt", 1, tree, device="cpu", shardings=sh41)
    plain, _ = restore(f"{tmp}/ckpt", 1, tree, device="cpu")
    same, laid = True, True
    for (_, a), (_, b), (_, c), (_, s) in zip(
            leaves_with_path(tree), leaves_with_path(onto),
            leaves_with_path(plain), leaves_with_path(sh41)):
        fa, fb = full(a), full(b)
        same = same and fa.dtype == fb.dtype and torch.equal(fa, fb) \
            and torch.equal(fb, c)
        laid = laid and b.device_mesh is m41 and \
            tuple(b.placements) == s.placements
    res["restore/bitwise"] = bool(same)
    res["restore/placements"] = bool(laid)

    # the MoE layer: each branch on its mesh, at each capacity
    mcfg = reduced_config(MOE_ARCH)
    mp = {k: torch.from_numpy(data["moe/" + k])
          for k in ("router", "wi", "wg", "wo")}
    x = torch.from_numpy(data["moe/x"])
    ct = torch.from_numpy(data["moe/ct"])
    for branch, name in MOE_RUNS.items():
        mesh = meshes[name]
        # the layer's weights laid out as the stacked parameter's, less
        # its period axis
        sh = param_shardings(mesh, {"period": [{"ffn": {
            k: v[None] for k, v in mp.items()}}]})["period"][0]["ffn"]
        for cap_name, cap in CAPS.items():
            dp = {k: distribute({"w": v}, {"w": Sharding(
                mesh, sh[k].spec[1:])})["w"].requires_grad_()
                for k, v in mp.items()}
            dx = distribute({"x": x}, {"x": Sharding(
                mesh, ("data", None, None))})["x"].requires_grad_()
            with activation_sharding(mesh):
                taken = M._mesh_path(mcfg, mesh, x.shape[0] * x.shape[1])
                y, aux = M.moe_fwd(mcfg, dp, dx, cap)
                loss = torch.sum(y * ct)
                grads = torch.autograd.grad(loss, [dx] + list(dp.values()))
            key = f"moe/{branch}/{cap_name}/"
            res[key + "taken"] = taken
            res[key + "y"] = full(y).detach()
            res[key + "lb_loss"] = float(full(aux["lb_loss"]))
            res[key + "load"] = aux["load"]
            res[key + "dropped"] = float(aux["dropped"])
            res[key + "grad/x"] = full(grads[0])
            for k, g in zip(dp, grads[1:]):
                res[key + "grad/" + k] = full(g)

    # the repairs: train steps on the (1, 4) mesh, heads 2 (granite-moe)
    # and 4 (xlstm) against a model axis of 4
    m14 = meshes["1x4"]
    for key, arch, n_layers in REPAIR_STEPS:
        rcfg = reduced_config(arch)
        if n_layers:
            rcfg = dataclasses.replace(rcfg, n_layers=n_layers)
        template = init_params(rcfg, torch.Generator().manual_seed(0),
                               device="cpu")
        rparams = map_with_path(
            lambda p, _: torch.from_numpy(data[key + "/" + p]), template)
        ropt = init_opt_state(rparams, opt_cfg)
        rps = param_shardings(m14, rparams)
        with activation_sharding(m14):
            rnew, _, rm = make_train_step(
                rcfg, opt_cfg, remat=True, grad_shardings=rps)(
                    distribute(rparams, rps),
                    distribute(ropt, opt_shardings(m14, ropt, rps)),
                    distribute(batch, batch_shardings(m14, batch,
                                                      batch_dim=1)))
        res[key + "/loss"] = float(rm["loss"])
        res[key + "/grad_norm"] = float(rm["grad_norm"])
        for p, leaf in leaves_with_path(rnew):
            res[key + "/new/" + p] = full(leaf)

    # the repairs: reduced granite-8b's prefill and decode steps with the
    # caches' sequence over "model"
    prompt = torch.from_numpy(data["dec/prompt"])
    nxt = torch.from_numpy(data["dec/next"])
    for name in DEC_MESHES:
        dm = meshes[name]
        sp = param_shardings(dm, params, mode="serve")
        st = init_state(cfg, DEC_B, DEC_S, device="cpu")
        st = distribute(st, state_shardings(dm, st, DEC_B, phase="decode"))
        dparams = distribute(params, sp)
        with activation_sharding(dm), torch.no_grad():
            for i, t in enumerate([prompt] + list(nxt)):
                dt = distribute({"t": t}, batch_shardings(dm, {"t": t}))["t"]
                out = forward(cfg, dparams, dt, state=st,
                              pos_offset=0 if i == 0 else DEC_PROMPT + i - 1,
                              logits_mode="last")
                st = out.state
                res[f"dec/{name}/logits/{i}"] = full(out.logits)
        for j, c in enumerate(st):
            res[f"dec/{name}/k/{j}"] = full(c.k)
            res[f"dec/{name}/v/{j}"] = full(c.v)
            res[f"dec/{name}/seq_placed/{j}"] = any(
                isinstance(pl, Shard) and pl.dim == 3
                for pl in c.k.placements)
    if rank == 0:
        torch.save(res, f"{tmp}/port.pt")
    dist.barrier()
    dist.destroy_process_group()


def _inputs(tmp: str) -> None:
    """The same numpy inputs for both packages: granite-8b's weights (the
    port's seed-0 draw) and batch, the MoE layer's weights, x and the
    cotangent of its output."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import init_params
    from repro_torch.models import moe as M
    from repro_torch.tree import leaves_with_path

    rng = np.random.default_rng(0)
    cfg = reduced_config(TRAIN_ARCH)
    out = {"train/" + p: leaf.numpy() for p, leaf in leaves_with_path(
        init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))}
    toks = rng.integers(0, cfg.vocab_size, (2, 8, 16)).astype(np.int32)
    out["train_batch/tokens"] = toks
    out["train_batch/labels"] = np.roll(toks, -1, axis=-1)
    for key, arch, n_layers in REPAIR_STEPS:
        rcfg = reduced_config(arch)
        if n_layers:
            rcfg = dataclasses.replace(rcfg, n_layers=n_layers)
        out.update({f"{key}/{p}": leaf.numpy() for p, leaf in
                    leaves_with_path(init_params(
                        rcfg, torch.Generator().manual_seed(3),
                        device="cpu"))})
    out["dec/prompt"] = rng.integers(0, cfg.vocab_size,
                                     (DEC_B, DEC_PROMPT)).astype(np.int32)
    out["dec/next"] = rng.integers(0, cfg.vocab_size,
                                   (DEC_STEPS, DEC_B, 1)).astype(np.int32)
    mcfg = reduced_config(MOE_ARCH)
    mp = M.init_moe(mcfg, torch.Generator().manual_seed(1), "cpu")
    for k, v in mp.items():
        out["moe/" + k] = v[0].numpy()
    out["moe/x"] = rng.standard_normal(MOE_X, dtype=np.float32)
    out["moe/ct"] = rng.standard_normal(MOE_X, dtype=np.float32)
    np.savez(f"{tmp}/inputs.npz", **out)


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    # seven processes at once, beside the other test workers: one thread
    # each for torch's tiny operators
    env["OMP_NUM_THREADS"] = "1"
    return env


def _wait(proc, what: str) -> str:
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    assert proc.returncode == 0, f"{what} failed:\n{err[-4000:]}"
    return out


@pytest.fixture(scope="module")
def runs():
    """The reference subprocess, the 4 gloo ranks and the 2-rank
    ``launch.train`` run, started together; their results."""
    with tempfile.TemporaryDirectory() as tmp:
        _inputs(tmp)
        env = _env()
        cfgj = {"meshes": MESHES, "archs": ARCHS, "state_archs": STATE_ARCHS,
                "batches": {str(k): v for k, v in BATCHES.items()},
                "train_arch": TRAIN_ARCH, "moe_arch": MOE_ARCH, "lr": LR,
                "moe_runs": MOE_RUNS, "caps": CAPS,
                "moe_meshes": MOE_MESHES, "repair_steps": REPAIR_STEPS,
                "dec_b": DEC_B, "dec_s": DEC_S, "dec_prompt": DEC_PROMPT,
                "dec_meshes": DEC_MESHES}
        popen = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                     text=True, env=env, cwd=tmp)
        ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT,
                                f"{tmp}/inputs.npz", tmp, json.dumps(cfgj)],
                               **popen)
        workers = [subprocess.Popen([sys.executable, __file__, "worker",
                                     str(r), "4", tmp], **popen)
                   for r in range(4)]
        launch = []
        for r in range(2):
            env_r = dict(env, REPRO_COORDINATOR=f"file://{tmp}/launch_rdv",
                         REPRO_NUM_PROCESSES="2", REPRO_PROCESS_ID=str(r))
            launch.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.train",
                 *LAUNCH_ARGV], **dict(popen, env=env_r)))
        launch_out = [_wait(p, f"launch rank {r}")
                      for r, p in enumerate(launch)]
        for r, p in enumerate(workers):
            _wait(p, f"gloo rank {r}")
        _wait(ref, "reference")
        with open(f"{tmp}/ref_specs.json") as f:
            specs = json.load(f)
        with np.load(f"{tmp}/ref.npz") as z:
            ref_res = {k: z[k] for k in z.files}
        yield {"specs": specs, "ref": ref_res,
               "port": torch.load(f"{tmp}/port.pt", weights_only=False),
               "inputs": dict(np.load(f"{tmp}/inputs.npz")),
               "launch": launch_out}


# --------------------------------------------------------- placements ---
def _layout(name):
    from repro_torch.sharding import MeshLayout

    shape, names = MESHES[name]
    return MeshLayout(names, shape)


def _port_specs(tree) -> dict:
    from repro_torch.tree import leaves_with_path

    return {p: _spec_json(s.spec) for p, s in leaves_with_path(tree)}


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_param_specs_equal_the_references(runs, mesh, mode):
    from repro_torch.configs import reduced_config
    from repro_torch.models import init_params
    from repro_torch.sharding import param_shardings

    lay = _layout(mesh)
    for arch in ARCHS:
        params = init_params(reduced_config(arch),
                             torch.Generator().manual_seed(0), device="cpu")
        got = _port_specs(param_shardings(lay, params, mode=mode))
        assert got == runs["specs"]["params"][f"{mesh}/{arch}/{mode}"], arch


@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_state_specs_equal_the_references(runs, arch):
    from repro_torch.configs import reduced_config
    from repro_torch.models import init_state
    from repro_torch.sharding import state_shardings

    cfg = reduced_config(arch)
    for mesh in MESHES:
        for b in (4, 1):
            st = init_state(cfg, b, 32, device="cpu")
            for phase in ("decode", "prefill"):
                got = _port_specs(state_shardings(_layout(mesh), st, b,
                                                  phase=phase))
                want = runs["specs"]["state"][f"{mesh}/{arch}/{b}/{phase}"]
                assert got == want, (mesh, b, phase)


@pytest.mark.parametrize("batch_dim", sorted(BATCHES))
def test_batch_specs_equal_the_references(runs, batch_dim):
    from repro_torch.sharding import batch_shardings

    batch = {k: torch.zeros(v, dtype=torch.int32)
             for k, v in BATCHES[batch_dim].items()}
    for mesh in MESHES:
        got = _port_specs(batch_shardings(_layout(mesh), batch,
                                          batch_dim=batch_dim))
        assert got == runs["specs"]["batch"][f"{mesh}/{batch_dim}"], mesh


@pytest.mark.parametrize("factored", [False, True])
def test_opt_specs_equal_the_references(runs, factored):
    from repro_torch.configs import reduced_config
    from repro_torch.models import init_params
    from repro_torch.sharding import opt_shardings, param_shardings
    from repro_torch.training import AdamWConfig, init_opt_state

    for arch in ("granite-8b", "jamba-1.5-large-398b"):
        params = init_params(reduced_config(arch),
                             torch.Generator().manual_seed(0), device="cpu")
        opt = init_opt_state(params, AdamWConfig(factored=factored))
        for mesh in MESHES:
            lay = _layout(mesh)
            got = _port_specs(opt_shardings(lay, opt,
                                            param_shardings(lay, params)))
            want = runs["specs"]["opt"][f"{mesh}/{arch}/{factored}"]
            assert got == want, (arch, mesh)


def test_placements_follow_the_specs():
    """A spec entry names the mesh dims that shard its tensor dim, pod-major
    for ("pod", "data"); the production layouts need no process group."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import production_layout
    from repro_torch.sharding import Sharding

    pod = production_layout(multi_pod=True)
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    s = Sharding(pod, (None, ("pod", "data"), "model"))
    assert s.placements == (Shard(1), Shard(1), Shard(2))
    one = production_layout()
    assert Sharding(one, ("model", None)).placements == (Replicate(),
                                                         Shard(0))


# --------------------------------------------------------- multi-rank ---
def _plain_step(runs):
    from repro_torch.configs import reduced_config
    from repro_torch.models import init_params
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)
    from repro_torch.tree import leaves_with_path, map_with_path

    inp = runs["inputs"]
    cfg = reduced_config(TRAIN_ARCH)
    template = init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    params = map_with_path(
        lambda p, _: torch.from_numpy(inp["train/" + p]), template)
    opt_cfg = AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)
    batch = {k: torch.from_numpy(inp["train_batch/" + k])
             for k in ("tokens", "labels")}
    new_p, _, m = make_train_step(cfg, opt_cfg, remat=True)(
        params, init_opt_state(params, opt_cfg), batch)
    return (float(m["loss"]), float(m["grad_norm"]), float(m["lr"]),
            {p: leaf for p, leaf in leaves_with_path(new_p)})


def _parted(a: dict, b: dict, lr: float) -> tuple:
    n = sum(v.numel() for v in a.values())
    parted = sum(int(((a[k] - torch.as_tensor(b[k])).abs() >= lr).sum())
                 for k in a)
    return parted, n


@pytest.mark.parametrize("against", ["plain", "reference"])
def test_sharded_train_step(runs, against):
    """Reduced granite-8b on 4 gloo ranks, (2, 2) mesh, 2 microbatches with
    ``grad_shardings``: against the port's plain step and the reference's
    sharded step on its (2, 2) Auto mesh."""
    port = runs["port"]
    got_p = {k[len("train/new/"):]: v for k, v in port.items()
             if k.startswith("train/new/")}
    loss, gnorm, lr, plain_p = _plain_step(runs)
    assert lr == pytest.approx(LR, rel=1e-6)
    if against == "plain":
        want = (loss, gnorm, plain_p)
    else:
        ref = runs["ref"]
        want = (float(ref["train/loss"]), float(ref["train/grad_norm"]),
                {k[len("train/new/"):]: v for k, v in ref.items()
                 if k.startswith("train/new/")})
    parted, n = _parted(got_p, want[2], lr)
    worst = max(float((v - torch.as_tensor(want[2][k])).abs().max())
                for k, v in got_p.items())
    # the measured gaps (PERF.md records them; shown under pytest -s)
    print(f"sharded step against the {against} one: loss "
          f"{abs(port['train/loss'] - want[0]) / abs(want[0]):.3g}, grad norm "
          f"{abs(port['train/grad_norm'] - want[1]) / abs(want[1]):.3g} "
          f"relative; {parted} of {n} parameters part by >= lr, the most "
          f"by {worst / lr:.3g} lr")
    assert port["train/placements"]
    assert abs(port["train/loss"] - want[0]) <= STEP_TOL * abs(want[0])
    assert abs(port["train/grad_norm"] - want[1]) <= STEP_TOL * abs(want[1])
    assert sorted(got_p) == sorted(want[2])
    assert parted <= PARTED_SHARE * n, (parted, n)


def test_sharded_moe_train_step_equals_the_plain(runs):
    """Reduced granite-moe's train step on the (2, 2) mesh (its MoE layers
    on the ep branch, in the remat recompute too) against the port's plain
    step: top-8 of 8 experts drops nothing at the default capacity, so the
    per-shard capacity changes no output."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import init_params
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)
    from repro_torch.tree import leaves_with_path

    port, inp = runs["port"], runs["inputs"]
    cfg = reduced_config(MOE_ARCH)
    params = init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    opt_cfg = AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)
    batch = {k: torch.from_numpy(inp["train_batch/" + k])
             for k in ("tokens", "labels")}
    new_p, _, m = make_train_step(cfg, opt_cfg, remat=True)(
        params, init_opt_state(params, opt_cfg), batch)
    want = {p: leaf for p, leaf in leaves_with_path(new_p)}
    got = {k[len("moe_train/new/"):]: v for k, v in port.items()
           if k.startswith("moe_train/new/")}
    assert float(m["dropped"]) == 0.0
    assert abs(port["moe_train/loss"] - float(m["loss"])) <= \
        STEP_TOL * abs(float(m["loss"]))
    assert abs(port["moe_train/grad_norm"] - float(m["grad_norm"])) <= \
        STEP_TOL * abs(float(m["grad_norm"]))
    assert sorted(got) == sorted(want)
    parted, n = _parted(got, want, float(m["lr"]))
    assert parted <= PARTED_SHARE * n, (parted, n)


def _true_dropped(runs, mesh: str, cap) -> float:
    """The per-shard drop share from each data shard's own expert counts
    (numpy: router, softmax, top-k), against each shard's capacity."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.moe import default_capacity

    inp = runs["inputs"]
    cfg = reduced_config(MOE_ARCH)
    k, e = cfg.moe.top_k, cfg.moe.n_experts
    xf = inp["moe/x"].reshape(-1, MOE_X[-1]).astype(np.float64)
    logits = xf @ inp["moe/router"].astype(np.float64)
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :k]
    dp = MOE_MESHES[mesh][0][0]
    t_l = xf.shape[0] // dp
    c = cap if cap is not None else default_capacity(cfg, t_l)
    c = max(8, min(c, t_l * k))
    kept = sum(np.minimum(np.bincount(top[s * t_l:(s + 1) * t_l].ravel(),
                                      minlength=e), c).sum()
               for s in range(dp))
    return 1.0 - kept / (xf.shape[0] * k)


# the reference's readings of ``dropped`` under the mesh on this test's
# inputs (summed counts against one shard's capacity)
REF_DROPPED = {("ep", "default"): 0.375, ("local", "default"): 0.625,
               ("ep", "12"): 0.8125, ("local", "12"): 0.8125}


@pytest.mark.parametrize("cap_name", sorted(CAPS))
@pytest.mark.parametrize("branch", sorted(MOE_RUNS))
def test_moe_mesh_branch(runs, branch, cap_name):
    """Reduced granite-moe (E = 8, top-8) on 4 gloo ranks: the local branch
    on (4, 1), the ep branch on (2, 2), against the reference's on the
    same Auto mesh."""
    port, ref = runs["port"], runs["ref"]
    key = f"moe/{branch}/{cap_name}/"
    assert port[key + "taken"] == branch
    y_ref = ref[key + "y"]
    scale = float(np.abs(y_ref).max())
    err = float((port[key + "y"] - torch.from_numpy(y_ref)).abs().max())
    true = _true_dropped(runs, MOE_RUNS[branch], CAPS[cap_name])
    print(f"{branch} branch, capacity {cap_name}: y {err / scale:.3g} of "
          f"scale, lb_loss "
          f"{abs(port[key + 'lb_loss'] - float(ref[key + 'lb_loss'])):.3g}; "
          f"dropped {port[key + 'dropped']} (per shard {true}), reference "
          f"{float(ref[key + 'dropped'])}")
    assert err <= MOE_TOL * scale
    assert abs(port[key + "lb_loss"] - float(ref[key + "lb_loss"])) \
        <= MOE_TOL
    assert np.array_equal(port[key + "load"].numpy(), ref[key + "load"])
    assert port[key + "dropped"] == pytest.approx(true, abs=1e-7)
    # the reference's misreading, on record beside the port's
    assert float(ref[key + "dropped"]) == pytest.approx(
        REF_DROPPED[(branch, cap_name)], abs=1e-7)


@pytest.mark.parametrize("cap_name", sorted(CAPS))
def test_moe_ep_gradients(runs, cap_name):
    """Gradients through the ep branch's two all-to-alls (x and every
    weight) against the reference's."""
    port, ref = runs["port"], runs["ref"]
    key = f"moe/ep/{cap_name}/grad/"
    for name in ("x", "router", "wi", "wg", "wo"):
        want = ref[key + name]
        scale = float(np.abs(want).max())
        err = float((port[key + name] - torch.from_numpy(want)).abs().max())
        print(f"ep branch, capacity {cap_name}: grad of {name} "
              f"{err / scale:.3g} of scale")
        assert err <= MOE_TOL * scale, (name, err, scale)


def _plain_repair_step(runs, key, arch, n_layers):
    from repro_torch.configs import reduced_config
    from repro_torch.models import init_params
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)
    from repro_torch.tree import leaves_with_path, map_with_path

    inp = runs["inputs"]
    cfg = reduced_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    template = init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    params = map_with_path(
        lambda p, _: torch.from_numpy(inp[key + "/" + p]), template)
    opt_cfg = AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)
    batch = {k: torch.from_numpy(inp["train_batch/" + k])
             for k in ("tokens", "labels")}
    new_p, _, m = make_train_step(cfg, opt_cfg, remat=True)(
        params, init_opt_state(params, opt_cfg), batch)
    return (float(m["loss"]), float(m["grad_norm"]), float(m["lr"]),
            {p: leaf for p, leaf in leaves_with_path(new_p)})


@pytest.mark.parametrize("against", ["plain", "reference"])
@pytest.mark.parametrize("key,arch,n_layers", REPAIR_STEPS,
                         ids=[k for k, _, _ in REPAIR_STEPS])
def test_sharded_step_where_the_model_axis_does_not_divide_the_heads(
        runs, key, arch, n_layers, against):
    """The (1, 4) mesh: reduced granite-moe-1b-a400m (2 kv heads) and
    reduced xlstm-1.3b cut to one period (4 heads; the mLSTM and sLSTM
    forget gates' log-sigmoid) take the sharded train step, against the
    port's plain step and the reference's on its (1, 4) Auto mesh.  A
    plain head reshape raises "Cannot unflatten unevenly sharded tensor"
    there, and DTensor has no sharding strategy for
    ``aten.log_sigmoid_backward``."""
    port = runs["port"]
    loss, gnorm, lr, plain_p = _plain_repair_step(runs, key, arch, n_layers)
    if against == "plain":
        want = (loss, gnorm, plain_p)
    else:
        ref = runs["ref"]
        pre = key + "/new/"
        want = (float(ref[key + "/loss"]), float(ref[key + "/grad_norm"]),
                {k[len(pre):]: v for k, v in ref.items()
                 if k.startswith(pre)})
    got_p = {k[len(key + "/new/"):]: v for k, v in port.items()
             if k.startswith(key + "/new/")}
    parted, n = _parted(got_p, want[2], lr)
    xl = arch == "xlstm-1.3b"
    g_tol = XLSTM_GRAD_TOL if xl else STEP_TOL
    share = XLSTM_PARTED_SHARE if xl else PARTED_SHARE
    print(f"{key} on (1, 4) against the {against} step: loss "
          f"{abs(port[key + '/loss'] - want[0]) / abs(want[0]):.3g}, grad "
          f"norm {abs(port[key + '/grad_norm'] - want[1]) / abs(want[1]):.3g}"
          f" relative; {parted} of {n} parameters part by >= lr")
    assert sorted(got_p) == sorted(want[2])
    assert abs(port[key + "/loss"] - want[0]) <= STEP_TOL * abs(want[0])
    assert abs(port[key + "/grad_norm"] - want[1]) <= g_tol * abs(want[1])
    assert parted <= share * n, (parted, n)


def _plain_decode(runs):
    """Reduced granite-8b's prefill and decode steps, plain: the logits of
    each and the caches after the last."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import forward, init_params, init_state
    from repro_torch.tree import map_with_path

    inp = runs["inputs"]
    cfg = reduced_config(TRAIN_ARCH)
    template = init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    params = map_with_path(
        lambda p, _: torch.from_numpy(inp["train/" + p]), template)
    st = init_state(cfg, DEC_B, DEC_S, device="cpu")
    logits = []
    steps = [inp["dec/prompt"]] + list(inp["dec/next"])
    with torch.no_grad():
        for i, t in enumerate(steps):
            out = forward(cfg, params, torch.from_numpy(t), state=st,
                          pos_offset=0 if i == 0 else DEC_PROMPT + i - 1,
                          logits_mode="last")
            st = out.state
            logits.append(out.logits)
    return logits, st


@pytest.mark.parametrize("against", ["plain", "reference"])
@pytest.mark.parametrize("mesh", sorted(DEC_MESHES))
def test_sharded_decode_on_a_sequence_sharded_cache(runs, mesh, against):
    """Reduced granite-8b on (2, 2) and (1, 4): serve-mode weights, the KV
    caches laid out by ``state_shardings(phase="decode")`` (the sequence
    over "model"), a prefill of 8 tokens and 3 decode steps, against the
    port's plain run and the reference's on its Auto mesh.  Each rank
    writes the positions of its own slice; a plain ``scatter_`` into the
    cache raises "in-place operations that require placement changes are
    not supported"."""
    port = runs["port"]
    plain_logits, plain_state = _plain_decode(runs)
    n_steps = 1 + DEC_STEPS
    if against == "plain":
        want_logits = plain_logits
        want_kv = {f"{a}/{j}": getattr(c, a) for j, c in
                   enumerate(plain_state) for a in ("k", "v")}
    else:
        ref = runs["ref"]
        want_logits = [torch.from_numpy(ref[f"dec/{mesh}/logits/{i}"])
                       for i in range(n_steps)]
        want_kv = {k[len(f"dec/{mesh}/"):]: torch.from_numpy(v)
                   for k, v in ref.items()
                   if k.startswith(f"dec/{mesh}/k/")
                   or k.startswith(f"dec/{mesh}/v/")}
    for i in range(n_steps):
        got = port[f"dec/{mesh}/logits/{i}"]
        scale = float(want_logits[i].abs().max())
        err = float((got - want_logits[i]).abs().max())
        print(f"decode on {mesh} against the {against} run, step {i}: "
              f"logits {err / scale:.3g} of scale")
        assert err <= STEP_TOL * scale, (i, err, scale)
    written = DEC_PROMPT + DEC_STEPS
    assert want_kv
    for name, want in want_kv.items():
        assert port[f"dec/{mesh}/seq_placed/{name.split('/')[1]}"]
        got = port[f"dec/{mesh}/{name}"]
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= STEP_TOL * scale, name
        assert not got[..., :written, :].eq(0).all()
        assert got[..., written:, :].eq(0).all(), name


def test_restore_onto_another_mesh(runs):
    """Params and optimizer state saved from the (2, 2) mesh, restored onto
    (4, 1) in its layout: bitwise the saved values and the plain restore."""
    assert runs["port"]["restore/bitwise"]
    assert runs["port"]["restore/placements"]


def test_constrain_is_a_no_op_off_the_mesh(runs):
    from repro_torch.sharding import (MeshLayout, activation_sharding,
                                      constrain, constrain_tree,
                                      current_mesh)

    x = torch.ones(4, 8)
    assert current_mesh() is None
    assert constrain(x, ("dp", "tp")) is x
    lay = MeshLayout(("data", "model"), (2, 2))
    with activation_sharding(lay):
        assert current_mesh() is lay
        assert constrain(x, ("dp", "tp")) is x
        assert constrain_tree({"x": x}, None)["x"] is x
    assert runs["port"]["constrain"]


def test_init_cluster_without_environment(monkeypatch):
    from repro_torch.launch.cluster import host_data_slice, init_cluster

    for var in ("REPRO_COORDINATOR", "REPRO_NUM_PROCESSES",
                "REPRO_PROCESS_ID", "RANK", "WORLD_SIZE", "SLURM_PROCID",
                "SLURM_NTASKS"):
        monkeypatch.delenv(var, raising=False)
    assert init_cluster(device="cpu") is False
    assert host_data_slice() == (0, 1)


def test_init_cluster_raises_where_it_cannot_join(monkeypatch):
    """A multi-process environment that cannot be joined raises (the
    reference prints and carries on single-host); a launcher's single
    process is no cluster."""
    import torch.distributed as dist

    from repro_torch.launch.cluster import init_cluster

    for var in ("REPRO_COORDINATOR", "REPRO_NUM_PROCESSES",
                "REPRO_PROCESS_ID", "RANK", "WORLD_SIZE", "SLURM_PROCID",
                "SLURM_NTASKS", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="failed"):
        init_cluster("nowhere://rendezvous", 2, 0, device="cpu")
    with pytest.raises(RuntimeError, match="REPRO_NUM_PROCESSES"):
        init_cluster("localhost:1", device="cpu")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        init_cluster(device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert init_cluster(device="cpu") is False
    assert not dist.is_initialized()


def test_two_rank_launch_matches_one_rank(runs, capsys, monkeypatch):
    """``launch.train`` on 2 gloo ranks over ``build_mesh_if_useful``'s (1,
    2) mesh prints the 1-rank run's losses."""
    import re

    from repro_torch.launch import train as train_mod

    for var in ("REPRO_COORDINATOR", "RANK", "SLURM_PROCID"):
        monkeypatch.delenv(var, raising=False)
    assert train_mod.main(LAUNCH_ARGV) == 0
    one = capsys.readouterr().out
    pat = re.compile(r"\[train\] step (\d+) loss=(\S+) lr=(\S+)")

    def steps(text):
        return [(int(m[1]), float(m[2]), m[3]) for m in pat.finditer(text)]

    two = steps(runs["launch"][0])
    assert not steps(runs["launch"][1])  # only rank 0 prints
    assert len(two) == 3 and [s[0] for s in two] == [1, 2, 3]
    for (_, l2, lr2), (_, l1, lr1) in zip(two, steps(one)):
        assert lr2 == lr1
        assert abs(l2 - l1) <= 1e-5 * abs(l1)


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
