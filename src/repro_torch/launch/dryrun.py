"""Dry run of the port (``repro.launch.dryrun``): trace every (arch x
shape) cell on the production mesh, without hardware.

For each cell this shows:
  * the sharding is coherent: the port's own step runs over DTensors laid
    out by :mod:`repro_torch.sharding` on the 16x16 (or 2x16x16) mesh of
    a world of 256 (512) ranks;
  * per-device peak memory of the local shards (a lower bound, see
    :class:`~repro_torch.launch.roofline.StepRecorder`);
  * the roofline terms (:mod:`.analytic`'s FLOPs and bytes, the
    collectives the step issues over each group's link).

The process is rank 0 of a fake process group (:func:`init_fake_world`:
collectives return at once and move nothing) and every tensor lives on
the meta device (shapes and dtypes, no storage, no arithmetic), so a
cell of any size traces on one host.  The mesh's device type is
``"cuda"``, so DTensor issues the collectives the card would (over a
``"cpu"`` mesh it stands an all-gather and a chunk in for an all-to-all).

Usage:
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--jobs N]
Results land in experiments/dryrun/<arch>__<shape>__<mesh>.json.
Importing this module touches no process group.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.configs import (ARCHS, SHAPES, ShapeSpec, cells, get_config,
                                 shape_supported)
from repro_torch.launch.mesh import production_layout
from repro_torch.launch.roofline import StepRecorder, analyze
from repro_torch.models import abstract_params, abstract_state, forward
from repro_torch.sharding.specs import (P, Sharding, activation_sharding,
                                        batch_shardings, opt_shardings,
                                        param_shardings, state_shardings)
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
from repro_torch.tree import leaves, tree_map

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun")

# >=50B params: factored moments + bf16 mu (see training/optimizer.py).
FACTORED_THRESHOLD = 50e9

# --all: a cell still tracing after this long is recorded as not run
CELL_TIMEOUT_S = 1200

MESH_TAGS = {False: "16x16", True: "2x16x16"}


def init_fake_world(world: int) -> None:
    """Join a fake process group of ``world`` ranks as rank 0: its
    collectives return at once and move nothing.  ``FakeStore`` is private
    to torch's tests (``torch.testing._internal.distributed.fake_pg``);
    checked on torch 2.13.0+cpu and 2.11.0+cu128."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def production_mesh(*, multi_pod: bool = False):
    """The production mesh, device type ``"cuda"`` whether or not this host
    has a card, over the fake world of :func:`init_fake_world`."""
    from torch.distributed.device_mesh import init_device_mesh

    lay = production_layout(multi_pod=multi_pod)
    return init_device_mesh("cuda", lay.dims, mesh_dim_names=lay.axis_names)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape: ShapeSpec, *, n_micro: int = 8) -> dict:
    """Meta stand-ins for every model input of this cell."""
    b, s = shape.batch, shape.seq
    dt, i32 = cfg.cdtype, torch.int32
    if shape.kind == "train":
        mb = b // n_micro
        batch = {}
        if cfg.embed_input:
            batch["embeds"] = _meta((n_micro, mb, s, cfg.d_model), dt)
            batch["labels"] = _meta((n_micro, mb, s), i32)
        elif cfg.n_prefix:
            s_txt = s - cfg.n_prefix
            batch["tokens"] = _meta((n_micro, mb, s_txt), i32)
            batch["prefix_embeds"] = _meta(
                (n_micro, mb, cfg.n_prefix, cfg.d_model), dt)
            batch["labels"] = _meta((n_micro, mb, s_txt), i32)
        else:
            batch["tokens"] = _meta((n_micro, mb, s), i32)
            batch["labels"] = _meta((n_micro, mb, s), i32)
        return {"batch": batch}
    if shape.kind == "prefill":
        if cfg.embed_input:
            return {"embeds": _meta((b, s, cfg.d_model), dt)}
        if cfg.n_prefix:
            return {
                "tokens": _meta((b, s - cfg.n_prefix), i32),
                "prefix_embeds": _meta((b, cfg.n_prefix, cfg.d_model), dt),
            }
        return {"tokens": _meta((b, s), i32)}
    # decode: one new token against a state of seq_len
    if cfg.embed_input:
        return {"embeds": _meta((b, 1, cfg.d_model), dt)}
    return {"tokens": _meta((b, 1), i32)}


def build_cell(cfg, shape: ShapeSpec, mesh, n_micro: int = 8):
    """Returns (fn, args, shardings): meta args and, on a mesh, their
    shardings (None for ``mesh=None``, a plain run on one device)."""
    params = abstract_params(cfg)
    # decode is weight-bandwidth bound: serve-mode placement keeps weights
    # stationary (no FSDP gathers); train/prefill amortize FSDP gathers
    # over a large token volume.
    p_sh = None if mesh is None else param_shardings(
        mesh, params, mode="serve" if shape.kind == "decode" else "train")
    specs = input_specs(cfg, shape, n_micro=n_micro)

    def sharded(fn, *a, **kw):
        return None if mesh is None else fn(mesh, *a, **kw)

    if shape.kind == "train":
        opt_cfg = AdamWConfig(
            factored=cfg.param_count() > FACTORED_THRESHOLD,
            total_steps=10_000,
        )
        opt = init_opt_state(params, opt_cfg)
        o_sh = sharded(opt_shardings, opt, p_sh)
        b_sh = sharded(batch_shardings, specs["batch"], batch_dim=1)
        # capacity=None: moe_fwd derives the per-dispatch-group capacity
        # from its local token count
        big = cfg.param_count() > FACTORED_THRESHOLD
        step = make_train_step(cfg, opt_cfg, capacity=None, remat=True,
                               acc_dtype=torch.bfloat16 if big
                               else torch.float32,
                               grad_shardings=p_sh)
        return step, (params, opt, specs["batch"]), (p_sh, o_sh, b_sh)

    if shape.kind == "prefill":
        state = abstract_state(cfg, shape.batch, shape.seq)
        in_sh = [p_sh]
        args = [params]
        for k in ("tokens", "embeds", "prefix_embeds"):
            if k in specs:
                args.append(specs[k])
                in_sh.append(sharded(batch_shardings, specs[k], batch_dim=0))
        args.append(state)
        in_sh.append(sharded(state_shardings, state, shape.batch,
                             phase="prefill"))
        has_prefix = "prefix_embeds" in specs
        has_embeds = "embeds" in specs

        def prefill(params, *rest):
            i = 0
            tokens = embeds = prefix = None
            if not has_embeds:
                tokens = rest[i]
                i += 1
            if has_embeds:
                embeds = rest[i]
                i += 1
            if has_prefix:
                prefix = rest[i]
                i += 1
            state = rest[i]
            out = forward(cfg, params, tokens, embeds=embeds,
                          prefix_embeds=prefix, state=state,
                          logits_mode="last")
            return out.logits, out.state

        return prefill, tuple(args), tuple(in_sh)

    # decode
    state = abstract_state(cfg, shape.batch, shape.seq)
    s_sh = sharded(state_shardings, state, shape.batch, phase="decode")
    tok_spec = specs["embeds" if cfg.embed_input else "tokens"]
    t_sh = sharded(batch_shardings, tok_spec, batch_dim=0)
    offset = _meta((), torch.int32)
    off_sh = None if mesh is None else Sharding(mesh, P())
    use_embeds = cfg.embed_input

    def decode(params, tok, state, offset):
        out = forward(cfg, params,
                      None if use_embeds else tok,
                      embeds=tok if use_embeds else None,
                      state=state, pos_offset=offset, logits_mode="last")
        return out.logits, out.state

    return decode, (params, tok_spec, state, offset), (p_sh, t_sh, s_sh,
                                                        off_sh)


def _place(x: torch.Tensor, s: Sharding):
    """Meta ``x`` as a DTensor laid out by ``s``, built from its local
    shard: no collective, no storage."""
    from torch.distributed.tensor import DTensor, Shard

    local = list(x.shape)
    for size, p in zip(s.mesh.shape, s.placements):
        if isinstance(p, Shard):
            assert local[p.dim] % size == 0, (tuple(x.shape), s.spec)
            local[p.dim] //= size
    return DTensor.from_local(_meta(local, x.dtype), s.mesh, s.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def _local_bytes(tree) -> int:
    return sum(getattr(t, "_local_tensor", t).numel() * t.element_size()
               for t in leaves(tree) if isinstance(t, torch.Tensor))


def trace_cell(cfg, shape: ShapeSpec, mesh, *, arch: str,
               n_micro: int = 8) -> dict:
    """Trace one step of the cell (on ``mesh``, or plain on one device for
    ``mesh=None``) under the recorder and ``FlopCounterMode``: its
    :class:`~repro_torch.launch.roofline.Roofline`, the recorder (every
    collective and where it was issued) and the trace's wall seconds."""
    from torch.utils.flop_counter import FlopCounterMode

    fn, args, shardings = build_cell(cfg, shape, mesh, n_micro)
    if mesh is not None:
        args = tuple(a if s is None else
                     (_place(a, s) if isinstance(a, torch.Tensor)
                      else tree_map(_place, a, s))
                     for a, s in zip(args, shardings))
    rec = StepRecorder()
    rec.hold(t for t in leaves(args) if isinstance(t, torch.Tensor))
    ctx = (activation_sharding(mesh) if mesh is not None
           else contextlib.nullcontext())
    grad = (contextlib.nullcontext() if shape.kind == "train"
            else torch.no_grad())
    t0 = time.perf_counter()
    with ctx, grad, rec, FlopCounterMode(display=False) as fc:
        out = fn(*args)
    seconds = time.perf_counter() - t0
    dims = (1,) if mesh is None else tuple(mesh.shape)
    roof = analyze(rec, float(fc.get_total_flops()), arch=arch, shape=shape,
                   mesh_dims=dims, cfg=cfg, output_bytes=_local_bytes(out))
    return {"roofline": roof, "recorder": rec, "trace_seconds": seconds}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = OUT_DIR) -> dict:
    """One cell in this process: the fake world, its mesh, the trace, and
    the cell's JSON under ``out_dir``."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if not shape_supported(cfg, shape_name):
        return {"arch": arch, "shape": shape_name, "status": "SKIP",
                "reason": "long_500k requires sub-quadratic attention"}
    lay = production_layout(multi_pod=multi_pod)
    init_fake_world(math.prod(lay.dims))
    mesh = production_mesh(multi_pod=multi_pod)
    got = trace_cell(cfg, shape, mesh, arch=arch)
    roof, rec = got["roofline"], got["recorder"]
    result = {
        "status": "OK",
        "mesh_shape": list(lay.dims),
        "multi_pod": multi_pod,
        "trace_seconds": got["trace_seconds"],
        "collectives_issued": len(rec.records),
        "t_bound": roof.t_bound,
        **roof.to_dict(),
    }
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir,
                        f"{arch}__{shape_name}__{MESH_TAGS[multi_pod]}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return result


SUMMARY_KEYS = ("arch", "shape", "mesh_shape", "trace_seconds", "flops",
                "hbm_bytes", "wire_bytes", "bottleneck", "t_compute",
                "t_memory", "t_collective", "peak_mem_bytes")


def _run_one(arch: str, shape: str, multi_pod: bool, out: str) -> tuple:
    """One cell in a subprocess: (status, seconds, last output line)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out", out]
    if multi_pod:
        cmd.append("--multi-pod")
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=CELL_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        return "NOT RUN", time.perf_counter() - t0, \
            f"still tracing after {CELL_TIMEOUT_S} s"
    secs = time.perf_counter() - t0
    if r.returncode != 0:
        return "FAIL", secs, (r.stdout[-2000:] + "\n" + r.stderr[-3000:])
    return "OK", secs, r.stdout.strip().splitlines()[-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every assigned cell in subprocesses")
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --all: cells traced at once")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    if args.all:
        tag = MESH_TAGS[args.multi_pod]
        todo = []
        for arch, shape, ok in cells(include_skipped=True):
            if not ok:
                print(f"[dryrun] SKIP {arch} x {shape} x {tag} (long_500k "
                      f"needs sub-quadratic attention)")
            else:
                todo.append((arch, shape))
        bad = []
        with ThreadPoolExecutor(max(1, args.jobs)) as pool:
            futs = [(a, s, pool.submit(_run_one, a, s, args.multi_pod,
                                       args.out)) for a, s in todo]
            for arch, shape, fut in futs:
                status, secs, line = fut.result()
                cell = f"{arch} x {shape} x {tag}"
                if status == "OK":
                    print(line, flush=True)
                else:
                    bad.append(f"{status} {cell} ({secs:.0f} s)")
                    print(f"[dryrun] {status} {cell} after {secs:.0f} s\n"
                          f"{line}", flush=True)
        print(f"[dryrun] done; {len(todo) - len(bad)} of {len(todo)} cells "
              f"traced; not traced: {', '.join(bad) or 'none'}")
        return 1 if bad else 0

    if args.arch is None or args.shape is None:
        ap.error("--arch and --shape, or --all")
    res = run_cell(args.arch, args.shape, args.multi_pod, args.out)
    if res["status"] == "OK":
        print(json.dumps({k: res[k] for k in SUMMARY_KEYS}, default=str))
    else:
        print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
