"""End-to-end training driver with fault tolerance, on the port.

  python -m repro_torch.launch.train --arch olmo-1b --preset full \
      --steps 4 --global-batch 8 --microbatch 4 --seq-len 2048

The reference's driver (``repro.launch.train``), flag for flag, with
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path):

  * config-driven model construction (any assigned arch, or its reduced
    preset), random weights from seed 0;
  * the microbatched train step with remat, run eagerly (float32 gradient
    accumulator, AdamW with factored moments above 50e9 parameters);
  * atomic checkpointing + automatic resume: a relaunch continues from the
    last checkpoint with the data stream positioned after the last batch
    the checkpointed step consumed;
  * straggler telemetry: per-step wall times feed a
    :class:`repro_torch.runtime.RatioTable` persisted next to the
    checkpoints (``ratios.json``), so ratios warm-start across restarts.

On a world of 2 or more processes (:func:`repro_torch.launch.cluster.
init_cluster`: ``REPRO_COORDINATOR``/``REPRO_NUM_PROCESSES``/
``REPRO_PROCESS_ID``, torchrun or SLURM) the run is sharded over
:func:`build_mesh_if_useful`'s (n // model, model) mesh: parameters,
optimizer state and the batch as DTensors laid out by
``param_shardings``/``opt_shardings``/``batch_shardings(batch_dim=1)``, the
step's gradients constrained to the parameters' layout.  Each rank builds
the global batch and takes its part at its position on the data axes, so
every step trains on the 1-rank run's global batch; rank 0 prints and
writes.  (The reference builds that mesh but never uses it.)  On a world
of 1, the default, nothing is sharded.

The checkpoint records the number of batches the training consumed as its
``data_step``.  The reference records the stream's own counter, which its
prefetch thread has already moved up to three batches further, so a
resumed reference run skips batches an uninterrupted one trains on; the
port's resumed run trains on the batches the uninterrupted run does.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Iterator

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.configs import get_config, reduced_config
from repro_torch.data import DataConfig, Prefetcher, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.runtime import RatioStore, RatioTable
from repro_torch.sharding import (activation_sharding, batch_shardings,
                                  distribute, opt_shardings, param_shardings)
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
from .cluster import host_data_slice, init_cluster

__all__ = ["build_parser", "build_mesh_if_useful", "train", "main"]


def build_mesh_if_useful(device="cuda"):
    """The (n // model, model) ``("data", "model")`` mesh over a world of
    n >= 2 processes, model = 2 when n is even; None on a world of 1."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n < 2:
        return None
    model = 2 if n % 2 == 0 else 1
    return init_device_mesh(resolve_device(device).type, (n // model, model),
                            mesh_dim_names=("data", "model"))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train a model of the zoo on "
                                             "the port.")
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--preset", choices=["tiny", "full"], default="tiny")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, the plain PyTorch path")
    return ap


def train(args) -> Iterator[str]:
    """Run the training ``args`` ask for, yielding the reference's
    ``[train] ...`` lines as they happen."""
    device = resolve_device(args.device)
    # a group this run joins itself, it also leaves
    own_group = not dist.is_initialized() and init_cluster(device=device)
    mesh = build_mesh_if_useful(device)
    cfg = get_config(args.arch) if args.preset == "full" else reduced_config(args.arch)
    if cfg.embed_input or cfg.n_prefix:
        raise SystemExit("use examples/ for stub-frontend archs")

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps,
                          factored=cfg.param_count() > 50e9)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                          global_batch=args.global_batch,
                          microbatch=args.microbatch)
    data = SyntheticLM(data_cfg)

    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    opt = init_opt_state(params, opt_cfg)
    shardings = grad_shardings = None
    if mesh is not None:
        grad_shardings = param_shardings(mesh, params)
        shardings = {"params": grad_shardings,
                     "opt": opt_shardings(mesh, opt, grad_shardings)}
        tree = distribute({"params": params, "opt": opt}, shardings)
        params, opt = tree["params"], tree["opt"]
    start_step = 0

    if args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            tree, meta = restore(args.ckpt_dir, last,
                                 {"params": params, "opt": opt},
                                 device=device, shardings=shardings)
            params, opt = tree["params"], tree["opt"]
            start_step = last
            data.seek(meta["extra"]["data_step"])
            yield f"[train] resumed from step {last}"
    data_start = data.step

    step_fn = make_train_step(cfg, opt_cfg, remat=True,
                              grad_shardings=grad_shardings)

    def on_mesh():
        return (activation_sharding(mesh) if mesh is not None
                else contextlib.nullcontext())

    table = RatioTable(n_workers=1)  # per-pod table at scale
    store = (RatioStore(os.path.join(args.ckpt_dir, "ratios.json"))
             if args.ckpt_dir else None)
    if store is not None:
        try:
            if store.load_into(table):
                yield ("[train] warm-started performance ratios from "
                       f"{store.path}")
        except Exception as e:  # a corrupt sidecar must not block training
            yield f"[train] ignoring unreadable ratio store ({e})"
    it = Prefetcher(iter(data), depth=2)

    def checkpoint(step: int) -> None:
        save(args.ckpt_dir, step, {"params": params, "opt": opt},
             extra={"data_step": data_start + step - start_step})
        if host_data_slice()[0] == 0:
            store.save(table)

    try:
        t_start = time.time()
        for step in range(start_step, args.steps):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in next(it).items()}
            if mesh is not None:
                # this rank's rows of the global batch
                batch = distribute(batch, batch_shardings(mesh, batch,
                                                          batch_dim=1))
            t0 = time.perf_counter()
            with on_mesh():
                params, opt, metrics = step_fn(params, opt, batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            table.update("train_step", np.array([dt]))
            if (step + 1) % args.log_every == 0:
                toks = args.global_batch * args.seq_len / dt
                yield (f"[train] step {step + 1} "
                       f"loss={float(metrics['loss']):.4f} "
                       f"lr={float(metrics['lr']):.2e} "
                       f"gnorm={float(metrics['grad_norm']):.2f} "
                       f"tok/s={toks:.0f}")
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                checkpoint(step + 1)
        if args.ckpt_dir:
            checkpoint(args.steps)
        yield f"[train] done in {time.time() - t_start:.1f}s"
    finally:
        it.close()
        if own_group:
            dist.destroy_process_group()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for line in train(args):
        if host_data_slice()[0] == 0:
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
