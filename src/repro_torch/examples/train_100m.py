"""End-to-end driver: train a llama-family model of 56M parameters for a
few hundred steps on synthetic data, with checkpoint/restart and the
paper's uneven-DP straggler mitigation running in simulation.  The port of
``examples/train_100m.py``.

  python -m repro_torch.examples.train_100m [--steps 300] [--uneven-every N]
      [--ckpt-dir DIR] [--device cuda|cpu]

The model is the reference's ``CFG``: 12L x d512 x 8H (kv 4) x ff 2048,
vocab 8192, float32.  Its docstring says "~101M params"; the count it
prints, and this one, is 56M (12 layers of 3.9M and 8.4M of embedding and
head).  Loss drops fast because the stream is a learnable 2-gram (see
:mod:`repro_torch.data`).  The weights come from a seeded generator on
the CPU, so a card run and a CPU run start from the same model.

Every ``--uneven-every`` steps the step runs as 4 simulated pods, pod 3 at
half speed: :class:`~repro_torch.runtime.UnevenBatchPlanner` splits the
batch's 4 microbatches, each pod accumulates its own
(:func:`~repro_torch.training.local_accum`), one
:func:`~repro_torch.training.weighted_combine` joins them and the pods'
simulated times feed the planner back.  With 4 microbatches and at least
one per pod, the split stays [1, 1, 1, 1].

**Restart.**  A checkpoint is written every 100 steps
(``--ckpt-dir``, by default ``repro_torch_100m`` in the temporary
directory, never the reference's, whose ``data_step`` means another
thing); a relaunch with the same ``--steps`` resumes from the last one
and trains on the batches an uninterrupted run trains on.  The checkpoint
records the number of batches the training consumed, as
``repro_torch.launch.train`` does; the reference records its stream's own
counter, which the prefetch thread has already moved ahead, so its
resumed run skips batches.  The schedule's length is ``--steps``, as in
the reference: a run relaunched with another ``--steps`` trains on
another learning-rate schedule.  The pod planner starts afresh at a
restart, as the reference's does.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig, Prefetcher, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.examples import seeded_params
from repro_torch.runtime import DeviceRuntime, UnevenBatchPlanner
from repro_torch.training import (
    AdamWConfig, init_opt_state, make_train_step, local_accum,
    weighted_combine, adamw_update,
)

__all__ = ["CFG", "POD_SPEED", "build_parser", "train", "main"]

CFG = ModelConfig(
    name="llama-100m", family="dense", n_layers=12, d_model=512,
    n_heads=8, n_kv_heads=4, d_ff=2048, vocab_size=8192,
    dtype="float32",
)
# 4 simulated pods, pod 3 at half speed
POD_SPEED = np.array([1.0, 1.0, 1.0, 0.5])


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train llama-100m with "
                                             "checkpoint/restart and uneven "
                                             "DP.")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_100m"))
    ap.add_argument("--uneven-every", type=int, default=0,
                    help="if >0, run the paper's uneven-DP step every N steps"
                         " (simulating 4 pods, one 2x slower)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, the plain PyTorch path")
    return ap


def train(args, *, params: Optional[dict] = None,
          record: Optional[list] = None) -> Iterator[str]:
    """Run the training ``args`` ask for, yielding the example's lines as
    they happen.  ``params`` replaces the seeded initial weights;
    ``record``, a list, receives ``(step, loss, seconds)`` for every step.
    A step's checkpoint is written before its line is yielded, so a caller
    that stops after a checkpoint step's line leaves the run as a crash
    right after that checkpoint would."""
    device = resolve_device(args.device)
    yield f"[100m] params: {CFG.param_count() / 1e6:.0f}M"
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=30, total_steps=args.steps)
    data = SyntheticLM(DataConfig(vocab_size=CFG.vocab_size, seq_len=128,
                                  global_batch=16, microbatch=4))
    params = seeded_params(CFG, device, params)
    opt = init_opt_state(params, opt_cfg)
    start = 0
    last_ck = latest_step(args.ckpt_dir)
    if last_ck is not None:
        tree, meta = restore(args.ckpt_dir, last_ck, {"p": params, "o": opt},
                             device=device)
        params, opt = tree["p"], tree["o"]
        start = last_ck
        data.seek(meta["extra"]["data_step"])
        yield f"[100m] resumed at step {start}"
    data_start = data.step

    step_fn = make_train_step(CFG, opt_cfg)
    it = Prefetcher(iter(data), depth=2)

    # Paper adaptation: 4 simulated pods, pod 3 runs at half speed.
    pod_rt = DeviceRuntime(n_slices=4, alpha=0.3)
    planner = UnevenBatchPlanner(pod_rt)

    try:
        t0 = time.perf_counter()
        for step in range(start, args.steps):
            t_step = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in next(it).items()}
            if args.uneven_every and (step + 1) % args.uneven_every == 0:
                plan = planner.plan(batch["tokens"].shape[0])
                shards, cursor = [], 0
                for c in plan.counts:
                    shards.append({k: v[cursor:cursor + c]
                                   for k, v in batch.items()})
                    cursor += int(c)
                grads, losses = [], []
                for shard in shards:
                    l, g = local_accum(CFG, params, shard)
                    losses.append(float(l))
                    grads.append(g)
                g = weighted_combine(grads, plan.counts)
                params, opt, m = adamw_update(opt_cfg, params, g, opt)
                planner.report(plan, plan.counts / POD_SPEED)  # simulated
                loss = float(np.average(losses, weights=plan.weights))
                extra = f" uneven counts={plan.counts.tolist()}"
            else:
                params, opt, m = step_fn(params, opt, batch)
                loss = float(m["loss"])
                extra = ""
            if record is not None:
                record.append((step + 1, loss, time.perf_counter() - t_step))
            if (step + 1) % 100 == 0:
                save(args.ckpt_dir, step + 1, {"p": params, "o": opt},
                     extra={"data_step": data_start + step + 1 - start})
            if (step + 1) % 25 == 0:
                yield f"[100m] step {step + 1:4d} loss={loss:.4f}{extra}"
        yield (f"[100m] {args.steps - start} steps in "
               f"{time.perf_counter() - t0:.1f}s")
    finally:
        it.close()


def main(argv: Optional[list] = None, *, params: Optional[dict] = None,
         record: Optional[list] = None) -> list:
    """Print the example's lines as they happen; returns them."""
    args = build_parser().parse_args(argv)
    lines = []
    for line in train(args, params=params, record=record):
        print(line, flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
