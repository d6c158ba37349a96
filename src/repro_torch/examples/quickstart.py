"""Quickstart: the paper's dynamic scheduler in 40 lines, plus a tiny model
trained with the port's stack.  The port of ``examples/quickstart.py``.

  python -m repro_torch.examples.quickstart [--device cuda|cpu]

The scheduler line is on the machine model's virtual clock.  The training
runs reduced granite-8b for 30 steps through the eager
:func:`~repro_torch.training.make_train_step` with the reference's
defaults (no remat), on ``--device``; its weights come from a seeded
generator on the CPU, so the card and the CPU train the same model.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import reduced_config
from repro_torch.core import VirtualWorkerPool, make_machine
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.examples import seeded_params
from repro_torch.runtime import (CPURuntime, DynamicScheduler, KernelSpec,
                                 StaticScheduler)
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step

__all__ = ["demo_scheduler", "demo_training", "main"]

STEPS = 30


def demo_scheduler() -> str:
    """Fig. 2 in miniature: dynamic vs static INT8 GEMM on a hybrid CPU;
    returns the line to print."""
    gemm = KernelSpec(name="int8_gemm", isa="avx_vnni", granularity=16,
                      work_per_unit=2 * 1024 * 4096)
    machine = make_machine("ultra-125h")
    dyn = DynamicScheduler(CPURuntime(machine.n_cores, alpha=0.3),
                           VirtualWorkerPool(machine, isa="avx_vnni"))
    for _ in range(30):
        last = dyn.dispatch(gemm, 4096)
    static = StaticScheduler(VirtualWorkerPool(make_machine("ultra-125h"),
                                               isa="avx_vnni"))
    st = static.dispatch(gemm, 4096)
    return (f"[scheduler] static {st.makespan * 1e3:.2f} ms -> "
            f"dynamic {last.makespan * 1e3:.2f} ms "
            f"(+{(st.makespan / last.makespan - 1) * 100:.0f}%)")


def demo_training(device, params: Optional[dict] = None) -> dict:
    """Train a reduced granite-8b for 30 steps on synthetic data.

    ``params`` (a tree on any device, e.g. the reference's weights through
    :func:`~repro_torch.models.params_from_numpy`) replaces the seeded
    weights.  Returns ``{"line", "losses", "seconds"}``: the line to
    print, every step's loss and the 30 steps' wall time."""
    device = resolve_device(device)
    cfg = reduced_config("granite-8b")
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=STEPS)
    data = iter(SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                       global_batch=8, microbatch=4)))
    params = seeded_params(cfg, device, params)
    opt = init_opt_state(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg)
    losses = []
    t0 = time.perf_counter()
    for _ in range(STEPS):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in next(data).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    seconds = time.perf_counter() - t0
    return {"line": f"[training] loss {losses[0]:.3f} -> {losses[-1]:.3f} "
                    f"over {STEPS} steps",
            "losses": losses, "seconds": seconds}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="The dynamic scheduler and a "
                                             "tiny model trained.")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, the plain PyTorch path")
    return ap


def main(argv: Optional[list] = None, *,
         params: Optional[dict] = None) -> dict:
    """Print the scheduler line and the training line; returns
    ``{"scheduler": line, "training": demo_training's result}``."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    sched = demo_scheduler()
    print(sched)
    trained = demo_training(device, params=params)
    print(trained["line"])
    return {"scheduler": sched, "training": trained}


if __name__ == "__main__":
    main()
