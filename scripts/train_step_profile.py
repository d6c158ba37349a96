#!/usr/bin/env python3
"""Where the time of ``repro_torch.examples.train_100m``'s step goes, on one
NVIDIA GPU.

    python3 scripts/train_step_profile.py [--steps N] [--out FILE.json]

llama-100m (the example's ``CFG``: 12 layers, d 512, f32, 56M
parameters), one 16 x 128-token batch in 4 microbatches, the example's
eager ``make_train_step`` with its AdamW settings; weights from seed 0 on
the CPU.  With deterministic algorithms off, then on (as ``chip_smoke.py``
phase 16 trains), then off again: the wall step (host clock to
``torch.cuda.synchronize()``, mean of ``--steps``), then 2 steps under
``torch.profiler``: the device's busy time per step, the kernel launches
per step (``cudaLaunchKernel`` calls), the device's events per step and
the operators with the most device and host time.  Prints the card's name
and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.examples import train_100m  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.training import (AdamWConfig, init_opt_state,  # noqa: E402
                                  make_train_step)
from repro_torch.tree import tree_map  # noqa: E402

LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_step_profile: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = train_100m.CFG
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=30, total_steps=300)
    params = tree_map(lambda t: t.cuda(), init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    opt = init_opt_state(params, opt_cfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                  global_batch=16, microbatch=4))
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in next(iter(data)).items()}
    step = make_train_step(cfg, opt_cfg)
    rows = []
    for det in (False, True, False):
        torch.use_deterministic_algorithms(det)
        for _ in range(3):
            params, opt, m = step(params, opt, batch)
            float(m["loss"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            params, opt, m = step(params, opt, batch)
            float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / args.steps * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                params, opt, m = step(params, opt, batch)
                float(m["loss"])
            torch.cuda.synchronize()
        ka = prof.key_averages()
        # the device's own events (kernels, copies, memsets), each once
        device = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in device) / 2 / 1e3
        launches = sum(e.count for e in ka if e.key in LAUNCHES) / 2
        row = {"deterministic": det, "wall_ms": wall_ms,
               "device_busy_ms": busy_ms, "launches": launches,
               "device_events": len(device) / 2,
               "host_us_per_launch": wall_ms * 1e3 / launches}
        rows.append(row)
        print(f"deterministic={det}: wall step {wall_ms:.2f} ms (mean of "
              f"{args.steps}), device busy {busy_ms:.2f} ms/step "
              f"({busy_ms / wall_ms:.3f}), {launches:.0f} launches/step, "
              f"{row['device_events']:.0f} device events/step, "
              f"{row['host_us_per_launch']:.1f} us of wall per launch",
              flush=True)
        print(ka.table(sort_by="self_cuda_time_total", row_limit=10,
                       max_name_column_width=60), flush=True)
        print(ka.table(sort_by="self_cpu_time_total", row_limit=10,
                       max_name_column_width=60), flush=True)
    torch.use_deterministic_algorithms(False)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
