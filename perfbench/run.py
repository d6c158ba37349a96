"""Run one cell of the benchmark once and print its result line.

  python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` (and with ``--trace 1``
a ``breakdown``), then ``checks``: each number compared beside its limit,
which are also the last lines of standard error.  Exits with 2, and prints
no result, without a CUDA device or with fewer than the cell asks for.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be >= 0")

    import torch

    from perfbench.harness import cell as cell_mod
    from perfbench.harness import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"[perfbench] {args.workload} needs {cell.chips} CUDA "
            f"device(s); torch.cuda.is_available()="
            f"{torch.cuda.is_available()}, device_count="
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    res = cell_mod.run(cell, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0), T0, log=log)
    leaked = cell_mod.forbidden_modules()
    if leaked:
        log(f"[perfbench] modules of JAX or the JAX package loaded: {leaked}")
        return 3
    for name, c in res["checks"].items():
        log(f"[perfbench] check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
