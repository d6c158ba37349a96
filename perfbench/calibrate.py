"""Readings for setting the limit of a cell's check: the cell run on
many seeds in one process, each with the float8 control read at the same
positions.

  python3 perfbench/calibrate.py --workload <name> --seconds <s> \\
      --seeds 101,102,...

Prints one JSON line per seed: the check's readings (the program's
``logit_gap`` and beside it the mean gap and the share of tokens that are
not the reference's best; the same for the control) and the run's
end-to-end metrics.  The benchmark's runs do not run the control.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)

    import torch

    from perfbench.harness import cell as cell_mod
    from perfbench.harness import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("[calibrate] needs a CUDA device", file=sys.stderr)
        return 2
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        res = cell_mod.run(cell, seed, args.seconds, False,
                           torch.device("cuda", 0), t0, control=True,
                           log=lambda *a: print(*a, file=sys.stderr))
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "run_s": time.perf_counter() - t0,
                          **res["readings"],
                          **{k: v["value"] for k, v in
                             res["metrics"].items()}}), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
