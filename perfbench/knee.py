"""Find the knee of an open-loop cell: the highest arrival rate at which the
backlog does not grow over the window.

  python3 perfbench/knee.py --workload <name> --seeds <n>,<n>,... \\
      --seconds <s> --rates 1.0,1.5,2.0

One process builds the cell's system once (weights from the first seed)
and serves the cell's traffic at each rate and each seed's rotation of
it in turn (each run's requests followed to their end before the next),
printing one JSON line per run: requests due, the backlog (requests
waiting or prefilling) averaged over the window's first and last thirds
and at its close, the time to first token of the requests due in each
third, the live rows of the decode steps (mean and most), and the
prefill lane's load: chunks per request and seconds per chunk iteration,
whose product's inverse is the rate the one lane can serve.  The cell's traffic file then takes a fixed
rate below the knee; the benchmark's runs never search.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def thirds(pairs, seconds):
    """Mean of the values of (window second, value) pairs in the first and
    the last third of the window."""
    out = []
    for lo, hi in ((0.0, seconds / 3), (2 * seconds / 3, seconds)):
        v = [x for t, x in pairs if lo <= t < hi]
        out.append(sum(v) / len(v) if v else None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/knee.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)

    import torch

    from perfbench.harness import endtoend, spec, system
    from perfbench.harness.driver import Driver
    from perfbench.harness.traffic import load_kind

    cell = spec.load_cell(args.workload)
    seeds = [int(x) for x in args.seeds.split(",")]
    if not torch.cuda.is_available():
        print("[knee] needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cfg = system.port_config(cell.config)
    params = system.weights_for(cfg, seeds[0], device)
    sut = system.build(cell, cfg, params, device, seeds[0])
    system.warm_up(sut, int(cell.traffic["prefill_chunk"]),
                   int(cell.traffic["prefill_lanes"]), seeds[0])
    eng = sut.engine
    runs = [(float(r), s) for r in args.rates.split(",") for s in seeds]
    for rate, seed in runs:
        traffic = dict(cell.traffic, rate=rate)
        gen = load_kind(traffic["kind"])(traffic, seed, cfg.vocab_size,
                                         args.seconds)
        d = Driver(sut, gen)
        backlog = []

        def sample(drv):
            backlog.append((drv.clock() - drv.origin,
                            eng.n_waiting + eng.n_prefilling))

        d.window(args.seconds, on_iter=sample)
        at_close = eng.n_waiting + eng.n_prefilling
        d.follow_through(limit_s=300.0)
        due = [r for r in d.requests if r.due is not None]
        ttft = endtoend.ttfts(due, d.origin, args.seconds)
        per = [(r.due, t) for r, t in zip(due, ttft)]
        window = d.window_iters()
        live = [len(it.decode_ctx) for it in window if it.rows]
        chunks = [it.t1 - it.t0 for it in window if it.prefill is not None]
        print(json.dumps({
            "rate": rate, "seed": seed, "due": len(due),
            "backlog_thirds": thirds(backlog, args.seconds),
            "backlog_at_close": at_close,
            "ttft_thirds_s": thirds(per, args.seconds),
            "ttft_p50_s": endtoend.percentile(ttft, 50),
            "ttft_p90_s": endtoend.percentile(ttft, 90),
            "ttft_p95_s": endtoend.percentile(ttft, 95),
            "tpot_p99_ms": endtoend.tpot_p99_ms(d.requests, d.origin,
                                                d.close),
            "live_rows_mean": sum(live) / len(live) if live else 0.0,
            "live_rows_max": max(live, default=0),
            "chunks_per_request": len(chunks) / max(1, len(due)),
            "chunk_iter_s": sum(chunks) / len(chunks) if chunks else None,
            "chunk_share": sum(chunks) / args.seconds,
            "late_max_s": max(d.late) if d.late else 0.0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
