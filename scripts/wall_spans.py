"""A traced ``perfbench`` run of one cell with the engine's wall spans
recorded, and the device's idle time of the profiler slice laid under them.

    python3 scripts/wall_spans.py --workload <cell> --seed <n> \
        [--seconds 51] [--alternate] [--out chiprun_out/wall.json]

The run is the benchmark's own traced run (``perfbench/harness/cell.py``),
with a :class:`~repro_torch.obs.SpanTracer` installed as the wall tracer
(:func:`repro_torch.core.events.install_wall`) from the window's first
iteration to the close.  It prints, from the profiler slice of the
window's end:

* the device's idle ms under each ``prefill`` span (mean per chunk), under
  the decode lane's ``feedback`` and under ``decode.inputs`` +
  ``decode.launch`` (mean per decode step), and the mean ``queued`` span of
  the requests due in the window;
* the slice's idle seconds by the innermost span open over them, and the
  share of the idle time under a span other than ``iteration``;
* the device operations that start outside every ``iteration`` span by
  more than 0.1 ms (the clocks' agreement).

``--alternate`` installs the tracer on every other iteration of the window
instead and compares the mean host time of the decode-only iterations with
it and without it: the tracer's cost when on.

The readings stand in for per-layer metrics of the benchmark until its
harness reads the program's spans itself.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

SLACK_NS = 100_000          # 0.1 ms


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def idle_within(busy, start: int, end: int) -> int:
    """Idle ns inside ``[start, end)``, from the device's sorted disjoint
    ``busy`` intervals."""
    i = max(0, bisect.bisect_right(busy, (start, start)) - 1)
    covered = 0
    while i < len(busy) and busy[i][0] < end:
        covered += max(0, min(busy[i][1], end) - max(busy[i][0], start))
        i += 1
    return end - start - covered


def idle_by_span(spans, busy, lo: int, hi: int) -> dict:
    """Idle ns of ``[lo, hi)`` summed by the name of the innermost of
    ``spans`` (wall spans of one thread, nested) open over each idle ns;
    ``""`` where none is.  Spans with ``parent == 0`` and a request id (the
    requests' own tracks) are left out: they overlap the engine's."""
    engine = sorted((sp for sp in spans if sp.parent or sp.request is None),
                    key=lambda sp: (sp.start, -sp.end))
    # between two consecutive boundaries the innermost open span is the
    # deepest one on the stack
    marks = sorted({min(max(t, lo), hi) for t in
                    [lo, hi] + [t for sp in engine for t in (sp.start, sp.end)]
                    + [t for iv in busy for t in iv]})
    out: dict = {}
    stack: list = []
    j = 0
    for a, b in zip(marks, marks[1:]):
        while stack and stack[-1].end <= a:
            stack.pop()
        while j < len(engine) and engine[j].start <= a:
            sp = engine[j]
            j += 1
            if sp.end > a:
                while stack and stack[-1].end < sp.end:
                    stack.pop()
                stack.append(sp)
        idle = idle_within(busy, a, b)
        if idle:
            name = stack[-1].name if stack else ""
            out[name] = out.get(name, 0) + idle
    return out


def _recording_profiler(base, tracer, alternate: bool, kept: dict):
    """``perfbench``'s profiler slice, with ``tracer`` installed as the
    wall tracer over the window (or on its even iterations)."""
    from repro_torch.core import events

    class WallProfiler(base):
        def on_iter(self, d):
            super().on_iter(d)
            on = not alternate or len(d.iters) % 2 == 0
            events.install_wall(tracer if on else None)

        def reduce(self, d):
            events.install_wall(None)
            out = super().reduce(d)
            # not the driver itself: it holds the program, which the
            # check frees before it runs
            kept.update(slice=out[0], driver=SimpleNamespace(
                requests=d.requests, iters=d.iters, origin=d.origin,
                close=d.close))
            return out

    return WallProfiler


def analyse(sl, tracer, driver) -> dict:
    lo, hi = sl.start, sl.end
    busy = sl.busy_intervals()
    every = tracer.wall_spans()
    spans = [sp for sp in every if lo <= sp.start and sp.end <= hi]
    idle_ms = lambda sps: sum(idle_within(busy, sp.start, sp.end)
                              for sp in sps) * 1e-6
    chunks = [sp for sp in spans if sp.name == "prefill"]
    decodes = {sp.sid for sp in spans if sp.name == "decode"}
    lane = lambda name: [sp for sp in spans
                         if sp.name == name and sp.parent in decodes]
    out = {"slice_s": sl.window_s, "idle_s": sl.window_s - sl.busy_s,
           "chunks": len(chunks), "decode_steps": len(decodes)}
    if chunks:
        out["prefill_idle_ms"] = idle_ms(chunks) / len(chunks)
    if decodes:
        n = len(decodes)
        out["feedback_idle_ms"] = idle_ms(lane("feedback")) / n
        out["replay_idle_ms"] = (idle_ms(lane("decode.inputs"))
                                 + idle_ms(lane("decode.launch"))) / n
    # the requests due in the window, by the engine's id
    due = {r.request.request_id for r in driver.requests
           if r.due is not None and 0.0 <= r.due < driver.close - driver.origin}
    queued = [sp.ms for sp in every if sp.name == "queued"
              and sp.request in due]
    if queued:
        out["admit_wait_ms"] = statistics.mean(queued)
        out["admit_wait_requests"] = len(queued)
    by = idle_by_span(spans, busy, lo, hi)
    total = sum(by.values()) or 1
    out["idle_by_span_s"] = {k or "(none)": v * 1e-9 for k, v in
                             sorted(by.items(), key=lambda kv: -kv[1])}
    out["idle_under_a_span_share"] = sum(
        v for k, v in by.items() if k not in ("", "iteration")) / total
    # every device operation starts inside an iteration span: those that
    # do not, by name, with how far after the span's end (or before its
    # start, negative) they start
    its = [(sp.start, sp.end) for sp in spans if sp.name == "iteration"]
    outside = {}
    ops = [op for op in sl.device if lo <= op[1] <= hi]
    for name, s, _ in ops:
        d = min(((s - b if s > b else s - a if s < a else 0)
                 for a, b in its), key=abs, default=hi - lo)
        if abs(d) > SLACK_NS:
            outside.setdefault(name[:60], []).append(d * 1e-6)
    out["ops"] = len(ops)
    out["ops_outside_iteration"] = {k: [len(v), min(v), max(v)]
                                    for k, v in outside.items()}
    return out


def compare(driver) -> dict:
    """Mean host time of the window's decode-only iterations with the
    wall tracer installed (even) and without (odd)."""
    on, off = [], []
    for i, it in enumerate(driver.iters):
        if it.prefill is None and it.rows and \
                driver.origin <= it.t0 and it.t1 <= driver.close:
            (on if i % 2 == 0 else off).append(it.t1 - it.t0)
    if not on or not off:
        return {}
    m_on, m_off = statistics.mean(on), statistics.mean(off)
    return {"iterations_on": len(on), "iterations_off": len(off),
            "mean_on_ms": m_on * 1e3, "mean_off_ms": m_off * 1e3,
            "median_on_ms": statistics.median(on) * 1e3,
            "median_off_ms": statistics.median(off) * 1e3,
            "cost_share": m_on / m_off - 1.0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scripts/wall_spans.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--alternate", action="store_true")
    ap.add_argument("--root", default=str(ROOT),
                    help="the benchmark's root (BENCHMARK.json, perfbench/)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from perfbench.harness import cell as cell_mod
    from perfbench.harness import spec
    from repro_torch.obs import SpanTracer

    cell = spec.load_cell(args.workload, Path(args.root))
    tracer, kept = SpanTracer(), {}
    base = cell_mod.Profiler
    cell_mod.Profiler = _recording_profiler(base, tracer, args.alternate,
                                            kept)
    try:
        res = cell_mod.run(cell, args.seed, args.seconds, True,
                           torch.device(args.device), T0, log=log)
    finally:
        cell_mod.Profiler = base
    out = {"workload": args.workload, "seed": args.seed,
           "correct": res["correct"], "metrics": res["metrics"]}
    if args.alternate:
        out["alternate"] = compare(kept["driver"])
    else:
        out.update(analyse(kept["slice"], tracer, kept["driver"]))
    log(f"[wall] {json.dumps(out)}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
