#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on one NVIDIA GPU.

    python3 chip_smoke.py [--out DETAIL.json]

Phases, in order; any failure raises and the script exits non-zero:

1. Header: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the time to build the CUDA kernels from this checkout.
2. Every kernel of the main path against its plain torch version on the
   card, at the main path's (N, K) shapes and M in {1, 4, 8} (f32) plus one
   bf16 case: ``q4_matmul`` within the reference's tolerances of
   ``q4_matmul_plain``, ``q4_matmul_db`` bitwise equal to ``q4_matmul``;
   then each one's time (CUDA events over 100+ launches, rotating over
   weight copies larger than the 50 MB L2) beside its bound.
3. The main path end to end at full width: the port's serve path on
   llama2-7b (all 32 layers, bf16, Q4 compiled trunk and head, random
   weights from seed 0), 1 replica, 4 slots, 8 requests of 64 prompt tokens
   and 32 new tokens, prefill chunks of 8, virtual clock ultra-125h; then
   the same traffic with the trunk on the direct kernel, which must give
   the same tokens and timelines.  Every launch count is set to 0 just
   before each run and read just after.  Then the wall-clock decode step
   (torch.cuda.synchronize) and a short profile of it.
4. The main path against its plain path: one prefill chunk and one decode
   step at full width, through the kernels and through their plain torch
   versions, logits compared within a stated tolerance.
5. A JSON line with every kernel's numbers, then the device line.

It exits non-zero, printing no result, when torch.cuda.is_available() is
False or when the checkout's ``src/repro_torch`` is not beside it.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bandwidth and float32
# outside the tensor cores — the Q4 kernels' f32 FMAs run there.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
L2_BYTES = 50e6

# (label, N, K) of every Q4 projection the llama2-7b main path launches,
# with launches per decode step
SHAPES = (("q/k/v/o", 4096, 4096, 4 * 32), ("mlp up/gate", 11008, 4096, 2 * 32),
          ("mlp down", 4096, 11008, 32), ("head", 32000, 4096, 1))
DECODE_M = 4          # the engine decodes all 4 slots every step
F32_TOL = 2e-5        # the reference's kernel tolerances (tests/test_kernels.py)
BF16_TOL = 2e-2

KERNELS = {
    "q4_matmul": "src/repro/kernels/q4_matmul.py:216",
    "q4_matmul_db": "src/repro/kernels/q4_matmul.py:174",
}
SOURCE = "src/repro_torch/kernels/csrc/q4_matmul.cu"


def say(*parts) -> None:
    print(*parts, flush=True)


# --------------------------------------------------------------- timing --
def device_ms(fn, arg_sets, iters: int) -> float:
    """Mean device time of one ``fn(*args)`` over ``iters`` launches,
    cycling through ``arg_sets``.  A sleep kernel holds the stream while the
    host enqueues every launch, so the events bracket back-to-back device
    work, not host launch overhead."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e8))
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(m: int, n: int, k: int, itemsize: int = 4) -> tuple:
    """(bound in ms, "bytes" | "operations") of one Q4 product: weights,
    x and y each moved once over HBM, against 2*M*N*K f32 flops."""
    moved = n * k * 0.5625 + m * k * itemsize + m * n * itemsize
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = 2.0 * m * n * k / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------- phases --
def header(q4) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"[smoke] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()})")
    t0 = time.perf_counter()
    path, log = q4.compile_library(force=True)
    build_s = time.perf_counter() - t0
    say(f"[smoke] built {path.name} in {build_s:.2f} s (nvcc sm_90a)")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"[smoke]   ptxas: {line.strip()}")
    return {"card": card, "build_s": build_s}


def kernels_vs_plain(q4, quantize, q4_blocks) -> dict:
    """Phase 2: correctness and timing of both kernels at every shape."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, worst = [], 0.0
    for label, n, k, per_step in SHAPES:
        bk = q4_blocks(k)[2]
        w = torch.randn((n, k), generator=gen, device="cuda")
        qw = quantize(w)
        del w
        wbytes = qw.nbytes
        copies = max(2, math.ceil(2 * L2_BYTES / wbytes))
        banks = [type(qw)(qw.packed.clone(), qw.scales.clone())
                 for _ in range(copies)]
        cases = [(m, torch.float32) for m in (1, DECODE_M, 8)]
        if label == "q/k/v/o":
            cases.append((DECODE_M, torch.bfloat16))
        for m, dt in cases:
            x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
            a = q4.q4_matmul(x, qw, bk)
            b = q4.q4_matmul_db(x, qw, bk)
            p = q4.q4_matmul_plain(x, qw, bk)
            torch.cuda.synchronize()
            tol = F32_TOL if dt == torch.float32 else BF16_TOL
            err = (a.float() - p.float()).abs().max().item()
            if not torch.allclose(a.float(), p.float(), rtol=tol,
                                  atol=tol * k):
                raise AssertionError(
                    f"q4_matmul vs plain at {label} M={m} {dt}: max abs err "
                    f"{err} over rtol={tol}, atol={tol * k}")
            if not torch.equal(a, b):
                raise AssertionError(
                    f"q4_matmul_db != q4_matmul bitwise at {label} M={m} {dt}")
            if dt == torch.float32:
                worst = max(worst, err)
            sets = [(x, bank, bk) for bank in banks]
            t_direct = device_ms(q4.q4_matmul, sets, 200)
            t_db = device_ms(q4.q4_matmul_db, sets, 200)
            t_plain = device_ms(q4.q4_matmul_plain, sets, 10)
            bnd, by = bound_ms(m, n, k, x.element_size())
            row = {"shape": label, "n": n, "k": k, "m": m, "bk": bk,
                   "dtype": str(dt).replace("torch.", ""),
                   "per_decode_step": per_step, "max_abs_err": err,
                   "q4_matmul_ms": t_direct, "q4_matmul_db_ms": t_db,
                   "plain_ms": t_plain, "bound_ms": bnd, "bound_by": by}
            rows.append(row)
            say(f"[smoke] {label:11s} N={n:5d} K={k:5d} M={m} {row['dtype']:8s}"
                f" bk={bk:3d} err={err:.3g}  direct {t_direct * 1e3:8.2f} us"
                f"  db {t_db * 1e3:8.2f} us  plain {t_plain * 1e3:9.1f} us"
                f"  bound {bnd * 1e3:6.2f} us ({by})  db/bound "
                f"{bnd / t_db:.2f}  library: none")
        del banks, qw
    torch.cuda.empty_cache()
    return {"rows": rows, "max_abs_err": worst}


SERVE_ARGV = ["--arch", "llama2-7b", "--preset", "full", "--balanced-trunk",
              "--trunk-quant", "q4", "--replicas", "1", "--batch", "4",
              "--requests", "8", "--prompt-len", "64", "--steps", "32",
              "--prefill-chunk", "8", "--machine", "ultra-125h",
              "--device", "cuda"]


def drive(q4, serve_mod, *, params=None, double_buffer=True) -> dict:
    """The port's serve path at full width (SERVE_ARGV), with every launch
    count set to 0 just before the run and read just after."""
    args = serve_mod.build_parser().parse_args(SERVE_ARGV)
    torch.cuda.reset_peak_memory_stats()
    q4.reset_launch_counts()
    t0 = time.perf_counter()
    run = serve_mod.serve(args, params=params, double_buffer=double_buffer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"q4_matmul": q4.q4_matmul.launches,
                "q4_matmul_db": q4.q4_matmul_db.launches}
    vocab = run.cfg.vocab_size
    for r in run.requests:
        if r.n_generated != args.steps or not all(0 <= t < vocab
                                                  for t in r.generated):
            raise AssertionError(f"request {r.request_id}: generated "
                                 f"{r.n_generated} tokens {r.generated[:4]}...")
    return {"args": args, "run": run, "launches": launches,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "serve_wall_s": wall}


def serve_full_width(q4, serve_mod) -> dict:
    """Phase 3: the main path (compiled trunk on q4_matmul_db) at full
    width, then the same traffic with the trunk lowered onto the direct
    q4_matmul.  The two kernels are bitwise equal, so both runs must give
    the same tokens and the same virtual-clock timelines."""
    main = drive(q4, serve_mod)
    run = main["run"]
    for line in serve_mod.report_lines(main["args"], run):
        say(line)
    say(f"[smoke] main-path launches: {main['launches']} (serve wall "
        f"{main['serve_wall_s']:.1f} s incl. weight init + Q4 quantization)")
    if main["launches"]["q4_matmul_db"] <= 0:
        raise AssertionError("the main path never launched q4_matmul_db")
    say(f"[smoke] peak device memory {main['peak_bytes'] / 2**30:.2f} GiB")

    direct = drive(q4, serve_mod, params=run.engines[0].params,
                   double_buffer=False)
    say(f"[smoke] direct-kernel path launches: {direct['launches']} "
        f"(serve wall {direct['serve_wall_s']:.1f} s)")
    if direct["launches"]["q4_matmul"] <= 0:
        raise AssertionError("the direct-kernel path never launched q4_matmul")
    for a, b in zip(run.requests, direct["run"].requests):
        if a.generated != b.generated or a.finish_time != b.finish_time:
            raise AssertionError(
                f"request {a.request_id}: direct-kernel run differs from the "
                f"double-buffered run ({a.generated[:4]} vs "
                f"{b.generated[:4]}...)")
    say("[smoke] direct-kernel run: same tokens and timelines as the main "
        "path")
    launches = {"q4_matmul": direct["launches"]["q4_matmul"],
                "q4_matmul_db": main["launches"]["q4_matmul_db"]}
    out = {"run": run, "launches": launches,
           "peak_bytes": main["peak_bytes"],
           "serve_wall_s": main["serve_wall_s"],
           "direct_serve_wall_s": direct["serve_wall_s"]}
    del direct
    torch.cuda.empty_cache()
    return out


def decode_wall(run, Request, np_rng) -> dict:
    """Wall-clock decode steps of the served engine: 4 more requests (one
    prefill chunk each, 32 new tokens), every step timed between
    torch.cuda.synchronize() calls; the decode-only steps (all 4 slots
    running, no prefill chunk) are the decode-step time.  Attention covers
    the whole cache buffer whatever the context, so the short prompts do
    not shorten the step."""
    engine = run.engines[0]
    trunk = engine.balanced_trunk
    wbytes = sum(layer.qw.nbytes for layers in trunk.bank.values()
                 for layer in layers) + trunk.head.qw.nbytes
    for _ in range(4):
        engine.submit(Request(
            prompt=np_rng.integers(0, run.cfg.vocab_size, 8,
                                   dtype=np.int32),
            max_new_tokens=32, arrival_time=engine.now))
    times = []
    while engine.has_work:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = engine.step()
        torch.cuda.synchronize()
        if st.prefill_tokens == 0 and st.decode_tokens == 4:
            times.append(time.perf_counter() - t0)
    if len(times) < 8:
        raise AssertionError(f"only {len(times)} decode-only steps")
    step = float(np.median(times))
    say(f"[smoke] decode step (4 slots, wall, median of {len(times)}): "
        f"{step * 1e3:.2f} ms; weights {wbytes / 1e9:.3f} GB per step -> "
        f"{wbytes / step / 1e9:.1f} GB/s = {wbytes / step / HBM_BYTES_PER_S:.4f}"
        f" of 3.35 TB/s")
    return {"decode_step_ms": step * 1e3, "decode_steps": len(times),
            "weight_bytes_per_step": wbytes,
            "weight_gb_per_s": wbytes / step / 1e9}


def profile_decode(run, Request, np_rng) -> dict:
    """Device time by kernel over 3 decode-only steps (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    engine = run.engines[0]
    for _ in range(4):
        engine.submit(Request(
            prompt=np_rng.integers(0, run.cfg.vocab_size, 8, dtype=np.int32),
            max_new_tokens=12, arrival_time=engine.now))
    while engine.n_running < 4 or engine.n_prefilling or engine.n_waiting:
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    engine.run_until_idle()
    avgs = [(e.key, getattr(e, "self_device_time_total", 0.0), e.count)
            for e in prof.key_averages()]
    total = sum(t for _, t, _ in avgs)  # microseconds
    say(f"[smoke] profile of 3 decode steps: wall {wall * 1e3:.1f} ms, "
        f"device busy {total / 1e3:.1f} ms "
        f"({total / 1e6 / wall if wall else 0:.3f} of wall)")
    top = sorted(avgs, key=lambda a: -a[1])[:8]
    for key, t, count in top:
        say(f"[smoke]   {t / 1e3:8.2f} ms  x{count:5d}  {key[:90]}")
    return {"profile_wall_ms": wall * 1e3, "device_busy_ms": total / 1e3,
            "top": [{"kernel": k, "device_ms": t / 1e3, "count": c}
                    for k, t, c in top]}


def main_path_vs_plain(run, forward, init_state, np_rng) -> dict:
    """Phase 4: one prefill chunk and one decode step at full width through
    the kernels and through their plain versions, from the same inputs."""
    engine = run.engines[0]
    cfg, params, trunk = run.cfg, engine.params, engine.balanced_trunk
    offsets = trunk.compiled_refresh()
    prompt = torch.as_tensor(
        np_rng.integers(0, cfg.vocab_size, (1, 8), dtype=np.int32),
        device="cuda")
    nxt = torch.as_tensor(
        np_rng.integers(0, cfg.vocab_size, (1, 1), dtype=np.int32),
        device="cuda")
    out = {}
    for plain in (False, True):
        state = init_state(cfg, 1, 16, device="cuda")
        logits = []
        for tokens, pos, isa, mode in ((prompt, 0, "avx_vnni", "last"),
                                       (nxt, 8, "membw", "all")):
            fo = forward(cfg, params, tokens, state=state,
                         pos_offset=torch.tensor(pos, device="cuda"),
                         logits_mode=mode, apply_head=False, trunk=trunk,
                         trunk_isa=isa, trunk_offsets=offsets, plain=plain)
            state = fo.state
            logits.append(trunk.apply_head(fo.logits[:, -1, :], isa=isa,
                                           offsets=offsets, plain=plain))
        out[plain] = [lg.float() for lg in logits]
    # Tolerance: the kernel and its plain version sum each f32 product in a
    # different order (~1e-6 relative); the bf16 activations between layers
    # round that to 2**-8 relative wherever a value sits on a rounding edge,
    # and 32 layers carry those flips to the logits.  Two orders of sums of
    # the plain path itself (two K tiles) already differ by about 1e-2 of
    # the logits' scale on a 32-layer bf16 model
    # (tests/test_torch_model.py::test_order_of_sums_drift_at_depth, which
    # holds that drift under half of this tolerance); a wrong kernel is off
    # by O(1).
    tol = 5e-2
    res = {}
    for i, phase in enumerate(("prefill", "decode")):
        a, b = out[False][i], out[True][i]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"{phase}: non-finite logits")
        rel = ((a - b).abs().max() / b.abs().max()).item()
        same = int(torch.argmax(a)) == int(torch.argmax(b))
        say(f"[smoke] main path vs plain, {phase}: max|diff| / max|logit| = "
            f"{rel:.3g} (tolerance {tol}), argmax equal: {same}")
        if rel > tol:
            raise AssertionError(f"{phase} logits differ by {rel} > {tol}")
        res[phase] = rel
    return res


def kernel_entries(phase2: dict, launches: dict) -> list:
    """One entry per kernel: ``launches`` from its own path's serving run;
    ``ms``, ``plain_ms`` and ``bound_ms`` for one decode step's worth of its
    launches (225 at the main path's shapes, M = 4, f32)."""
    rows = [r for r in phase2["rows"]
            if r["m"] == DECODE_M and r["dtype"] == "float32"]
    entries = []
    for name, replaces in KERNELS.items():
        ms = sum(r[f"{name}_ms"] * r["per_decode_step"] for r in rows)
        plain = sum(r["plain_ms"] * r["per_decode_step"] for r in rows)
        t_bytes = sum((r["n"] * r["k"] * 0.5625 + DECODE_M * (r["k"] + r["n"])
                       * 4) * r["per_decode_step"] for r in rows)
        t_ops = sum(2.0 * DECODE_M * r["n"] * r["k"] * r["per_decode_step"]
                    for r in rows)
        t_bytes /= HBM_BYTES_PER_S
        t_ops /= F32_FLOP_PER_S
        entries.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": int(launches[name]),
            "max_abs_err": phase2["max_abs_err"], "ms": ms,
            "plain_ms": plain, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "per": f"decode step: {sum(r['per_decode_step'] for r in rows)} "
                   f"launches at M={DECODE_M}"})
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import q4_matmul as q4
    from repro_torch.kernels.compiled import q4_blocks
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import forward, init_state
    from repro_torch.quant.q4 import quantize_q4_0
    from repro_torch.serving import Request

    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 plain versions
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    head = header(q4)
    phase2 = kernels_vs_plain(q4, quantize_q4_0, q4_blocks)
    phase3 = serve_full_width(q4, serve_mod)
    np_rng = np.random.default_rng(0)
    wall = decode_wall(phase3["run"], Request, np_rng)
    prof = profile_decode(phase3["run"], Request, np_rng)
    phase4 = main_path_vs_plain(phase3["run"], forward, init_state, np_rng)
    entries = kernel_entries(phase2, phase3["launches"])
    say(f"[smoke] total {time.perf_counter() - t_all:.1f} s on {head['card']}")
    if args.out:
        detail = {"card": head["card"], "build_s": head["build_s"],
                  "kernels": phase2["rows"], "launches": phase3["launches"],
                  "peak_bytes": phase3["peak_bytes"],
                  "serve_wall_s": phase3["serve_wall_s"],
                  "report": phase3["run"].report.to_dict(),
                  "decode": wall, "profile": prof, "vs_plain": phase4}
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(detail, indent=1))
    say(json.dumps({"kernels": entries}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
