#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on one NVIDIA GPU.

    python3 chip_smoke.py [--out DETAIL.json] [--phases all|kernels]

Phases, in order; any failure raises and the script exits non-zero:

1. Header: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the time to build the CUDA kernels from this checkout
   (one nvcc per source, all started together).
2. Every kernel of the main paths against its plain torch version on the
   card: ``q4_matmul`` within the reference's tolerances of
   ``q4_matmul_plain`` and ``q4_matmul_db`` bitwise equal to ``q4_matmul``,
   at the main path's (N, K) shapes and M in {1, 4, 8}, f32 and bf16
   (with each Q4 kernel's time at M = 8 over M = 1 and its time per decode
   step); ``int8_gemm`` bitwise equal to ``int8_gemm_plain`` at the same
   shapes for M in {1, 4, 8, 16, 17, 32, 64} (both sides of the kernel's
   M = 8 regime boundary), at the reference's ragged shape (100, 120, 200)
   and with N = 0.  Then each one's time (CUDA events over 100+ launches,
   rotating over weight copies larger than the 50 MB L2) beside its bound,
   and, for ``int8_gemm`` at M = 32 and 64, beside ``torch._int_mm`` (the
   one PyTorch call that computes the product; it takes only M > 16).
3. The main paths end to end at full width: the port's serve path on
   llama2-7b (all 32 layers, bf16, compiled trunk and head, random weights
   from seed 0), 1 replica, 4 slots, 8 requests of 64 prompt tokens and 32
   new tokens, prefill chunks of 8, virtual clock ultra-125h — with the Q4
   trunk (``q4_matmul_db``), the same traffic with the Q4 trunk on the
   direct kernel (same tokens and timelines), and the same traffic with
   the int8 trunk (``int8_gemm``, 225 launches per trunk call).  Every
   launch count is set to 0 just before each run and read just after.
   Then, for the Q4 and the int8 run, the wall-clock decode step
   (torch.cuda.synchronize) and a short profile of it.
4. Compiled against eager trunks at 2 layers of full width, for q4, int8
   and fp32: the same virtual timelines, the same tokens (q4, int8), and
   one projection of each kind bitwise equal (q4, int8) or within a stated
   tolerance (fp32).
5. Each main path against its plain path: one prefill chunk and one decode
   step at full width, through the kernels and through their plain torch
   versions: Q4 logits within a stated tolerance, int8 logits bitwise.
6. A JSON line with every kernel's numbers, then the device line.

``--phases kernels`` runs phases 1 and 2 only (every kernel against its
plain version, with times), then prints the device line: a quick check of
a change to any kernel.

It exits non-zero, printing no result, when torch.cuda.is_available() is
False or when the checkout's ``src/repro_torch`` is not beside it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bandwidth, float32
# outside the tensor cores (the Q4 kernels' f32 FMAs run there) and int8
# (the int8 kernel's operations, bounded against the card's int8 peak).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
INT8_OP_PER_S = 1979e12
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
I8_REPLACES = "src/repro/kernels/int8_gemm.py:79"
I8_SOURCE = "src/repro_torch/kernels/csrc/int8_gemm.cu"
I8_TIMED_M = (1, DECODE_M, 8, 32, 64)   # int8_gemm timed at these M
I8_CHECKED_M = (1, DECODE_M, 8, 16, 17, 32, 64)   # and held bitwise at these
LIBRARY_MS = (32, 64)   # torch._int_mm timed beside it (it takes M > 16)
PER_TRUNK_CALL = sum(s[3] for s in SHAPES)   # 225 launches per trunk call


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
def header(libs) -> dict:
    """The card, the versions, and every kernel library built from this
    checkout's sources: one nvcc per source, all started together."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"[smoke] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()})")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        built = list(pool.map(lambda lib: lib.compile_library(force=True),
                              libs))
    build_s = time.perf_counter() - t0
    for path, log in built:
        say(f"[smoke] built {path.name} (nvcc sm_90a)")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"[smoke]   ptxas: {line.strip()}")
    say(f"[smoke] {len(libs)} kernel libraries built in parallel in "
        f"{build_s:.2f} s")
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
        for m, dt in [(m, dt) for dt in (torch.float32, torch.bfloat16)
                      for m in (1, DECODE_M, 8)]:
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
                f"  bound {bnd * 1e3:6.2f} us ({by})  time/bound direct "
                f"{t_direct / bnd:.2f} db {t_db / bnd:.2f}  library: none")
        del banks, qw
    torch.cuda.empty_cache()
    q4_summary(rows)
    return {"rows": rows, "max_abs_err": worst}


def q4_summary(rows) -> None:
    """Each kernel's f32 time at M = 8 over its time at M = 1 per shape, and
    its time per decode step (the 225 launches at M = 4) beside the bound."""
    f32 = {(r["shape"], r["m"]): r for r in rows if r["dtype"] == "float32"}
    for name in KERNELS:
        key = name + "_ms"
        ratios = "  ".join(
            f"{label} {f32[label, 8][key] / f32[label, 1][key]:.2f}"
            for label, *_ in SHAPES)
        step = sum(f32[label, DECODE_M][key] * per
                   for label, _, _, per in SHAPES)
        bound = sum(f32[label, DECODE_M]["bound_ms"] * per
                    for label, _, _, per in SHAPES)
        say(f"[smoke] {name}: time M=8 / M=1: {ratios}; decode step "
            f"({PER_TRUNK_CALL} launches, M={DECODE_M}, f32) {step:.3f} ms, "
            f"bound {bound:.3f} ms, time/bound {step / bound:.2f}")


def i8_bound_ms(m: int, n: int, k: int) -> tuple:
    """(bound in ms, "bytes" | "operations") of one u8 x s8 product: w, a
    and the s32 output each moved once over HBM, against 2*M*N*K int8
    operations at the card's int8 peak."""
    t_bytes = (n * k + m * k + 4 * m * n) / HBM_BYTES_PER_S
    t_ops = 2.0 * m * n * k / INT8_OP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def int8_library(a_s8, w_s8, corr):
    """The yardstick: one ``torch._int_mm`` (s8 x s8 -> s32, cuBLASLt)
    on a - 128 as s8, plus the 128 * colsum(w) correction
    (a . w = (a - 128) . w + 128 * sum(w))."""
    return torch._int_mm(a_s8, w_s8.t()) + corr


def int8_vs_plain(i8) -> dict:
    """Phase 2 (int8): ``int8_gemm`` bitwise equal to ``int8_gemm_plain``
    at the main path's shapes for every M of I8_CHECKED_M, at the
    reference's ragged shape, at a ragged shape of the vector kernel, and
    with N = 0; then its times at I8_TIMED_M (with ``torch._int_mm`` beside
    it at LIBRARY_MS)."""
    gen = torch.Generator(device="cuda").manual_seed(2)

    def ints(m, n, k):
        a = torch.randint(0, 256, (m, k), generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.uint8)
        w = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
        return a, w

    for m, n, k in ((100, 120, 200), (3, 1000, 4112)):
        a, w = ints(m, n, k)
        got, want = i8.int8_gemm(a, w), i8.int8_gemm_plain(a, w)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"int8_gemm != plain at ragged ({m}, {n}, "
                                 f"{k}): max abs err "
                                 f"{(got - want).abs().max().item()}")
        say(f"[smoke] int8_gemm ragged M={m} N={n} K={k}: bitwise equal")
    a, w = ints(4, 0, 4096)
    before = i8.int8_gemm.launches
    empty = i8.int8_gemm(a, w)
    if tuple(empty.shape) != (4, 0) or i8.int8_gemm.launches != before:
        raise AssertionError("int8_gemm with N = 0 must return (4, 0) and "
                             "launch nothing")
    say("[smoke] int8_gemm N=0: empty result, no launch")

    rows, worst = [], 0
    for label, n, k, per_step in SHAPES:
        _, w = ints(1, n, k)
        copies = max(2, math.ceil(2 * L2_BYTES / w.numel()))
        banks = [w.clone() for _ in range(copies)]
        corr = 128 * torch.sum(w, dim=-1, dtype=torch.int32)[None, :]
        for m in I8_CHECKED_M:
            a, _ = ints(m, 0, k)
            got, want = i8.int8_gemm(a, w), i8.int8_gemm_plain(a, w)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            worst = max(worst, err)
            if not torch.equal(got, want):
                raise AssertionError(f"int8_gemm != plain at {label} M={m}: "
                                     f"max abs err {err}")
            if m not in I8_TIMED_M:
                say(f"[smoke] int8 {label:11s} N={n:5d} K={k:5d} M={m:2d} "
                    f"bitwise")
                continue
            sets = [(a, bank) for bank in banks]
            t_kernel = device_ms(i8.int8_gemm, sets, 200)
            t_plain = device_ms(i8.int8_gemm_plain, sets, 10)
            t_lib = None
            if m in LIBRARY_MS:
                a_s8 = (a ^ 0x80).view(torch.int8)      # a - 128 as s8
                if not torch.equal(int8_library(a_s8, w, corr), want):
                    raise AssertionError(f"torch._int_mm yardstick differs "
                                         f"at {label} M={m}")
                t_lib = device_ms(int8_library,
                                  [(a_s8, bank, corr) for bank in banks], 200)
            bnd, by = i8_bound_ms(m, n, k)
            rows.append({"shape": label, "n": n, "k": k, "m": m,
                         "per_decode_step": per_step, "max_abs_err": err,
                         "int8_gemm_ms": t_kernel, "plain_ms": t_plain,
                         "library_ms": t_lib, "bound_ms": bnd,
                         "bound_by": by})
            lib = (f"_int_mm {t_lib * 1e3:8.2f} us" if t_lib is not None
                   else "library: none at M <= 16")
            say(f"[smoke] int8 {label:11s} N={n:5d} K={k:5d} M={m:2d} "
                f"bitwise  kernel {t_kernel * 1e3:8.2f} us  plain "
                f"{t_plain * 1e3:9.1f} us  bound {bnd * 1e3:6.2f} us ({by})  "
                f"bound/kernel {bnd / t_kernel:.2f}  {lib}")
        del banks
    torch.cuda.empty_cache()
    int8_summary(rows)
    return {"rows": rows, "max_abs_err": worst}


def int8_summary(rows) -> None:
    """Per shape: the kernel's share of its bound at M = 4 and its time at
    M = 8 over M = 1; per decode step (225 launches) at each timed M: the
    kernel, its bound and, where it runs, ``torch._int_mm``."""
    at = {(r["shape"], r["m"]): r for r in rows}
    labels = [s[0] for s in SHAPES]

    def per_shape(fn) -> str:
        return "  ".join(f"{label} {fn(label):.2f}" for label in labels)

    shares = per_shape(lambda lab: at[lab, DECODE_M]["bound_ms"]
                       / at[lab, DECODE_M]["int8_gemm_ms"])
    flat = per_shape(lambda lab: at[lab, 8]["int8_gemm_ms"]
                     / at[lab, 1]["int8_gemm_ms"])
    say(f"[smoke] int8_gemm bound/kernel at M={DECODE_M}: {shares}; "
        f"time M=8 / M=1: {flat}")
    for m in I8_TIMED_M:
        step = {key: sum(at[label, m][key] * per
                         for label, _, _, per in SHAPES)
                for key in ("int8_gemm_ms", "bound_ms", "library_ms")
                if at[labels[0], m][key] is not None}
        line = (f"[smoke] int8_gemm decode step ({PER_TRUNK_CALL} launches, "
                f"M={m}): {step['int8_gemm_ms']:.3f} ms, bound "
                f"{step['bound_ms']:.3f} ms, bound/kernel "
                f"{step['bound_ms'] / step['int8_gemm_ms']:.2f}")
        if "library_ms" in step:
            ratios = per_shape(lambda lab: at[lab, m]["int8_gemm_ms"]
                               / at[lab, m]["library_ms"])
            ratio = step["int8_gemm_ms"] / step["library_ms"]
            line += (f"; torch._int_mm {step['library_ms']:.3f} ms, "
                     f"kernel/_int_mm {ratio:.2f} (per shape: {ratios})")
        say(line)


SERVE_ARGV = ["--arch", "llama2-7b", "--preset", "full", "--balanced-trunk",
              "--trunk-quant", "q4", "--replicas", "1", "--batch", "4",
              "--requests", "8", "--prompt-len", "64", "--steps", "32",
              "--prefill-chunk", "8", "--machine", "ultra-125h",
              "--device", "cuda"]


class Counts:
    """Every kernel wrapper's launch count: set to 0 and read together."""

    def __init__(self, q4, i8):
        self.q4, self.i8 = q4, i8

    def reset(self) -> None:
        self.q4.reset_launch_counts()
        self.i8.reset_launch_counts()

    def read(self) -> dict:
        return {"q4_matmul": self.q4.q4_matmul.launches,
                "q4_matmul_db": self.q4.q4_matmul_db.launches,
                "int8_gemm": self.i8.int8_gemm.launches}


def drive(counts, serve_mod, *, quant="q4", params=None,
          double_buffer=True) -> dict:
    """The port's serve path at full width (SERVE_ARGV with ``quant``),
    with every launch count set to 0 just before the run and read just
    after.  ``trunk_calls`` counts its trunk calls (one per prefill chunk
    and one per decode step), each 225 launches of the trunk's kernel."""
    argv = list(SERVE_ARGV)
    argv[argv.index("--trunk-quant") + 1] = quant
    args = serve_mod.build_parser().parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    t0 = time.perf_counter()
    run = serve_mod.serve(args, params=params, double_buffer=double_buffer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts.read()
    vocab = run.cfg.vocab_size
    for r in run.requests:
        if r.n_generated != args.steps or not all(0 <= t < vocab
                                                  for t in r.generated):
            raise AssertionError(f"request {r.request_id}: generated "
                                 f"{r.n_generated} tokens {r.generated[:4]}...")
    trunk_calls = (sum(1 for it in run.iterations if it.prefill_tokens)
                   + sum(1 for it in run.iterations if it.decode_tokens))
    return {"args": args, "run": run, "launches": launches,
            "trunk_calls": trunk_calls,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "serve_wall_s": wall}


def expect_launches(main: dict, kernel: str) -> None:
    """The run went through ``kernel`` and only through it: 225 launches
    per trunk call (224 projections of 32 layers and the head)."""
    got = main["launches"]
    want = PER_TRUNK_CALL * main["trunk_calls"]
    if got[kernel] <= 0 or got[kernel] != want:
        raise AssertionError(f"{kernel} launched {got[kernel]} times, expected "
                             f"{PER_TRUNK_CALL} x {main['trunk_calls']} "
                             f"trunk calls = {want}")
    others = {k: v for k, v in got.items() if k != kernel and v}
    if others:
        raise AssertionError(f"the {kernel} run launched {others}")


def serve_full_width(counts, serve_mod) -> dict:
    """Phase 3: the main path (compiled trunk on q4_matmul_db) at full
    width, then the same traffic with the trunk lowered onto the direct
    q4_matmul.  The two kernels are bitwise equal, so both runs must give
    the same tokens and the same virtual-clock timelines."""
    main = drive(counts, serve_mod)
    run = main["run"]
    for line in serve_mod.report_lines(main["args"], run):
        say(line)
    say(f"[smoke] main-path launches: {main['launches']} over "
        f"{main['trunk_calls']} trunk calls (serve wall "
        f"{main['serve_wall_s']:.1f} s incl. weight init + Q4 quantization)")
    expect_launches(main, "q4_matmul_db")
    say(f"[smoke] peak device memory {main['peak_bytes'] / 2**30:.2f} GiB")

    direct = drive(counts, serve_mod, params=run.engines[0].params,
                   double_buffer=False)
    say(f"[smoke] direct-kernel path launches: {direct['launches']} "
        f"(serve wall {direct['serve_wall_s']:.1f} s)")
    expect_launches(direct, "q4_matmul")
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
           "trunk_calls": main["trunk_calls"],
           "peak_bytes": main["peak_bytes"],
           "serve_wall_s": main["serve_wall_s"],
           "direct_serve_wall_s": direct["serve_wall_s"]}
    del direct
    torch.cuda.empty_cache()
    return out


def serve_int8(counts, serve_mod, params) -> dict:
    """Phase 3 (int8): the same traffic through the compiled int8 trunk at
    full width (every projection and the head one int8_gemm launch between
    u8 quantization and dequant), on the Q4 run's weights."""
    main = drive(counts, serve_mod, quant="int8", params=params)
    run = main["run"]
    for line in serve_mod.report_lines(main["args"], run):
        say(line)
    say(f"[smoke] int8-path launches: {main['launches']} over "
        f"{main['trunk_calls']} trunk calls (serve wall "
        f"{main['serve_wall_s']:.1f} s incl. int8 quantization)")
    expect_launches(main, "int8_gemm")
    say(f"[smoke] int8 run peak device memory "
        f"{main['peak_bytes'] / 2**30:.2f} GiB")
    return {"run": run, "launches": main["launches"]["int8_gemm"],
            "trunk_calls": main["trunk_calls"],
            "peak_bytes": main["peak_bytes"],
            "serve_wall_s": main["serve_wall_s"]}


def weight_bytes(trunk) -> int:
    """Bytes of every weight a trunk call streams (codes and scales; the
    int8 weights' column sums too)."""
    total = 0
    for layer in [l for ls in trunk.bank.values() for l in ls] + [trunk.head]:
        if hasattr(layer, "qw"):
            total += layer.qw.nbytes
        else:
            total += sum(t.numel() * t.element_size() for t in layer.w)
    return total


def decode_wall(run, Request, np_rng, label: str) -> dict:
    """Wall-clock decode steps of the served engine: 4 more requests (one
    prefill chunk each, 32 new tokens), every step timed between
    torch.cuda.synchronize() calls; the decode-only steps (all 4 slots
    running, no prefill chunk) are the decode-step time.  Attention covers
    the whole cache buffer whatever the context, so the short prompts do
    not shorten the step."""
    engine = run.engines[0]
    wbytes = weight_bytes(engine.balanced_trunk)
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
    say(f"[smoke] {label} decode step (4 slots, wall, median of "
        f"{len(times)}): "
        f"{step * 1e3:.2f} ms; weights {wbytes / 1e9:.3f} GB per step -> "
        f"{wbytes / step / 1e9:.1f} GB/s = {wbytes / step / HBM_BYTES_PER_S:.4f}"
        f" of 3.35 TB/s")
    return {"decode_step_ms": step * 1e3, "decode_steps": len(times),
            "weight_bytes_per_step": wbytes,
            "weight_gb_per_s": wbytes / step / 1e9}


def profile_decode(run, Request, np_rng, label: str) -> dict:
    """Device time by kernel over 3 decode-only steps (torch.profiler).
    Only the device's own events are summed (kernels, copies, memsets):
    an operator's device time is its kernels' time, counted once there."""
    from torch.autograd import DeviceType
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
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    avgs = [(name, us, n) for name, (us, n) in by_name.items()]
    total = sum(t for _, t, _ in avgs)  # microseconds
    say(f"[smoke] {label} profile of 3 decode steps: wall "
        f"{wall * 1e3:.1f} ms, "
        f"device busy {total / 1e3:.1f} ms "
        f"({total / 1e6 / wall if wall else 0:.3f} of wall)")
    top = sorted(avgs, key=lambda a: -a[1])[:8]
    for key, t, count in top:
        say(f"[smoke]   {t / 1e3:8.2f} ms  x{count:5d}  {key[:90]}")
    return {"profile_wall_ms": wall * 1e3, "device_busy_ms": total / 1e3,
            "top": [{"kernel": k, "device_ms": t / 1e3, "count": c}
                    for k, t, c in top]}


def main_path_vs_plain(run, forward, init_state, np_rng, label: str,
                       tol: float) -> dict:
    """Phase 5: one prefill chunk and one decode step at full width through
    the kernels and through their plain versions, from the same inputs.
    ``tol`` bounds max|diff| / max|logit|; 0 asks for bitwise equality."""
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
    res = {}
    for i, phase in enumerate(("prefill", "decode")):
        a, b = out[False][i], out[True][i]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"{label} {phase}: non-finite logits")
        rel = ((a - b).abs().max() / b.abs().max()).item()
        same = int(torch.argmax(a)) == int(torch.argmax(b))
        bitwise = torch.equal(a, b)
        say(f"[smoke] {label} main path vs plain, {phase}: max|diff| / "
            f"max|logit| = {rel:.3g} (tolerance {tol}), bitwise equal: "
            f"{bitwise}, argmax equal: {same}")
        if rel > tol or (tol == 0 and not bitwise):
            raise AssertionError(f"{label} {phase} logits differ by {rel} > "
                                 f"{tol}")
        res[phase] = rel
    return res


# Tolerance of the Q4 main path against its plain path: the kernel and its
# plain version sum each f32 product in a different order (~1e-6
# relative); the bf16 activations between layers round that to 2**-8
# relative wherever a value sits on a rounding edge, and 32 layers carry
# those flips to the logits.  Two orders of sums of the plain path itself
# (two K tiles) already differ by about 1e-2 of the logits' scale on a
# 32-layer bf16 model (tests/test_torch_model.py::
# test_order_of_sums_drift_at_depth, which holds that drift under half of
# this tolerance); a wrong kernel is off by O(1).  The int8 kernel's sums
# are exact integers and everything around it is the same torch code on
# the same inputs, so its path must equal its plain path bit for bit.
Q4_VS_PLAIN_TOL = 5e-2
INT8_VS_PLAIN_TOL = 0.0
# Eager fp32 shards against the compiled fp32 product: cuBLAS may sum a
# row shard in another order than the whole matrix (another kernel or
# split-K for another N), a few float32 ulps of a K-term sum; a wrong
# shard (missing or shifted rows) is off by O(1).
FP32_MODES_TOL = 1e-4


def slice_layers(params: dict, n: int) -> dict:
    """The first ``n`` layers of stacked per-period params (views)."""
    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        return tree[:n]
    return {**params, "period": [cut(p) for p in params["period"]]}


def eager_vs_compiled(params) -> dict:
    """Phase 4: compiled and eager trunks at 2 layers of full width, for
    each weight path, over 4 requests: the same virtual timelines, the
    same tokens (q4, int8), and one projection of each kind (attn_proj,
    mlp_up, mlp_down, head) bitwise equal (q4, int8) or within
    FP32_MODES_TOL of its scale (fp32)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import HybridKernelDispatcher
    from repro_torch.models import BalancedTrunk
    from repro_torch.serving import (ContinuousBatchingEngine,
                                     HybridPhaseCost, poisson_requests)

    cfg = dataclasses.replace(get_config("llama2-7b"), n_layers=2)
    params = slice_layers(params, cfg.n_layers)
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((DECODE_M, cfg.d_model), generator=gen, device="cuda")
    xff = torch.randn((DECODE_M, cfg.d_ff), generator=gen, device="cuda")
    kinds = (("attn_proj", "attn", "wq", x), ("mlp_up", "ffn", "wi", x),
             ("mlp_down", "ffn", "wo", xff))
    res = {}
    for quant in ("q4", "int8", "fp32"):
        runs = {}
        t0 = time.perf_counter()
        for mode in ("compiled", "eager"):
            disp = HybridKernelDispatcher.virtual(
                "ultra-125h", execute=mode == "eager", keep_stats=False)
            trunk = BalancedTrunk.from_params(cfg, params, disp, quant=quant,
                                              mode=mode, device="cuda")
            engine = ContinuousBatchingEngine(
                cfg, params, max_slots=4, max_seq=32, prefill_chunk=8,
                cost_model=HybridPhaseCost("ultra-125h"),
                balanced_trunk=trunk, device="cuda")
            reqs = poisson_requests(4, rate=50.0, vocab_size=cfg.vocab_size,
                                    prompt_len=16, max_new_tokens=8, seed=1)
            for r in reqs:
                engine.submit(r)
            engine.run_until_idle()
            runs[mode] = (trunk, reqs)
        (tc, rc), (te, re) = runs["compiled"], runs["eager"]
        for a, b in zip(rc, re):
            if any(getattr(a, f) != getattr(b, f) for f in
                   ("arrival_time", "admit_time", "first_token_time",
                    "finish_time")):
                raise AssertionError(f"{quant}: eager timeline of request "
                                     f"{a.request_id} differs")
        tokens_equal = all(a.generated == b.generated for a, b in zip(rc, re))
        if quant != "fp32" and not tokens_equal:
            raise AssertionError(f"{quant}: eager tokens differ from "
                                 f"compiled")
        offs = tc.compiled_refresh()
        errs = {}
        for kind, group, name, xin in kinds:
            a = te.projector(0, 1, group, "membw")(name, xin, None)
            b = tc.projector(0, 1, group, "membw", offsets=offs)(name, xin,
                                                                 None)
            errs[kind] = a, b
        errs["head"] = (te.apply_head(x, isa="membw"),
                        tc.apply_head(x, isa="membw", offsets=offs))
        out = {}
        for kind, (a, b) in errs.items():
            rel = ((a - b).abs().max() / b.abs().max()).item()
            if quant == "fp32" and rel > FP32_MODES_TOL:
                raise AssertionError(f"fp32 {kind}: eager vs compiled {rel}")
            if quant != "fp32" and not torch.equal(a, b):
                raise AssertionError(f"{quant} {kind}: eager != compiled "
                                     f"bitwise ({rel})")
            out[kind] = rel
        say(f"[smoke] {quant} eager vs compiled (2 layers, full width, 4 "
            f"requests): timelines equal, tokens equal: {tokens_equal}, "
            f"projections max rel diff {max(out.values()):.3g} "
            f"({'tolerance %g' % FP32_MODES_TOL if quant == 'fp32' else 'bitwise'})"
            f"  [{time.perf_counter() - t0:.1f} s]")
        res[quant] = {"tokens_equal": tokens_equal, "rel": out}
        del runs, tc, te
        torch.cuda.empty_cache()
    return res


def kernel_entries(phase2: dict, launches: dict, p2i8: dict,
                   i8_launches: int) -> list:
    """One entry per kernel: ``launches`` from its own path's serving run;
    ``ms``, ``plain_ms`` and ``bound_ms`` for one decode step's worth of its
    launches (225 at the main path's shapes, M = 4; f32 x for Q4)."""
    rows = [r for r in phase2["rows"]
            if r["m"] == DECODE_M and r["dtype"] == "float32"]
    per = (f"decode step: {sum(r['per_decode_step'] for r in rows)} "
           f"launches at M={DECODE_M}")
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
            "library_ms": None, "per": per})

    def step_sum(m, key):
        return sum(r[key] * r["per_decode_step"] for r in p2i8["rows"]
                   if r["m"] == m)

    t_bytes = sum((r["n"] * r["k"] + r["m"] * r["k"] + 4 * r["m"] * r["n"])
                  * r["per_decode_step"] for r in p2i8["rows"]
                  if r["m"] == DECODE_M) / HBM_BYTES_PER_S
    t_ops = sum(2.0 * r["m"] * r["n"] * r["k"] * r["per_decode_step"]
                for r in p2i8["rows"] if r["m"] == DECODE_M) / INT8_OP_PER_S
    entries.append({
        "name": "int8_gemm", "route": "cuda", "source": I8_SOURCE,
        "replaces": I8_REPLACES, "launches": int(i8_launches),
        "max_abs_err": p2i8["max_abs_err"],
        "ms": step_sum(DECODE_M, "int8_gemm_ms"),
        "plain_ms": step_sum(DECODE_M, "plain_ms"),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        # torch._int_mm takes only M > 16: no PyTorch call computes the
        # product at the serving path's M <= 8; at M = 32 and 64 it stands
        # below
        "library_ms": None, "per": per,
        **{f"at_m{m}": {"ms": step_sum(m, "int8_gemm_ms"),
                        "library_ms": step_sum(m, "library_ms"),
                        "library": "torch._int_mm on a - 128, + 128 * colsum"}
           for m in LIBRARY_MS}})
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--phases", choices=("all", "kernels"), default="all",
                    help="kernels: only the header and every kernel "
                         "against its plain version, with times (a quick "
                         "check of a kernel change); all (default): every "
                         "phase")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import int8_gemm as i8
    from repro_torch.kernels import q4_matmul as q4
    from repro_torch.kernels.compiled import q4_blocks
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import forward, init_state
    from repro_torch.quant.q4 import quantize_q4_0
    from repro_torch.serving import Request

    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 plain versions
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    counts = Counts(q4, i8)
    head = header([q4, i8])
    phase2 = kernels_vs_plain(q4, quantize_q4_0, q4_blocks)
    p2i8 = int8_vs_plain(i8)
    if args.phases == "kernels":
        say(f"[smoke] kernels only: {time.perf_counter() - t_all:.1f} s on "
            f"{head['card']}")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(
                {"card": head["card"], "build_s": head["build_s"],
                 "kernels": phase2["rows"],
                 "int8": {"kernels": p2i8["rows"]}}, indent=1))
        say(device_line())
        return 0
    phase3 = serve_full_width(counts, serve_mod)
    np_rng = np.random.default_rng(0)
    wall = decode_wall(phase3["run"], Request, np_rng, "q4")
    prof = profile_decode(phase3["run"], Request, np_rng, "q4")
    phase5 = main_path_vs_plain(phase3["run"], forward, init_state, np_rng,
                                "q4", Q4_VS_PLAIN_TOL)
    params = phase3["run"].engines[0].params
    p3i8 = serve_int8(counts, serve_mod, params)
    wall_i8 = decode_wall(p3i8["run"], Request, np_rng, "int8")
    prof_i8 = profile_decode(p3i8["run"], Request, np_rng, "int8")
    p5i8 = main_path_vs_plain(p3i8["run"], forward, init_state, np_rng,
                              "int8", INT8_VS_PLAIN_TOL)
    phase4 = eager_vs_compiled(params)
    entries = kernel_entries(phase2, phase3["launches"], p2i8,
                             p3i8["launches"])
    say(f"[smoke] total {time.perf_counter() - t_all:.1f} s on {head['card']}")
    if args.out:
        detail = {"card": head["card"], "build_s": head["build_s"],
                  "kernels": phase2["rows"], "launches": phase3["launches"],
                  "trunk_calls": phase3["trunk_calls"],
                  "peak_bytes": phase3["peak_bytes"],
                  "serve_wall_s": phase3["serve_wall_s"],
                  "report": phase3["run"].report.to_dict(),
                  "decode": wall, "profile": prof, "vs_plain": phase5,
                  "int8": {"kernels": p2i8["rows"],
                           "launches": p3i8["launches"],
                           "trunk_calls": p3i8["trunk_calls"],
                           "peak_bytes": p3i8["peak_bytes"],
                           "serve_wall_s": p3i8["serve_wall_s"],
                           "report": p3i8["run"].report.to_dict(),
                           "decode": wall_i8, "profile": prof_i8,
                           "vs_plain": p5i8},
                  "eager_vs_compiled": phase4}
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(detail, indent=1))
    say(json.dumps({"kernels": entries}))
    say(device_line())
    return 0


def device_line() -> str:
    return json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    raise SystemExit(main())
