#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on one NVIDIA GPU.

    python3 chip_smoke.py [--out DETAIL.json]
                          [--phases all|kernels|recurrent|train|shard|dryrun|tune|examples]

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
   Then the same checks at the zoo's new shapes (ZOO_SHAPES: the
   granite-moe head with N % 8 = 3 and its K = 1024 attention, chatglm3's
   N = 256 wk/wv, the K = 13696, 14336 and 24576 down projections) and
   at the recurrent archs' (RECURRENT_SHAPES: xlstm-1.3b's K = 2048 head,
   jamba-1.5-large's K = 8192 attention, d_ff 24576 FFN and 65536-row
   head), each kernel's time at M = 4 beside its bound.
3. The main paths end to end at full width: the port's serve path on
   llama2-7b (all 32 layers, bf16, compiled trunk and head, random weights
   from seed 0), 1 replica, 4 slots, 8 requests of 64 prompt tokens and 32
   new tokens, prefill chunks of 8, virtual clock ultra-125h — with the Q4
   trunk (``q4_matmul_db``), its decode step one captured CUDA graph; the
   same traffic uncaptured and with the Q4 trunk on the direct kernel
   (captured), each with the same tokens and timelines; and the same
   traffic with the int8 trunk (``int8_gemm``), captured and uncaptured.
   225 launches per trunk call, graph replays included.  Every launch
   count is set to 0 just before each run and read just after.  Then, for
   Q4 and int8, captured and uncaptured, the wall-clock decode step
   (torch.cuda.synchronize) split into the step body (the replay, by CUDA
   events), the pick and the cost-tape feedback with the offset refresh,
   and a short profile of it.
4. Each main path against its plain path: one prefill chunk and one decode
   step at full width, through the kernels and through their plain torch
   versions: Q4 logits within a stated tolerance, int8 logits bitwise.
5. Multi-lane prefill at full width: the same traffic with 4 prefill lanes
   of 8-token chunks (M = 32 at the kernels), Q4 and int8, each with the
   one-lane run's tokens (int8 exactly; Q4 where they part, at a logit gap
   within the Q4 tolerance), 225 launches per trunk call; one prefill
   chunk timed at 1 and 4 lanes.
6. ``--balanced-head`` and ``--legacy-batch`` at 2 layers of full width:
   the head as eager per-core Q4 shards (one ``q4_matmul`` launch per
   non-empty shard, bitwise equal to one launch over the head) over a
   captured dense step; one ``RoutedServer.serve_batch`` round.
7. Compiled against eager trunks at 2 layers of full width, for q4, int8
   and fp32: the same virtual timelines, the same tokens (q4, int8), and
   one projection of each kind bitwise equal (q4, int8) or within a stated
   tolerance (fp32).
8. The NUMA topology modes (``--topology``): the main traffic at full
   width on ``dual-125h`` with the Q4 trunk and on ``2s-12900k`` with the
   int8 trunk, socket-local, each captured and uncaptured with
   ``--trace``, ``--metrics`` and ``--flight-recorder`` on: the same tokens
   and timelines and the same trace, metrics and decision-ring files (the
   trace passes ``validate_trace``), 225 launches per trunk call, logits
   against the plain path (Q4 within the tolerance, int8 bitwise), and the
   captured decode step split into the replay, the pick and the two-level
   feedback (inner per-socket replays, outer socket report, offset
   refresh).  Then, at 2 layers of full width, eager against compiled
   topology trunks (q4, int8; both topologies): logits bitwise equal, one
   launch per non-empty core shard of both sockets, and the
   socket-oblivious baseline's tokens equal to socket-local ones.
9. ``--fleet`` at 2 layers of full width: the default fleet (6 engines on
   the card sharing one copy of the weights), 16 requests, twice with one
   seed (the same routing, requeues and node ratios) and once with
   ``--fleet-admission``; every request finishes or is shed, and the
   card's routing, requeues, sheds and node ratios equal the same runs
   with ``--device cpu``.
10. The zoo (phase 10): granite-8b (36 layers, 253 launches per trunk
   call) and granite-moe-1b-a400m (24 layers of 32 experts, top-8, 97
   launches per trunk call) at full width, bf16, seed 0, on the main
   traffic: Q4 captured and uncaptured (the same tokens and timelines),
   int8 captured (for the MoE uncaptured too, the same bits); each
   captured decode step split and profiled, with its weight bytes (and
   the MoE's expert bytes apart); logits against the plain path (int8
   bitwise; Q4 within the tolerance, for the MoE only reported with the
   share of top-k sets that part).  Then chatglm3-6b, starcoder2-15b,
   olmo-1b, internvl2-26b (behind a 256-token patch-embedding stub),
   musicgen-medium (on frame embeddings) and llama4-maverick (one period:
   a dense and an MoE layer of 128 experts) at 2 layers of full width: a
   prefill chunk and a decode step through the Q4 and int8 trunks against
   their plain versions, launches counted exactly.  llama2-7b's weights
   are freed first, and each model before the next.
11. The recurrent archs (phase 11): xlstm-1.3b whole (48 blocks, d 2048,
   4 heads, vocab 50304; mLSTM and sLSTM mixers in the captured graph, the
   head the trunk's one launch per call) at bf16, seed 0, on the main
   traffic: Q4 captured and uncaptured (the same tokens and timelines),
   int8 captured, and int8 with 4 prefill lanes (the one-lane tokens);
   each captured decode step split, profiled and set beside its three
   byte counts (kernel weights, in-graph mixer weights, recurrent state
   read and written); logits against the plain path (int8 bitwise, Q4
   within the tolerance).  Then jamba-1.5-large cut to 4 layers of full
   width — (mamba, dense), (mamba, moe), (mamba, dense), (attn, moe), the
   fewest that hold every pair it has — a prefill chunk and a decode step
   through the Q4 and int8 trunks against their plain versions (int8
   bitwise, Q4 reported), 11 launches per trunk call, and the peak memory.
12. Training (phase 12; no kernel is on its path, and its launches are
   held at 0): (a) olmo-1b at full width and depth (16 layers, d 2048,
   1.18 B parameters, bf16) through ``repro_torch.launch.train.main``, 4
   steps of 8 x 2048 tokens in 2 microbatches with remat: every loss
   finite, each wall step (torch.cuda.synchronize), tokens/s, peak memory,
   6·N·D over the step time as a share of the card's bf16 peak, and one
   step on fresh weights split by CUDA events into forward+backward and
   the optimizer; (b) one train step of olmo-1b, granite-moe-1b-a400m and
   xlstm-1.3b at 2 layers of full width in float32, on the card and on the
   CPU from the same weights: loss, grad norm and updated parameters
   within stated tolerances; (c) olmo-1b at 2 layers through ``main``: 4
   steps straight against 2 steps and 2 resumed from their checkpoint,
   under deterministic algorithms, bitwise, in a temporary directory
   removed afterwards, with the bytes written.
13. Sharding (phase 13; no kernel is on its path, and its launches are
   held at 0): an NCCL process group of world size 1 through the port's
   ``init_cluster`` (a file rendezvous under build/) and the (1, 1)
   ``("data", "model")`` mesh on the card.  (a) One train step of olmo-1b
   at 2 layers of full width in float32 on the mesh (DTensor parameters,
   optimizer state and batch by ``param_shardings``, ``opt_shardings`` and
   ``batch_shardings``, gradients constrained to ``grad_shardings``)
   against the plain step from the same weights and batch, with phase
   12's tolerances, and whether the two are bitwise equal; (b) olmo-1b
   whole (bf16, remat, 8 x 2048 tokens in 2 microbatches), 3 steps on the
   mesh: the steady wall step, the host's time to return from each step,
   tokens/s, peak memory and the ratio to phase 12's plain steady step;
   (c) the plain 2-layer step's checkpoint restored with ``shardings=``
   onto the mesh, bitwise equal to the plain restore.
14. The dry run (phase 14; no kernel is on its path, and its launches are
   held at 0), in a subprocess of its own, which traces on the host's CPU
   while phases 12 and 13 keep the card busy: (a) olmo-1b x train_4k at full
   width and depth traced by ``repro_torch.launch.dryrun`` on the 16x16
   production mesh of a fake process group of 256 ranks, on meta tensors:
   its JSON summary line (trace seconds, analytic FLOPs and HBM bytes, the
   wire bytes of the collectives it issued, the three roofline terms,
   the per-device peak bytes); (b) phase 12's own step (olmo-1b, 8 x 2048
   tokens in 2 microbatches, remat, a world of 1) dry-run: its predicted
   peak bytes, t_bound and t_compute beside phase 12's measured peak
   memory and steady step; (c) xlstm-1.3b cut to one period (8 layers,
   full width), its sharded train step at 16 x 128 tokens (two mLSTM
   chunks, on local shards) on the same mesh.  The subprocess must not
   have imported ``jax`` or ``repro``.
15. The measured loop and the analysis (run before phase 10, while
   llama2-7b is loaded): (a) every launch variant the kernel tuner
   chooses among — both Q4 entries, the int8 kernel's five x tiles — at
   llama2-7b's 4 distinct (N, K) and M = 1, 4, 8 (int8 also 32): bitwise
   equal to the default entry (Q4 within the tolerance of the plain
   version, int8 bitwise equal to it), each variant's time per launch
   beside its bound; (b) ``serve --machine wall --balanced-trunk
   --tuner-cache build/tuner.json`` at full width, Q4 and int8, on the
   main traffic's prompts prefilled in one chunk each with 16 new tokens,
   twice from an empty cache (the eager trunk's shards on 4 worker threads, each on
   its own CUDA stream, timed on the wall clock and tuned): the second run
   warm-starts; each request's tokens equal those of a captured virtual
   run of the same traffic, or part at a logit gap within the Q4
   tolerance (reported);
   one launch per non-empty shard; the wall decode step, the ratio spread
   per key and each shape class's chosen variant; (c) ``--balanced-head
   --machine wall`` the same way against a captured virtual
   ``--balanced-head`` run; (d) ``python -m repro_torch.analysis all
   --device cuda`` in a subprocess, exit 0 (JA001 under sync debug mode on
   llama2-7b's captured step at full width, races over the threaded CUDA
   dispatcher).
16. The examples (phase 16, after phase 14): the six modules of
   ``repro_torch.examples`` in process, each through its ``main`` on the
   card: (a) ``hybrid_cpu_inference``'s lines equal the reference's letter
   for letter (virtual clock); (b) ``quickstart``'s scheduler line the
   reference's, its 30 training steps of reduced granite-8b against a CPU
   run of the same module (first loss within 1e-5, last within the CPU
   test's 1e-3), their wall time; (c) ``q4_inference``: its kernel section
   through ``q4_matmul`` on the card against ``q4_matmul_plain`` within the
   reference's f32 tolerance, 7 matrices quantized, the tuner's 4 calls
   launching only ``q4_matmul``/``q4_matmul_db`` (5 launches in all,
   counted from 0), the chosen variant; (d) ``serve_batch`` and
   ``continuous_serving``: every line the reference's, the generated
   tokens against a CPU run's (a parting reported at its logit gap, not
   gated); (e) ``train_100m`` at its full width (llama-100m, 56M
   parameters, f32) under deterministic algorithms, in a temporary
   directory: run A ``--steps 125 --uneven-every 25`` straight, run B the
   same command relaunched on a directory holding A's step-100 checkpoint
   alone: B's losses of steps 101-125 bitwise A's, its step-125 line
   equal, every ``uneven counts=`` line the planner's on the pods'
   simulated speeds; A's steady step, tokens/s, 6·N·D over the step as a
   share of the f32 peak and peak memory.  No example but
   ``q4_inference`` launches a kernel, and each is held to 0.
17. A JSON line with every kernel's numbers, then the device line.

``--phases kernels`` runs phases 1 and 2 only (every kernel against its
plain version, with times), then prints the device line: a quick check of
a change to any kernel.  ``--phases recurrent`` runs phase 1, phase 2 at
the recurrent archs' shapes and phase 11; ``--phases train`` runs phases
1 and 12; ``--phases shard`` runs phases 1 and 13, (b) then timing 3
plain steps of its own for the ratio; ``--phases dryrun`` runs phases 1
and 14, with no phase 12 numbers beside (b); ``--phases tune`` runs phases
1 and 15; ``--phases examples`` runs phases 1 and 16.

Every figure of the machine model that the serve lines print (TTFT,
TPOT, ratio tables, socket splits, ``achieved_bw_frac``, GB/s of the
simulated sockets) is on the virtual clock, never a card figure.

It exits non-zero, printing no result, when torch.cuda.is_available() is
False or when the checkout's ``src/repro_torch`` is not beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
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


# (label, N, K) of the zoo's projections at shapes the llama2-7b path never
# launches: the granite-moe head (N % 8 = 3) and attention (K = 1024),
# chatglm3's wk/wv (N = 256), and three down projections (K = 13696,
# 14336, 24576)
ZOO_SHAPES = (("granite-moe head", 49155, 1024),
              ("granite-moe wq/wo", 1024, 1024),
              ("granite-moe wk/wv", 512, 1024),
              ("chatglm3 wk/wv", 256, 4096),
              ("chatglm3 down", 4096, 13696),
              ("granite-8b down", 4096, 14336),
              ("starcoder2 down", 6144, 24576))


# (label, N, K) of the recurrent archs' projections through the kernels:
# xlstm-1.3b's head (K = 2048), and jamba-1.5-large's attention (K = 8192,
# GQA kv 8), dense FFN (d_ff 24576) and head (vocab 65536)
RECURRENT_SHAPES = (("xlstm head", 50304, 2048),
                    ("jamba wq/wo", 8192, 8192),
                    ("jamba wk/wv", 1024, 8192),
                    ("jamba up/gate", 24576, 8192),
                    ("jamba down", 8192, 24576),
                    ("jamba head", 65536, 8192))


def zoo_kernels_vs_plain(q4, i8, quantize, q4_blocks,
                         shapes=ZOO_SHAPES, what="zoo shape") -> list:
    """Phase 2 (the zoo's shapes, or ``shapes``): both Q4 kernels within
    the reference's tolerances of their plain version and bitwise equal to
    each other at M in {1, 4, 8}, f32 and bf16; ``int8_gemm`` bitwise
    equal to its plain version at M in {1, 4, 8, 32}; and, at M = 4 (f32 x
    for Q4), each kernel's time beside its bound and its plain version's
    time."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for label, n, k in shapes:
        bk = q4_blocks(k)[2]
        w = torch.randn((n, k), generator=gen, device="cuda")
        qw = quantize(w)
        del w
        worst = 0.0
        for m, dt in [(m, dt) for dt in (torch.float32, torch.bfloat16)
                      for m in (1, DECODE_M, 8)]:
            x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
            a, b = q4.q4_matmul(x, qw, bk), q4.q4_matmul_db(x, qw, bk)
            p = q4.q4_matmul_plain(x, qw, bk)
            torch.cuda.synchronize()
            tol = F32_TOL if dt == torch.float32 else BF16_TOL
            err = (a.float() - p.float()).abs().max().item()
            if not torch.allclose(a.float(), p.float(), rtol=tol,
                                  atol=tol * k):
                raise AssertionError(f"q4_matmul vs plain at {label} M={m} "
                                     f"{dt}: max abs err {err}")
            if not torch.equal(a, b):
                raise AssertionError(f"q4_matmul_db != q4_matmul bitwise at "
                                     f"{label} M={m} {dt}")
            if dt == torch.float32:
                worst = max(worst, err)
        copies = max(2, math.ceil(2 * L2_BYTES / qw.nbytes))
        banks = [type(qw)(qw.packed.clone(), qw.scales.clone())
                 for _ in range(copies)]
        x = torch.randn((DECODE_M, k), generator=gen, device="cuda")
        sets = [(x, bank, bk) for bank in banks]
        t_direct = device_ms(q4.q4_matmul, sets, 200)
        t_db = device_ms(q4.q4_matmul_db, sets, 200)
        t_plain = device_ms(q4.q4_matmul_plain, sets, 10)
        bnd, by = bound_ms(DECODE_M, n, k)
        del banks, qw
        w8 = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                           dtype=torch.int32).to(torch.int8)
        for m in (1, DECODE_M, 8, 32):
            a8 = torch.randint(0, 256, (m, k), generator=gen, device="cuda",
                               dtype=torch.int32).to(torch.uint8)
            got, want = i8.int8_gemm(a8, w8), i8.int8_gemm_plain(a8, w8)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"int8_gemm != plain at {label} M={m}")
            if m == DECODE_M:
                i8_sets = [(a8, bank) for bank in [w8.clone() for _ in range(
                    max(2, math.ceil(2 * L2_BYTES / w8.numel())))]]
                t_i8 = device_ms(i8.int8_gemm, i8_sets, 200)
                t_i8_plain = device_ms(i8.int8_gemm_plain, i8_sets, 10)
                del i8_sets
        b8, by8 = i8_bound_ms(DECODE_M, n, k)
        del w8
        rows.append({"shape": label, "n": n, "k": k, "m": DECODE_M, "bk": bk,
                     "q4_max_abs_err": worst, "q4_matmul_ms": t_direct,
                     "q4_matmul_db_ms": t_db, "q4_plain_ms": t_plain,
                     "q4_bound_ms": bnd, "q4_bound_by": by,
                     "int8_gemm_ms": t_i8, "int8_plain_ms": t_i8_plain,
                     "int8_bound_ms": b8, "int8_bound_by": by8})
        say(f"[smoke] {what} {label:18s} N={n:5d} K={k:5d}: q4 within "
            f"tolerance (f32 err {worst:.3g}), db bitwise, int8 bitwise at "
            f"M=1,4,8,32; M={DECODE_M}: q4_matmul {t_direct * 1e3:7.2f} us, "
            f"q4_matmul_db {t_db * 1e3:7.2f} us, bound {bnd * 1e3:6.2f} us "
            f"({by}), time/bound {t_direct / bnd:.2f} / {t_db / bnd:.2f}, "
            f"plain {t_plain * 1e3:8.1f} us; int8_gemm {t_i8 * 1e3:7.2f} us,"
            f" bound {b8 * 1e3:6.2f} us ({by8}), bound/kernel "
            f"{b8 / t_i8:.2f}, plain {t_i8_plain * 1e3:8.1f} us")
    torch.cuda.empty_cache()
    return rows


SERVE_ARGV = ["--arch", "llama2-7b", "--preset", "full", "--balanced-trunk",
              "--trunk-quant", "q4", "--replicas", "1", "--batch", "4",
              "--requests", "8", "--prompt-len", "64", "--steps", "32",
              "--prefill-chunk", "8", "--machine", "ultra-125h",
              "--device", "cuda"]
LANES = 4             # prefill lanes of the multi-lane runs: M = 4 x 8 = 32
# where the topology phases write their trace, metrics and decision ring
OBS_DIR = Path(__file__).resolve().parent / "build" / "smoke_obs"
OBS_FILES = {"trace": "trace.json", "metrics": "metrics.prom",
             "flight_recorder": "recorder.json"}


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


def drive(counts, serve_mod, *, quant="q4", params=None, double_buffer=True,
          cuda_graph=True, lanes=1, topology=None, obs_dir=None,
          arch="llama2-7b") -> dict:
    """The port's serve path at full width (SERVE_ARGV with ``arch``,
    ``quant`` and ``lanes`` prefill lanes), with every launch count set to
    0 just before the run and read just after.  ``cuda_graph=False`` runs its decode
    steps uncaptured; ``topology`` serves on that NUMA topology (its
    flattened machine is the clock); ``obs_dir`` turns on ``--trace``,
    ``--metrics`` and ``--flight-recorder`` into that directory, as
    ``main()`` of the serve module does.  ``trunk_calls`` counts its trunk
    calls (one per prefill iteration and one per decode step), each
    ``per_trunk_call(cfg)`` launches of the trunk's kernel (225 for
    llama2-7b)."""
    argv = list(SERVE_ARGV)
    argv[argv.index("--arch") + 1] = arch
    argv[argv.index("--trunk-quant") + 1] = quant
    if topology is not None:
        at = argv.index("--machine")
        argv[at:at + 2] = ["--topology", topology]
    if obs_dir is not None:
        obs_dir.mkdir(parents=True, exist_ok=True)
        for flag, name in OBS_FILES.items():
            argv += [f"--{flag.replace('_', '-')}", str(obs_dir / name)]
    args = serve_mod.build_parser().parse_args(
        argv + ["--prefill-lanes", str(lanes)])
    observers = serve_mod.Observers(args)
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    t0 = time.perf_counter()
    try:
        run = serve_mod.serve(args, params=params,
                              double_buffer=double_buffer,
                              cuda_graph=cuda_graph)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts.read()
        if observers.registry is not None:
            run.report.publish(observers.registry)
    finally:
        obs_lines = observers.close()
    vocab = run.cfg.vocab_size
    for r in run.requests:
        if r.n_generated != args.steps or not all(0 <= t < vocab
                                                  for t in r.generated):
            raise AssertionError(f"request {r.request_id}: generated "
                                 f"{r.n_generated} tokens {r.generated[:4]}...")
    if run.engines[0].captured != cuda_graph:
        raise AssertionError(f"engine captured={run.engines[0].captured}, "
                             f"asked for cuda_graph={cuda_graph}")
    trunk_calls = (sum(1 for it in run.iterations if it.prefill_tokens)
                   + sum(1 for it in run.iterations if it.decode_tokens))
    return {"args": args, "run": run, "launches": launches,
            "trunk_calls": trunk_calls,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "serve_wall_s": wall, "obs_lines": obs_lines}


def expect_launches(main: dict, kernel: str,
                    per_call: int = PER_TRUNK_CALL) -> None:
    """The run went through ``kernel`` and only through it: ``per_call``
    launches per trunk call (llama2-7b: 224 projections of 32 layers and
    the head), graph replays included."""
    got = main["launches"]
    want = per_call * main["trunk_calls"]
    if got[kernel] <= 0 or got[kernel] != want:
        raise AssertionError(f"{kernel} launched {got[kernel]} times, expected "
                             f"{per_call} x {main['trunk_calls']} "
                             f"trunk calls = {want}")
    others = {k: v for k, v in got.items() if k != kernel and v}
    if others:
        raise AssertionError(f"the {kernel} run launched {others}")


def assert_same_run(a, b, what: str) -> None:
    """Two serving runs of the same traffic gave the same tokens, the same
    virtual timeline of every request and the same iterations."""
    fields = ("generated", "arrival_time", "admit_time", "first_token_time",
              "finish_time")
    for x, y in zip(a.requests, b.requests):
        for f in fields:
            if getattr(x, f) != getattr(y, f):
                raise AssertionError(f"{what}: request {x.request_id} "
                                     f"differs in {f}")
    steps = [[(i.prefill_tokens, i.decode_tokens, i.now) for i in r.iterations]
             for r in (a, b)]
    if steps[0] != steps[1]:
        raise AssertionError(f"{what}: the iterations differ")


def serve_full_width(counts, serve_mod) -> dict:
    """Phase 3: the main path (compiled trunk on q4_matmul_db, its decode
    step one CUDA graph) at full width; the same traffic uncaptured; and
    the same traffic with the trunk lowered onto the direct q4_matmul,
    captured.  The two kernels are bitwise equal and a replay computes
    what the uncaptured step does, so all three runs must give the same
    tokens and the same virtual-clock timelines."""
    main = drive(counts, serve_mod)
    run = main["run"]
    for line in serve_mod.report_lines(main["args"], run):
        say(line)
    graph = run.engines[0]._graph
    say(f"[smoke] main-path launches: {main['launches']} over "
        f"{main['trunk_calls']} trunk calls, {graph.replays} of them graph "
        f"replays of {sum(graph.launches)} launches each (serve wall "
        f"{main['serve_wall_s']:.1f} s incl. weight init + Q4 quantization)")
    expect_launches(main, "q4_matmul_db")
    say(f"[smoke] peak device memory {main['peak_bytes'] / 2**30:.2f} GiB")

    params = run.engines[0].params
    eager = drive(counts, serve_mod, params=params, cuda_graph=False)
    expect_launches(eager, "q4_matmul_db")
    assert_same_run(run, eager["run"], "q4 uncaptured vs captured")
    say(f"[smoke] q4 uncaptured run: same tokens, timelines and launches "
        f"({eager['launches']['q4_matmul_db']}) as the captured run (serve "
        f"wall {eager['serve_wall_s']:.1f} s against "
        f"{main['serve_wall_s']:.1f} s)")

    direct = drive(counts, serve_mod, params=params, double_buffer=False)
    say(f"[smoke] direct-kernel path launches: {direct['launches']} "
        f"(serve wall {direct['serve_wall_s']:.1f} s)")
    expect_launches(direct, "q4_matmul")
    assert_same_run(run, direct["run"], "direct-kernel vs double-buffered")
    say("[smoke] direct-kernel run (captured): same tokens and timelines as "
        "the main path")
    launches = {"q4_matmul": direct["launches"]["q4_matmul"],
                "q4_matmul_db": main["launches"]["q4_matmul_db"]}
    out = {"run": run, "eager_run": eager["run"], "launches": launches,
           "trunk_calls": main["trunk_calls"],
           "peak_bytes": main["peak_bytes"],
           "serve_wall_s": main["serve_wall_s"],
           "uncaptured_serve_wall_s": eager["serve_wall_s"],
           "direct_serve_wall_s": direct["serve_wall_s"]}
    del direct
    torch.cuda.empty_cache()
    return out


def serve_int8(counts, serve_mod, params) -> dict:
    """Phase 3 (int8): the same traffic through the compiled int8 trunk at
    full width (every projection and the head one int8_gemm launch between
    u8 quantization and dequant), on the Q4 run's weights, captured and
    uncaptured: the same tokens and timelines."""
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
    eager = drive(counts, serve_mod, quant="int8", params=params,
                  cuda_graph=False)
    expect_launches(eager, "int8_gemm")
    assert_same_run(run, eager["run"], "int8 uncaptured vs captured")
    say(f"[smoke] int8 uncaptured run: same tokens, timelines and launches "
        f"as the captured run (serve wall {eager['serve_wall_s']:.1f} s "
        f"against {main['serve_wall_s']:.1f} s)")
    return {"run": run, "eager_run": eager["run"],
            "launches": main["launches"]["int8_gemm"],
            "trunk_calls": main["trunk_calls"],
            "peak_bytes": main["peak_bytes"],
            "serve_wall_s": main["serve_wall_s"],
            "uncaptured_serve_wall_s": eager["serve_wall_s"]}


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


class FeedbackSplit:
    """The cost-tape feedback of a topology trunk split by the host clock,
    by wrapping methods on the instances: the inner per-socket replays
    (each socket dispatcher's ``dispatch``), the outer socket-level report
    (the rest of the two-level replay, ``_replay_topology``), and the
    offset refresh."""

    KEYS = ("inner_ms", "outer_ms", "refresh_ms")

    def __init__(self, trunk):
        ctx = trunk._compiled()
        self.acc = {"inner": 0.0, "replay": 0.0, "refresh": 0.0}
        self.targets = ([(d, "dispatch", "inner")
                         for d in ctx.dispatcher.socket_dispatchers]
                        + [(ctx, "_replay_topology", "replay"),
                           (ctx, "refresh", "refresh")])
        for obj, attr, name in self.targets:
            setattr(obj, attr, self._timed(name, getattr(obj, attr)))

    def _timed(self, name, fn):
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.acc[name] += time.perf_counter() - t0
        return timed

    def reset(self) -> None:
        self.acc = dict.fromkeys(self.acc, 0.0)

    def read(self) -> dict:
        a = self.acc
        return {"inner_ms": a["inner"] * 1e3,
                "outer_ms": (a["replay"] - a["inner"]) * 1e3,
                "refresh_ms": a["refresh"] * 1e3}

    def remove(self) -> None:
        for obj, attr, _ in self.targets:
            delattr(obj, attr)


class StepParts:
    """The parts of an engine's decode step, timed by wrapping its methods
    on the instance: the step body (the graph replay when captured, with
    its two small input copies) by CUDA events and by the host time it
    takes to enqueue; the pick on the host (its copy to the host waits for
    the body); and the cost-tape feedback with the offset refresh on the
    host (with ``split``, a :class:`FeedbackSplit`, that feedback's parts
    too)."""

    KEYS = ("body_ms", "enqueue_ms", "pick_ms", "feedback_ms")

    def __init__(self, engine, split=None):
        self.engine, self.rows, self.cur = engine, [], {}
        self.split = split
        if split is not None:
            self.KEYS = self.KEYS + split.KEYS
        decode, sample, feedback = (engine._decode, engine._sample,
                                    engine._feedback)

        def timed_decode():
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            t0 = time.perf_counter()
            out = decode()
            self.cur["enqueue_ms"] = (time.perf_counter() - t0) * 1e3
            e1.record()
            self.cur["events"] = (e0, e1)
            return out

        def timed_sample(logits, phase):
            t0 = time.perf_counter()
            out = sample(logits, phase)
            self.cur["pick_ms"] = (time.perf_counter() - t0) * 1e3
            return out

        def timed_feedback(recs):
            if split is not None:
                split.reset()
            t0 = time.perf_counter()
            feedback(recs)
            self.cur["feedback_ms"] = (time.perf_counter() - t0) * 1e3
            if split is not None:
                self.cur.update(split.read())

        engine._decode, engine._sample, engine._feedback = (
            timed_decode, timed_sample, timed_feedback)

    def start(self) -> None:
        self.cur = {}

    def keep(self) -> None:
        e0, e1 = self.cur.pop("events")
        self.cur["body_ms"] = e0.elapsed_time(e1)
        self.rows.append(self.cur)

    def remove(self) -> None:
        for name in ("_decode", "_sample", "_feedback"):
            delattr(self.engine, name)
        if self.split is not None:
            self.split.remove()

    def medians(self) -> dict:
        return {k: float(np.median([r[k] for r in self.rows]))
                for k in self.KEYS}


def decode_wall(run, Request, np_rng, label: str) -> dict:
    """Wall-clock decode steps of the served engine: 4 more requests (one
    prefill chunk each, 32 new tokens; 16 on an uncaptured engine, whose
    steps are slower), every step timed between
    torch.cuda.synchronize() calls and split by StepParts; the decode-only
    steps (all 4 slots running, no prefill chunk) are the decode-step
    time.  Attention covers the whole cache buffer whatever the context,
    so the short prompts do not shorten the step."""
    engine = run.engines[0]
    wbytes = weight_bytes(engine.balanced_trunk)
    for _ in range(4):
        engine.submit(Request(
            prompt=np_rng.integers(0, run.cfg.vocab_size, 8,
                                   dtype=np.int32),
            max_new_tokens=32 if engine.captured else 16,
            arrival_time=engine.now))
    topo = engine.topology is not None and engine.placement is not None
    parts = StepParts(engine, FeedbackSplit(engine.balanced_trunk)
                      if topo and engine.captured else None)
    times = []
    try:
        while engine.has_work:
            torch.cuda.synchronize()
            parts.start()
            t0 = time.perf_counter()
            st = engine.step()
            torch.cuda.synchronize()
            if st.prefill_tokens == 0 and st.decode_tokens == 4:
                times.append(time.perf_counter() - t0)
                parts.keep()
    finally:
        parts.remove()
    if len(times) < 8:
        raise AssertionError(f"only {len(times)} decode-only steps")
    step = float(np.median(times))
    med = parts.medians()
    other = step * 1e3 - med["enqueue_ms"] - med["pick_ms"] - med["feedback_ms"]
    mode = "captured" if engine.captured else "uncaptured"
    say(f"[smoke] {label} decode step, {mode} (4 slots, wall, median of "
        f"{len(times)}): {step * 1e3:.2f} ms (min {min(times) * 1e3:.2f}, "
        f"max {max(times) * 1e3:.2f}); body {med['body_ms']:.2f} ms by CUDA "
        f"events, {med['enqueue_ms']:.2f} ms to enqueue; pick "
        f"{med['pick_ms']:.2f} ms (waits for the body); feedback + refresh "
        f"{med['feedback_ms']:.2f} ms"
        + (f" (inner per-socket replays {med['inner_ms']:.2f}, outer socket "
           f"report {med['outer_ms']:.2f}, refresh {med['refresh_ms']:.2f})"
           if parts.split is not None else "")
        + f"; rest {other:.2f} ms; weights "
        f"{wbytes / 1e9:.3f} GB per step -> {wbytes / step / 1e9:.1f} GB/s = "
        f"{wbytes / step / HBM_BYTES_PER_S:.4f} of 3.35 TB/s")
    return {"captured": engine.captured, "decode_step_ms": step * 1e3,
            "decode_step_min_ms": min(times) * 1e3,
            "decode_step_max_ms": max(times) * 1e3,
            "decode_steps": len(times), **med, "rest_ms": other,
            "weight_bytes_per_step": wbytes,
            "weight_gb_per_s": wbytes / step / 1e9}


def profile_decode(run, Request, np_rng, label: str) -> dict:
    """Device time by kernel over 3 decode-only steps (torch.profiler).
    Only the device's own events are summed (kernels, copies, memsets):
    an operator's device time is its kernels' time, counted once there.
    The kernels of a graph replay appear under their own names."""
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
    mode = "captured" if engine.captured else "uncaptured"
    out = device_summary(prof, wall, f"{label} profile of 3 decode steps, "
                                     f"{mode}")
    return {"captured": engine.captured, **out}


def device_summary(prof, wall: float, label: str, n_top: int = 8) -> dict:
    """Device time by kernel name from a torch.profiler run of ``wall``
    seconds.  Only the device's own events are summed (kernels, copies,
    memsets): an operator's device time is its kernels' time, counted once
    there.  The kernels of a graph replay appear under their own names."""
    from torch.autograd import DeviceType

    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    avgs = [(name, us, n) for name, (us, n) in by_name.items()]
    total = sum(t for _, t, _ in avgs)  # microseconds
    say(f"[smoke] {label}: wall "
        f"{wall * 1e3:.1f} ms, "
        f"device busy {total / 1e3:.1f} ms "
        f"({total / 1e6 / wall if wall else 0:.3f} of wall), "
        f"{sum(n for _, _, n in avgs)} device events")
    top = sorted(avgs, key=lambda a: -a[1])[:n_top]
    for key, t, count in top:
        say(f"[smoke]   {t / 1e3:8.2f} ms  x{count:5d}  {key[:90]}")
    return {"profile_wall_ms": wall * 1e3,
            "device_busy_ms": total / 1e3,
            "device_events": sum(n for _, _, n in avgs),
            "top": [{"kernel": k, "device_ms": t / 1e3, "count": c}
                    for k, t, c in top]}


def prefill_chunk_ms(engine, init_state, init_slot_state, np_rng,
                     lanes: int, reps: int = 5) -> dict:
    """One prefill chunk of 8 tokens per lane through the engine's trunk
    call (uncaptured, as the engine runs it), from fresh caches: the
    median host time (ending in a synchronize) and CUDA-event time of
    ``reps`` chunks after one warm-up.  One lane is the batch-1 state at
    one offset; several lanes are one B-row state with per-row offsets,
    the form the lanes are stacked into."""
    from repro_torch.serving import PREFILL

    cfg, dev = engine.cfg, engine.device
    host, events = [], []
    for rep in range(reps + 1):
        if lanes == 1:
            state = init_state(cfg, 1, engine.max_seq, device=dev)
            pos = torch.tensor(0, dtype=torch.int32, device=dev)
        else:
            state = init_slot_state(cfg, lanes, engine.max_seq, device=dev)
            pos = torch.zeros(lanes, dtype=torch.int32, device=dev)
        tokens = torch.as_tensor(
            np_rng.integers(0, cfg.vocab_size, (lanes, 8), dtype=np.int32),
            device=dev)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        t0 = time.perf_counter()
        engine._run(tokens, state, pos, PREFILL, lanes=lanes > 1)
        e1.record()
        torch.cuda.synchronize()
        if rep:
            host.append((time.perf_counter() - t0) * 1e3)
            events.append(e0.elapsed_time(e1))
        del state
    ms = float(np.median(host))
    return {"lanes": lanes, "m": 8 * lanes, "host_ms": ms,
            "events_ms": float(np.median(events)),
            "tokens_per_s": 8 * lanes / ms * 1e3}


def logit_gap(engine, init_state, a, b) -> float:
    """Where two runs' tokens for one prompt first part: |logit(token a) -
    logit(token b)| / max|logit| of the first run's context there, through
    the engine's trunk (and its head, where that runs outside the step) in
    one prefill call."""
    from repro_torch.serving import PREFILL

    i = next(j for j, (x, y) in enumerate(zip(a.generated, b.generated))
             if x != y)
    ctx = np.concatenate([a.prompt, np.asarray(a.generated[:i], np.int32)])
    state = init_state(engine.cfg, 1, engine.max_seq, device=engine.device)
    logits, _, _ = engine._run(
        torch.as_tensor(ctx[None, :], device=engine.device), state,
        torch.tensor(0, dtype=torch.int32, device=engine.device), PREFILL)
    lg = engine._head(logits, PREFILL)[0].float()
    return float((lg[a.generated[i]] - lg[b.generated[i]]).abs()
                 / lg.abs().max())


def serve_lanes(counts, serve_mod, params, one_lane, init_state,
                init_slot_state, np_rng, quant: str, kernel: str,
                arch: str = "llama2-7b",
                per_call: int = PER_TRUNK_CALL) -> dict:
    """Multi-lane prefill at full width: the main traffic with LANES prefill
    lanes (chunks of 8, so the lanes reach the kernels at M = 32), captured
    decode.  Its greedy tokens must equal the one-lane run's: exactly for
    int8; for Q4, a request whose tokens part must part at a near-tie,
    within Q4_VS_PLAIN_TOL of max |logit|.  Then one prefill chunk timed
    at 1 and LANES lanes."""
    main = drive(counts, serve_mod, quant=quant, params=params, lanes=LANES,
                 arch=arch)
    run = main["run"]
    expect_launches(main, kernel, per_call)
    at = sorted({it.prefill_tokens // 8 for it in run.iterations
                 if it.prefill_tokens})
    if LANES not in at:
        raise AssertionError(f"{quant} lanes run: no iteration prefilled "
                             f"{LANES} lanes (lane counts {at})")
    gaps = {a.request_id: logit_gap(run.engines[0], init_state, a, b)
            for a, b in zip(one_lane.requests, run.requests)
            if a.generated != b.generated}
    if quant == "int8" and gaps:
        raise AssertionError(f"int8 {LANES}-lane tokens differ from one "
                             f"lane's: logit gaps where they part {gaps}")
    if any(g > Q4_VS_PLAIN_TOL for g in gaps.values()):
        raise AssertionError(f"{quant} {LANES}-lane tokens part from one "
                             f"lane's beyond a near-tie: gaps {gaps}")
    timing = [prefill_chunk_ms(run.engines[0], init_state, init_slot_state,
                               np_rng, n) for n in (1, LANES)]
    one, many = timing
    say(f"[smoke] {arch} {quant} {LANES}-lane prefill run: launches "
        f"{main['launches'][kernel]} = {per_call} x "
        f"{main['trunk_calls']} trunk calls, lane counts {at}, "
        f"{sum(1 for it in run.iterations if it.prefill_tokens == 8 * LANES)}"
        f" iterations at M = {8 * LANES}; tokens equal one lane's: "
        f"{not gaps}" + (f" (logit gaps where they part: {gaps})"
                         if gaps else "")
        + f"; serve wall {main['serve_wall_s']:.1f} s")
    say(f"[smoke] {arch} {quant} prefill chunk of 8 tokens per lane, "
        f"uncaptured: "
        f"1 lane {one['host_ms']:.2f} ms ({one['events_ms']:.2f} by events), "
        f"{LANES} lanes {many['host_ms']:.2f} ms ({many['events_ms']:.2f}), "
        f"{one['tokens_per_s']:.0f} -> {many['tokens_per_s']:.0f} prompt "
        f"tokens/s")
    out = {"launches": main["launches"][kernel],
           "trunk_calls": main["trunk_calls"], "lane_counts": at,
           "tokens_equal": not gaps, "logit_gaps": gaps,
           "serve_wall_s": main["serve_wall_s"], "prefill_chunk": timing}
    del run, main
    torch.cuda.empty_cache()
    return out


def two_layers(params) -> tuple:
    """llama2-7b at full width cut to 2 layers, with its first 2 layers'
    weights (views)."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("llama2-7b"), n_layers=2)
    return cfg, slice_layers(params, cfg.n_layers)


def balanced_head_phase(counts, serve_mod, params, q4, q4_blocks) -> dict:
    """``--balanced-head`` at 2 layers of full width: the dense trunk's
    decode step captured, the head as eager per-core Q4 shards outside it,
    one q4_matmul launch per non-empty core shard; the sharded head equal
    to one launch of each Q4 kernel over the whole head, bitwise."""
    from repro_torch.kernels.dispatch import HybridKernelDispatcher

    cfg, params2 = two_layers(params)
    argv = [a for a in SERVE_ARGV if a != "--balanced-trunk"]
    argv[argv.index("--requests") + 1] = "4"
    argv[argv.index("--prompt-len") + 1] = "16"
    argv[argv.index("--steps") + 1] = "8"
    args = serve_mod.build_parser().parse_args(argv + ["--balanced-head"])
    shards = []
    plain_call = HybridKernelDispatcher.q4_matmul

    def counted(self, *a, **k):
        y = plain_call(self, *a, **k)
        shards.append(int((self.last_stats.counts > 0).sum()))
        return y

    HybridKernelDispatcher.q4_matmul = counted
    try:
        counts.reset()
        run = serve_mod.serve(args, params=params2, cfg=cfg)
        torch.cuda.synchronize()
        got = counts.read()
    finally:
        HybridKernelDispatcher.q4_matmul = plain_call
    for line in serve_mod.report_lines(args, run):
        say(line)
    sampled = (len(run.requests)
               + sum(1 for it in run.iterations if it.decode_tokens))
    # each shard launches the Q4 entry the kernel tuner picks for it
    q4_launched = got["q4_matmul"] + got["q4_matmul_db"]
    if len(shards) != sampled or q4_launched != sum(shards) or \
            got["int8_gemm"] or not run.engines[0].captured:
        raise AssertionError(f"balanced head: {len(shards)} head calls for "
                             f"{sampled} sampled steps, launches {got} "
                             f"against {sum(shards)} shards")
    head = run.engines[0].balanced_head
    x = torch.randn((DECODE_M, cfg.d_model),
                    generator=torch.Generator(device="cuda").manual_seed(4),
                    device="cuda")
    y = head(x, isa="membw")
    bk = q4_blocks(cfg.d_model)[2]
    for name in ("q4_matmul", "q4_matmul_db"):
        if not torch.equal(y, getattr(q4, name)(x, head.qw, bk)):
            raise AssertionError(f"balanced head shards != {name} bitwise")
    say(f"[smoke] balanced head (2 layers, full width): {len(shards)} head "
        f"calls, {q4_launched} Q4 launches ({got['q4_matmul']} q4_matmul, "
        f"{got['q4_matmul_db']} q4_matmul_db, the tuner's picks) = their "
        f"non-empty core shards ({min(shards)}-{max(shards)} per call); "
        f"shards bitwise equal to one q4_matmul and one q4_matmul_db launch")
    return {"head_calls": len(shards), "launches": q4_launched,
            "by_entry": {k: got[k] for k in ("q4_matmul", "q4_matmul_db")},
            "shards_per_call": [min(shards), max(shards)]}


def legacy_phase(serve_mod, params) -> dict:
    """``--legacy-batch`` at 2 layers of full width: one seed-era
    ``RoutedServer.serve_batch`` round over 2 static-batch replicas."""
    cfg, params2 = two_layers(params)
    args = serve_mod.build_parser().parse_args(
        ["--arch", "llama2-7b", "--legacy-batch", "--replicas", "2",
         "--batch", "4", "--prompt-len", "16", "--steps", "8",
         "--device", "cuda"])
    run = serve_mod.serve_legacy(args, params=params2, cfg=cfg)
    for line in serve_mod.legacy_lines(run):
        say(line)
    toks = run.tokens
    if (toks.shape != (4, 24) or int(run.counts.sum()) != 4
            or toks.min() < 0 or toks.max() >= cfg.vocab_size):
        raise AssertionError(f"legacy round: shape {toks.shape}, counts "
                             f"{run.counts.tolist()}")
    return {"counts": run.counts.tolist(), "shape": list(toks.shape),
            "times_s": run.times.tolist()}


def main_path_vs_plain(run, forward, init_state, np_rng, label: str,
                       tol: float, routing=None) -> dict:
    """Phase 5: one prefill chunk and one decode step at full width through
    the kernels and through their plain versions, from the same inputs.
    ``tol`` bounds max|diff| / max|logit|; 0 asks for bitwise equality."""
    engine = run.engines[0]
    prompt = torch.as_tensor(
        np_rng.integers(0, run.cfg.vocab_size, (1, 8), dtype=np.int32),
        device="cuda")
    nxt = torch.as_tensor(
        np_rng.integers(0, run.cfg.vocab_size, (1, 1), dtype=np.int32),
        device="cuda")
    steps = (({"tokens": prompt}, 0, "avx_vnni", "last"),
             ({"tokens": nxt}, 8, "membw", "all"))
    return trunk_vs_plain(run.cfg, engine.params, engine.balanced_trunk,
                          forward, init_state, steps, label, tol,
                          routing=routing)


def trunk_vs_plain(cfg, params, trunk, forward, init_state, steps,
                   label: str, tol: float, *, max_seq: int = 16,
                   counts=None, routing=None) -> dict:
    """The forward ``steps`` (a prefill chunk and a decode step: forward's
    input keywords, position, phase ISA, logits mode) on a fresh batch-1
    cache, through ``trunk``'s kernels and through their plain versions.
    ``tol`` bounds max|diff| / max|logit|; 0 asks for bitwise equality and
    ``math.inf`` only reports.  With ``counts`` the kernel pass's launches
    are read (set to 0 just before it); with ``routing`` (a
    :class:`Routing`) each pass's MoE top-k choices are recorded."""
    offsets = trunk.compiled_refresh()
    out, res = {}, {}
    for plain in (False, True):
        state = init_state(cfg, 1, max_seq, device="cuda")
        logits = []
        if counts is not None and not plain:
            counts.reset()
        if routing is not None:
            routing.begin(plain)
        for kw, pos, isa, mode in steps:
            fo = forward(cfg, params, state=state,
                         pos_offset=torch.tensor(pos, device="cuda"),
                         logits_mode=mode, apply_head=False, trunk=trunk,
                         trunk_isa=isa, trunk_offsets=offsets, plain=plain,
                         **kw)
            state = fo.state
            logits.append(trunk.apply_head(fo.logits[:, -1, :], isa=isa,
                                           offsets=offsets, plain=plain))
        if routing is not None:
            routing.end()
        if counts is not None and not plain:
            torch.cuda.synchronize()
            res["launches"] = counts.read()
        out[plain] = [lg.float() for lg in logits]
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


def file_digest(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def serve_topology(counts, serve_mod, params, topology: str, quant: str,
                   kernel: str, tol: float, forward, init_state, Request,
                   np_rng) -> dict:
    """Phase 8: the main traffic at full width on ``topology`` (socket-local
    two-level dispatch, NUMA-placed weights in the machine model), with
    ``--trace``, ``--metrics`` and ``--flight-recorder`` on, captured and
    uncaptured: the same tokens and timelines and the same three files
    (none holds a wall-clock field), 225 launches of ``kernel`` per trunk
    call, the trace valid; then the captured decode step split (with the
    two-level feedback's parts), its profile, and its logits against the
    plain path within ``tol``."""
    from repro_torch.obs import validate_trace

    label = f"{quant} {topology}"
    runs = {}
    for graph in (True, False):
        mode = "captured" if graph else "uncaptured"
        runs[graph] = drive(counts, serve_mod, quant=quant, params=params,
                            cuda_graph=graph, topology=topology,
                            obs_dir=OBS_DIR / f"{quant}-{topology}" / mode)
        expect_launches(runs[graph], kernel)
    main, unc = runs[True], runs[False]
    run = main["run"]
    say(f"[smoke] {label}: the serve lines below are the machine model's "
        f"(virtual clock, simulated sockets), not card figures")
    for line in serve_mod.report_lines(main["args"], run) + main["obs_lines"]:
        say(line)
    graph = run.engines[0]._graph
    say(f"[smoke] {label} launches: {main['launches']} over "
        f"{main['trunk_calls']} trunk calls, {graph.replays} of them graph "
        f"replays of {sum(graph.launches)} launches each; snapshot "
        f"boundaries per projection: {run.engines[0].balanced_trunk._compiled().n_workers + 1} "
        f"(serve wall {main['serve_wall_s']:.1f} s captured, "
        f"{unc['serve_wall_s']:.1f} s uncaptured, tracing on)")
    assert_same_run(run, unc["run"], f"{label} uncaptured vs captured")
    digests = {}
    for name, fname in OBS_FILES.items():
        a, b = (OBS_DIR / f"{quant}-{topology}" / mode / fname
                for mode in ("captured", "uncaptured"))
        digests[name] = (file_digest(a), a.stat().st_size)
        if digests[name][0] != file_digest(b):
            raise AssertionError(f"{label}: {name} of the captured run "
                                 f"differs from the uncaptured run's")
    trace = OBS_DIR / f"{quant}-{topology}" / "captured" / OBS_FILES["trace"]
    problems = validate_trace(str(trace))
    if problems:
        raise AssertionError(f"{label} trace: {problems[:5]}")
    say(f"[smoke] {label} uncaptured run: same tokens, timelines and "
        f"launches; trace ({digests['trace'][1] / 1e6:.1f} MB, valid), "
        f"metrics and decision ring byte-identical to the captured run's")
    d0 = run.dispatchers[0]
    splits = {key: d0.socket_ratios(key).tolist() for key in d0.table.keys()}
    fracs = [d0.achieved_bandwidth_fraction(socket=s)
             for s in range(d0.n_sockets)]
    del unc, runs
    torch.cuda.empty_cache()
    wall = decode_wall(run, Request, np_rng, label)
    prof = profile_decode(run, Request, np_rng, label)
    vs_plain = main_path_vs_plain(run, forward, init_state, np_rng, label,
                                  tol)
    out = {"launches": main["launches"][kernel],
           "trunk_calls": main["trunk_calls"],
           "serve_wall_s": main["serve_wall_s"],
           "peak_bytes": main["peak_bytes"],
           "socket_split_virtual": splits,
           "socket_achieved_bw_frac_virtual": fracs,
           "report": run.report.to_dict(), "decode": wall,
           "profile": prof, "vs_plain": vs_plain,
           "obs_sha256": {k: v[0] for k, v in digests.items()}}
    del run, main
    torch.cuda.empty_cache()
    return out


class ShardCount:
    """Non-empty core shards of every region the socket dispatchers of an
    eager topology trunk run (one kernel launch each), counted by wrapping
    their ``dispatch`` on the instances."""

    def __init__(self, topo):
        self.n = 0
        self.dispatchers = topo.socket_dispatchers or [topo.flat]
        for d in self.dispatchers:
            d.dispatch = self._counted(d.dispatch)

    def _counted(self, fn):
        def counted(*a, **k):
            st = fn(*a, **k)
            self.n += int((st.counts > 0).sum())
            return st
        return counted

    def remove(self) -> None:
        for d in self.dispatchers:
            del d.dispatch


def topology_eager_vs_compiled(counts, params) -> dict:
    """Phase 8 (2 layers of full width): compiled and eager topology trunks,
    q4 and int8, on both topologies, socket-local, and the compiled
    socket-oblivious baseline, over 4 requests: the same timelines and
    tokens; one eager launch per non-empty core shard across both sockets
    (for q4 the entry the kernel tuner picks, direct or ring); each
    projection kind and the head bitwise equal eager against compiled."""
    from repro_torch.models import BalancedTrunk
    from repro_torch.serving import (ContinuousBatchingEngine,
                                     HybridPhaseCost, poisson_requests)
    from repro_torch.topology import TopologyDispatcher

    cfg, params2 = two_layers(params)
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((DECODE_M, cfg.d_model), generator=gen, device="cuda")
    xff = torch.randn((DECODE_M, cfg.d_ff), generator=gen, device="cuda")
    kinds = (("attn_proj", "attn", "wq", x), ("mlp_up", "ffn", "wi", x),
             ("mlp_down", "ffn", "wo", xff))
    eager_kernel = {"q4": ("q4_matmul", "q4_matmul_db"),
                    "int8": ("int8_gemm",)}
    res, launches = {}, {}
    for quant in ("q4", "int8"):
        for topology in ("dual-125h", "2s-12900k"):
            t0 = time.perf_counter()
            runs = {}
            for mode, local in (("compiled", True), ("eager", True),
                                ("compiled", False)):
                disp = TopologyDispatcher(topology, socket_local=local,
                                          execute=mode == "eager",
                                          keep_stats=False)
                trunk = BalancedTrunk.from_params(cfg, params2, disp,
                                                  quant=quant, mode=mode,
                                                  device="cuda")
                engine = ContinuousBatchingEngine(
                    cfg, params2, max_slots=4, max_seq=32, prefill_chunk=8,
                    cost_model=HybridPhaseCost(topology),
                    balanced_trunk=trunk, device="cuda")
                reqs = poisson_requests(4, rate=50.0,
                                        vocab_size=cfg.vocab_size,
                                        prompt_len=16, max_new_tokens=8,
                                        seed=1)
                shards = ShardCount(disp) if mode == "eager" else None
                counts.reset()
                for r in reqs:
                    engine.submit(r)
                engine.run_until_idle()
                torch.cuda.synchronize()
                got = counts.read()
                if shards is not None:
                    shards.remove()
                runs[mode, local] = (trunk, reqs, got,
                                     shards.n if shards else None)
            (tc, rc, _, _), (te, re, le, n_shards) = (runs["compiled", True],
                                                      runs["eager", True])
            ro = runs["compiled", False][1]
            fields = ("generated", "arrival_time", "admit_time",
                      "first_token_time", "finish_time")
            for a, b, c in zip(rc, re, ro):
                if any(getattr(a, f) != getattr(b, f) for f in fields):
                    raise AssertionError(f"{quant} {topology}: eager run of "
                                         f"request {a.request_id} differs")
                if a.generated != c.generated:
                    raise AssertionError(f"{quant} {topology}: oblivious "
                                         f"tokens of request {a.request_id} "
                                         f"differ from socket-local")
            mine = sum(le[k] for k in eager_kernel[quant])
            others = sum(n for k, n in le.items()
                         if k not in eager_kernel[quant])
            if mine != n_shards or others or not n_shards:
                raise AssertionError(f"{quant} {topology} eager launches "
                                     f"{le}, expected {n_shards} of "
                                     f"{eager_kernel[quant]}")
            offs = tc.compiled_refresh()
            pairs = {kind: (te.projector(0, 1, group, "membw")(name, xin,
                                                               None),
                            tc.projector(0, 1, group, "membw",
                                         offsets=offs)(name, xin, None))
                     for kind, group, name, xin in kinds}
            pairs["head"] = (te.apply_head(x, isa="membw"),
                             tc.apply_head(x, isa="membw", offsets=offs))
            for kind, (a, b) in pairs.items():
                if not torch.equal(a, b):
                    rel = ((a - b).abs().max() / b.abs().max()).item()
                    raise AssertionError(f"{quant} {topology} {kind}: eager "
                                         f"!= compiled bitwise ({rel})")
            say(f"[smoke] {quant} {topology} eager vs compiled (2 layers, "
                f"full width, 4 requests): timelines and tokens equal, "
                f"{n_shards} {'+'.join(eager_kernel[quant])} launches "
                f"({le}) = the non-empty "
                f"core shards of both sockets, every projection kind and "
                f"the head bitwise equal; socket-oblivious tokens equal "
                f"[{time.perf_counter() - t0:.1f} s]")
            res[f"{quant} {topology}"] = {"eager_launches": n_shards}
            launches[f"eager {quant} {topology}"] = le
            del runs, tc, te
            torch.cuda.empty_cache()
    return {"runs": res, "launches": launches}


def to_cpu(tree):
    """A copy of a params tree with every tensor on the CPU."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def fleet_phase(serve_mod, params) -> dict:
    """Phase 9: ``--fleet`` at 2 layers of full width — the default fleet
    (6 engines on the card over one copy of the weights), 16 requests of
    up to 16 + 8 tokens, under the reference's diurnal traffic and failure
    window: twice with one seed, then with ``--fleet-admission``.  Every
    request finishes or is shed (only with admission); both seeded runs
    route, requeue and learn alike; every engine's caches are on the card.
    The card's runs are held to the same fleet runs with ``--device cpu``
    on the same weights (the virtual clock does not see the device; the
    CPU run is the one the CPU tests hold to the reference): the same
    routed counts, requeues, sheds and node ratios.  At this size the
    failure window catches no request in flight on ``big`` and admission
    never reaches its queue cap: no request is requeued or shed, and
    admission only degrades (cuts the token budget of) a few requests.
    The lines say how many of each there were."""
    from repro_torch.serving import FinishReason

    cfg, params2 = two_layers(params)
    base = ["--arch", "llama2-7b", "--fleet", "--requests", "16",
            "--prompt-len", "16", "--steps", "8", "--batch", "4"]
    keys = ("routed", "requeued", "prefill", "decode", "shed", "degraded")
    out, cpu = [], {}
    for extra in ([], [], ["--fleet-admission"]):
        args = serve_mod.build_parser().parse_args(
            base + extra + ["--device", "cuda"])
        t0 = time.perf_counter()
        run = serve_mod.serve_fleet(args, params=params2, cfg=cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for line in serve_mod.fleet_lines(args, run):
            say(line)
        engines = [e for n in run.cluster.nodes for e in n.engines]
        on_card = all(c.k.device.type == "cuda" and c.v.device.type == "cuda"
                      for e in engines for c in e.manager.state)
        shed = sum(r.finish_reason is FinishReason.SHED for r in run.requests)
        ok_reasons = {FinishReason.STOP, FinishReason.LENGTH,
                      FinishReason.ABORTED}
        if extra:
            ok_reasons.add(FinishReason.SHED)
        if (len(run.requests) != 16 or not on_card or len(engines) != 6
                or any(r.finish_time is None or r.finish_reason not in
                       ok_reasons for r in run.requests)
                or shed != run.report.n_shed):
            raise AssertionError(f"fleet run {extra}: "
                                 f"{len(run.requests)} finished, reasons "
                                 f"{[r.finish_reason for r in run.requests]}"
                                 f", caches on the card: {on_card}")
        captured = sum(e._graph is not None for e in engines)
        say(f"[smoke] fleet {' '.join(extra) or '(no admission)'}: 16/16 "
            f"finished or shed ({shed} shed, {run.report.n_degraded} "
            f"degraded, {run.router.n_requeued} requeued), {len(engines)} "
            f"engines with their caches on the "
            f"card, {captured} decode steps captured; serve wall "
            f"{wall:.1f} s (virtual clock above)")
        out.append({"routed": run.router.routed.tolist(),
                    "requeued": run.router.n_requeued,
                    "prefill": run.router.table.ratios("prefill").tolist(),
                    "decode": run.router.table.ratios("decode").tolist(),
                    "shed": shed, "degraded": run.report.n_degraded,
                    "serve_wall_s": wall,
                    "report": run.report.to_dict()})
        del run, engines
        torch.cuda.empty_cache()
    if any(out[0][k] != out[1][k] for k in keys):
        raise AssertionError(f"fleet: two runs with one seed differ: "
                             f"{[{k: o[k] for k in keys} for o in out[:2]]}")
    say("[smoke] fleet: two runs with one seed routed, requeued and learned "
        "the node ratios alike")
    params_cpu = to_cpu(params2)
    for extra, card in (([], out[0]), (["--fleet-admission"], out[2])):
        args = serve_mod.build_parser().parse_args(
            base + extra + ["--device", "cpu"])
        t0 = time.perf_counter()
        run = serve_mod.serve_fleet(args, params=params_cpu, cfg=cfg)
        wall = time.perf_counter() - t0
        got = {"routed": run.router.routed.tolist(),
               "requeued": run.router.n_requeued,
               "prefill": run.router.table.ratios("prefill").tolist(),
               "decode": run.router.table.ratios("decode").tolist(),
               "shed": sum(r.finish_reason is FinishReason.SHED
                           for r in run.requests),
               "degraded": run.report.n_degraded}
        label = " ".join(extra) or "(no admission)"
        if any(card[k] != got[k] for k in keys):
            raise AssertionError(
                f"fleet {label}: the card's run differs from the CPU's: "
                f"{ {k: card[k] for k in keys} } vs {got}")
        say(f"[smoke] fleet {label}: the card's routed {card['routed']}, "
            f"{card['requeued']} requeued, {card['shed']} shed, "
            f"{card['degraded']} degraded and node ratios equal the same run on the CPU (serve wall {wall:.1f} s)")
        cpu[label] = dict(got, serve_wall_s=wall)
        del run
    return {"runs": out, "cpu": cpu}


# ---------------------------------------------------------------- the zoo --
# the attention families' other six, at 2 layers of full width (llama4:
# one period, a dense layer and an MoE layer)
ZOO_TWO_LAYERS = ("chatglm3-6b", "starcoder2-15b", "olmo-1b",
                  "internvl2-26b", "musicgen-medium",
                  "llama4-maverick-400b-a17b")


def per_trunk_call(cfg) -> int:
    """Kernel launches of one compiled trunk call: q/k/v/o of every
    attention layer (a recurrent mixer runs plain), the banked MLP
    projections of each dense layer (3 SwiGLU, 2 GeLU; an MoE layer's
    experts run plain) and the head."""
    mlp = 3 if cfg.mlp == "swiglu" else 2
    return 1 + sum((4 if mixer == "attn" else 0)
                   + (mlp if ffn == "dense" else 0)
                   for mixer, ffn in cfg.layer_plan())


def expert_bytes(cfg, params) -> int:
    """Bytes of the MoE layers' expert weights (routed and shared), which
    the static (E, C, d) expert products read whole every trunk call."""
    total = 0
    for j, (_, ffn) in enumerate(cfg.period()):
        if ffn == "moe":
            total += sum(t.numel() * t.element_size() for name, t in
                         params["period"][j]["ffn"].items()
                         if name != "router")
    return total


class Routing:
    """The experts each MoE layer chose (``aux["top_e"]``), per pass of
    :func:`trunk_vs_plain`, recorded by wrapping ``moe.moe_fwd``."""

    def __init__(self):
        from repro_torch.models import moe

        self.mod, self.orig = moe, moe.moe_fwd
        self.runs, self.cur = {}, None

        def recorded(*a, **k):
            y, aux = self.orig(*a, **k)
            if self.cur is not None:
                self.runs[self.cur].append(aux["top_e"].clone())
            return y, aux

        moe.moe_fwd = recorded

    def begin(self, key) -> None:
        self.cur = key
        self.runs[key] = []

    def end(self) -> None:
        self.cur = None

    def remove(self) -> None:
        self.mod.moe_fwd = self.orig

    def parted(self, a, b) -> tuple:
        """(token, layer) top-k sets that differ between passes a and b,
        and how many there are."""
        n = total = 0
        for x, y in zip(self.runs[a], self.runs[b], strict=True):
            xs, ys = torch.sort(x, -1).values, torch.sort(y, -1).values
            n += int((xs != ys).any(-1).sum())
            total += xs.shape[0]
        return n, total


def serve_zoo(counts, serve_mod, arch: str, forward, init_state, Request,
              np_rng) -> dict:
    """Phase 10: ``arch`` at full width, the main traffic.  Q4 captured and
    uncaptured (the same tokens and timelines), int8 captured (and, for an
    MoE model, uncaptured too), ``per_trunk_call(cfg)`` launches per trunk
    call; each captured decode step split and profiled; logits against the
    plain path, int8 bitwise and Q4 within Q4_VS_PLAIN_TOL — for an MoE
    model the Q4 gap and the share of (token, layer) top-k sets that part
    from the plain path are only reported (a 1e-2 drift of the sums flips
    near-ties)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    per_call, moe = per_trunk_call(cfg), cfg.moe is not None
    out = {"per_trunk_call": per_call}
    t0 = time.perf_counter()
    q4 = drive(counts, serve_mod, arch=arch)
    run = q4["run"]
    for line in serve_mod.report_lines(q4["args"], run):
        say(line)
    expect_launches(q4, "q4_matmul_db", per_call)
    params = run.engines[0].params
    ebytes = expert_bytes(cfg, params)
    q4u = drive(counts, serve_mod, arch=arch, params=params,
                cuda_graph=False)
    expect_launches(q4u, "q4_matmul_db", per_call)
    assert_same_run(run, q4u["run"], f"{arch} q4 uncaptured vs captured")
    say(f"[smoke] {arch} q4: {q4['launches']['q4_matmul_db']} launches = "
        f"{per_call} x {q4['trunk_calls']} trunk calls, captured and "
        f"uncaptured alike, the same tokens and timelines (serve wall "
        f"{q4['serve_wall_s']:.1f} s captured, {q4u['serve_wall_s']:.1f} s "
        f"uncaptured; peak {q4['peak_bytes'] / 2**30:.2f} GiB)")
    del q4u
    out["q4"] = {"launches": q4["launches"]["q4_matmul_db"],
                 "trunk_calls": q4["trunk_calls"],
                 "serve_wall_s": q4["serve_wall_s"],
                 "peak_bytes": q4["peak_bytes"],
                 "decode": decode_wall(run, Request, np_rng, f"{arch} q4"),
                 "profile": profile_decode(run, Request, np_rng,
                                           f"{arch} q4")}
    routing = Routing() if moe else None
    try:
        out["q4"]["vs_plain"] = main_path_vs_plain(
            run, forward, init_state, np_rng, f"{arch} q4",
            math.inf if moe else Q4_VS_PLAIN_TOL, routing=routing)
        if moe:
            n, total = routing.parted(False, True)
            say(f"[smoke] {arch} q4 routing against the plain path: {n} of "
                f"{total} (token, layer) top-{cfg.moe.top_k} sets part "
                f"({n / total:.4f}); reported, not gated")
            out["q4"]["routing_parted"] = [n, total]
    finally:
        if routing is not None:
            routing.remove()
    del run, q4
    gc.collect()        # an engine and its captured step form a cycle
    torch.cuda.empty_cache()

    i8 = drive(counts, serve_mod, arch=arch, quant="int8", params=params)
    run = i8["run"]
    expect_launches(i8, "int8_gemm", per_call)
    if moe:
        i8u = drive(counts, serve_mod, arch=arch, quant="int8", params=params,
                    cuda_graph=False)
        expect_launches(i8u, "int8_gemm", per_call)
        assert_same_run(run, i8u["run"], f"{arch} int8 uncaptured vs "
                                         f"captured")
        del i8u
    say(f"[smoke] {arch} int8: {i8['launches']['int8_gemm']} launches = "
        f"{per_call} x {i8['trunk_calls']} trunk calls"
        + (", uncaptured the same tokens and timelines" if moe else "")
        + f" (serve wall {i8['serve_wall_s']:.1f} s)")
    out["int8"] = {"launches": i8["launches"]["int8_gemm"],
                   "trunk_calls": i8["trunk_calls"],
                   "serve_wall_s": i8["serve_wall_s"],
                   "peak_bytes": i8["peak_bytes"],
                   "decode": decode_wall(run, Request, np_rng,
                                         f"{arch} int8"),
                   "profile": profile_decode(run, Request, np_rng,
                                             f"{arch} int8"),
                   "vs_plain": main_path_vs_plain(
                       run, forward, init_state, np_rng, f"{arch} int8",
                       INT8_VS_PLAIN_TOL)}
    if moe:
        for quant in ("q4", "int8"):
            d = out[quant]["decode"]
            kernel_b = d["weight_bytes_per_step"]
            step_s = d["decode_step_ms"] / 1e3
            say(f"[smoke] {arch} {quant} decode step reads {kernel_b / 1e9:.3f}"
                f" GB of kernel weights and {ebytes / 1e9:.3f} GB of expert "
                f"weights (every expert, every step): "
                f"{(kernel_b + ebytes) / step_s / HBM_BYTES_PER_S:.4f} of "
                f"3.35 TB/s over the wall step; the experts alone bound the "
                f"step at {ebytes / HBM_BYTES_PER_S * 1e3:.3f} ms")
    out["expert_bytes"] = ebytes
    del run, i8, params
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[smoke] {arch} phase: {time.perf_counter() - t0:.1f} s")
    return out


def zoo_two_layers(counts, arch: str, forward, init_state, np_rng,
                   n_layers: int = 2) -> dict:
    """Phase 10: ``arch`` at full width cut to ``n_layers`` layers (llama4
    at 2: one period), bf16, seed 0: one prefill chunk and one decode step
    through the compiled Q4 and int8 trunks against their plain versions —
    int8 bitwise, Q4 within Q4_VS_PLAIN_TOL (reported only for an MoE
    model, whose routing flips at near-ties) — with exactly
    ``per_trunk_call(cfg)`` launches per trunk call, and the peak device
    memory.  internvl2 prefills behind a 256-token patch-embedding stub,
    musicgen on frame embeddings."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import HybridKernelDispatcher
    from repro_torch.models import BalancedTrunk, init_params
    from repro_torch.models.modality import audio_frame_stub, vlm_prefix_stub

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, device="cuda")
    per_call = per_trunk_call(cfg)
    if cfg.embed_input:
        steps = (({"embeds": audio_frame_stub(cfg, 1, 8, gen,
                                              device="cuda")},
                  0, "avx_vnni", "last"),
                 ({"embeds": audio_frame_stub(cfg, 1, 1, gen,
                                              device="cuda")},
                  8, "membw", "all"))
    else:
        toks = [torch.as_tensor(np_rng.integers(0, cfg.vocab_size, (1, n),
                                                dtype=np.int32),
                                device="cuda") for n in (8, 1)]
        pre = ({"prefix_embeds": vlm_prefix_stub(cfg, 1, gen,
                                                 device="cuda")}
               if cfg.n_prefix else {})
        steps = (({"tokens": toks[0], **pre}, 0, "avx_vnni", "last"),
                 ({"tokens": toks[1]}, 8 + cfg.n_prefix, "membw", "all"))
    out = {"per_trunk_call": per_call}
    for quant, kernel in (("q4", "q4_matmul_db"), ("int8", "int8_gemm")):
        trunk = BalancedTrunk.from_params(
            cfg, params, HybridKernelDispatcher.virtual(
                "ultra-125h", keep_stats=False), quant=quant, device="cuda")
        tol = (INT8_VS_PLAIN_TOL if quant == "int8" else
               math.inf if cfg.moe is not None else Q4_VS_PLAIN_TOL)
        res = trunk_vs_plain(cfg, params, trunk, forward, init_state, steps,
                             f"{arch} ({n_layers} layers) {quant}", tol,
                             max_seq=cfg.n_prefix + 16, counts=counts)
        want = {k: 0 for k in res["launches"]}
        want[kernel] = 2 * per_call
        if res["launches"] != want:
            raise AssertionError(f"{arch} {quant}: launches "
                                 f"{res['launches']}, expected {want}")
        out[quant] = res
        del trunk
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    say(f"[smoke] {arch} ({n_layers} layers, full width): {per_call} "
        f"launches per trunk call on q4_matmul_db and on int8_gemm, as "
        f"counted; int8 bitwise, q4 prefill/decode "
        f"{out['q4']['prefill']:.3g} / {out['q4']['decode']:.3g} of max "
        f"|logit|; peak {out['peak_bytes'] / 2**30:.2f} GiB "
        f"[{time.perf_counter() - t0:.1f} s]")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def zoo_phase(counts, serve_mod, forward, init_state, Request,
              np_rng) -> dict:
    """Phase 10, the zoo: granite-8b and granite-moe-1b-a400m served at full
    width, then the other six attention-family archs at 2 layers."""
    out = {}
    for arch in ("granite-8b", "granite-moe-1b-a400m") + ZOO_TWO_LAYERS:
        if arch in ZOO_TWO_LAYERS:
            out[arch] = zoo_two_layers(counts, arch, forward, init_state,
                                       np_rng)
        else:
            out[arch] = serve_zoo(counts, serve_mod, arch, forward,
                                  init_state, Request, np_rng)
        say(f"[smoke] device memory allocated after {arch} is freed: "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return out


# ---------------------------------------------------- the recurrent archs --
RECURRENT_SERVED = "xlstm-1.3b"
# jamba-1.5-large at the fewest layers that hold every (mixer, ffn) pair it
# has: (mamba, dense), (mamba, moe), (mamba, dense), (attn, moe)
RECURRENT_CUT = ("jamba-1.5-large-398b", 4)


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict / list / tuple."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = list(tree.values())
    return sum(tensor_bytes(t) for t in tree)


def step_bytes(arch: str, quant: str, decode: dict, mixer_b: int,
               state_b: int) -> dict:
    """The three byte counts of a recurrent arch's decode step — the
    kernels' weights, the mixers' weights that the graph's plain ops read,
    and the recurrent state read and written — beside the HBM bound of
    their sum and the step's device span."""
    kernel_b = decode["weight_bytes_per_step"]
    total = kernel_b + mixer_b + state_b
    bound = total / HBM_BYTES_PER_S * 1e3
    say(f"[smoke] {arch} {quant} decode step moves {kernel_b / 1e9:.3f} GB "
        f"of kernel weights (the head), {mixer_b / 1e9:.3f} GB of mixer "
        f"weights in the graph and {state_b / 1e9:.3f} GB of recurrent "
        f"state (read once and written once, 4 slots): {total / 1e9:.3f} "
        f"GB, HBM bound {bound:.3f} ms; body {decode['body_ms']:.2f} ms by "
        f"CUDA events ({bound / decode['body_ms']:.3f} of it), wall step "
        f"{decode['decode_step_ms']:.2f} ms")
    return {"kernel_weight_bytes": kernel_b, "mixer_weight_bytes": mixer_b,
            "state_bytes": state_b, "bound_ms": bound}


def serve_recurrent(counts, serve_mod, forward, init_state, init_slot_state,
                    Request, np_rng) -> dict:
    """Phase 11: xlstm-1.3b served whole (48 blocks, d 2048, bf16, seed 0)
    on the main traffic: Q4 captured and uncaptured (the same tokens and
    timelines), int8 captured, and int8 with LANES prefill lanes (the one
    lane run's tokens); one launch per trunk call (the head); each
    captured decode step split, profiled and set beside its three byte
    counts; logits against the plain path (int8 bitwise, Q4 within
    Q4_VS_PLAIN_TOL)."""
    from repro_torch.configs import get_config

    arch = RECURRENT_SERVED
    cfg = get_config(arch)
    per_call = per_trunk_call(cfg)
    t0 = time.perf_counter()
    q4 = drive(counts, serve_mod, arch=arch)
    run = q4["run"]
    for line in serve_mod.report_lines(q4["args"], run):
        say(line)
    expect_launches(q4, "q4_matmul_db", per_call)
    params = run.engines[0].params
    mixer_b = tensor_bytes(params["period"])
    state_b = 2 * tensor_bytes(run.engines[0].manager.state)
    q4u = drive(counts, serve_mod, arch=arch, params=params,
                cuda_graph=False)
    expect_launches(q4u, "q4_matmul_db", per_call)
    assert_same_run(run, q4u["run"], f"{arch} q4 uncaptured vs captured")
    say(f"[smoke] {arch} q4: {q4['launches']['q4_matmul_db']} launches = "
        f"{per_call} x {q4['trunk_calls']} trunk calls, captured and "
        f"uncaptured alike, the same tokens and timelines (serve wall "
        f"{q4['serve_wall_s']:.1f} s captured, {q4u['serve_wall_s']:.1f} s "
        f"uncaptured; peak {q4['peak_bytes'] / 2**30:.2f} GiB)")
    out = {"per_trunk_call": per_call}
    out["q4"] = {"launches": q4["launches"]["q4_matmul_db"],
                 "trunk_calls": q4["trunk_calls"],
                 "serve_wall_s": q4["serve_wall_s"],
                 "uncaptured_serve_wall_s": q4u["serve_wall_s"],
                 "peak_bytes": q4["peak_bytes"]}
    del q4u, q4
    for quant, kernel, tol in (("q4", "q4_matmul_db", Q4_VS_PLAIN_TOL),
                               ("int8", "int8_gemm", INT8_VS_PLAIN_TOL)):
        if quant == "int8":
            i8 = drive(counts, serve_mod, arch=arch, quant="int8",
                       params=params)
            run = i8["run"]
            expect_launches(i8, kernel, per_call)
            say(f"[smoke] {arch} int8: {i8['launches'][kernel]} launches = "
                f"{per_call} x {i8['trunk_calls']} trunk calls (serve wall "
                f"{i8['serve_wall_s']:.1f} s)")
            out["int8"] = {"launches": i8["launches"][kernel],
                           "trunk_calls": i8["trunk_calls"],
                           "serve_wall_s": i8["serve_wall_s"],
                           "peak_bytes": i8["peak_bytes"]}
            del i8
        res = out[quant]
        res["decode"] = decode_wall(run, Request, np_rng, f"{arch} {quant}")
        res["profile"] = profile_decode(run, Request, np_rng,
                                        f"{arch} {quant}")
        res["bytes"] = step_bytes(arch, quant, res["decode"], mixer_b,
                                  state_b)
        res["vs_plain"] = main_path_vs_plain(run, forward, init_state,
                                             np_rng, f"{arch} {quant}", tol)
        if quant == "int8":
            out["lanes"] = serve_lanes(counts, serve_mod, params, run,
                                       init_state, init_slot_state, np_rng,
                                       "int8", kernel, arch=arch,
                                       per_call=per_call)
        del run
        gc.collect()        # an engine and its captured step form a cycle
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[smoke] {arch} phase: {time.perf_counter() - t0:.1f} s")
    return out


def recurrent_phase(counts, serve_mod, forward, init_state, init_slot_state,
                    Request, np_rng) -> dict:
    """Phase 11, the recurrent archs: xlstm-1.3b served whole, then
    jamba-1.5-large at 4 layers of full width against its plain path."""
    t0 = time.perf_counter()
    out = {RECURRENT_SERVED: serve_recurrent(
        counts, serve_mod, forward, init_state, init_slot_state, Request,
        np_rng)}
    arch, n = RECURRENT_CUT
    out[arch] = zoo_two_layers(counts, arch, forward, init_state, np_rng,
                               n_layers=n)
    say(f"[smoke] device memory allocated after {arch} is freed: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    say(f"[smoke] recurrent phase: {time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------------------------------ training --
H100_BF16_FLOP_PER_S = 989.4e12   # dense bf16 tensor-core peak (data sheet)
TRAIN_ARGV = ["--arch", "olmo-1b", "--preset", "full", "--steps", "4",
              "--global-batch", "8", "--microbatch", "4", "--seq-len", "2048",
              "--log-every", "1"]
TRAIN_LINE = re.compile(r"\[train\] step (\d+) loss=(\S+) lr=(\S+) "
                        r"gnorm=(\S+) tok/s=(\d+)")
# (b) one train step at 2 layers of full width, float32 (TF32 off), on the
# card and on the CPU from the same weights and batch: 2 microbatches of
# 1 x 128 tokens
TRAIN_VS_CPU = ("olmo-1b", "granite-moe-1b-a400m", "xlstm-1.3b")
TRAIN_VS_CPU_ARGV = dict(global_batch=2, microbatch=1, seq_len=128)
TRAIN_LOSS_TOL = 1e-4     # relative, loss and grad norm: f32 sums in other
TRAIN_GNORM_TOL = 1e-4    # orders over 2 layers and a 50k-row head
TRAIN_PARTED_SHARE = 1e-5  # parameters parting by >= lr (an Adam sign flip)
# (c) the resume check, olmo-1b at 2 layers of full width
RESUME_ARGV = ["--arch", "olmo-1b", "--preset", "full", "--global-batch",
               "4", "--microbatch", "2", "--seq-len", "256", "--log-every",
               "1", "--ckpt-every", "100"]


def run_train_main(train_mod, argv) -> tuple:
    """``repro_torch.launch.train.main(argv)``, its printout echoed and
    returned with the parsed step lines (step, loss, lr, gnorm, tok/s)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train_mod.main(argv)
    if rc != 0:
        raise AssertionError(f"launch.train {argv} returned {rc}")
    lines = buf.getvalue().splitlines()
    for line in lines:
        say(f"[smoke]   {line}")
    steps = [tuple(float(v) for v in m.groups())
             for m in map(TRAIN_LINE.fullmatch, lines) if m]
    return lines, steps


def train_full(counts, train_mod) -> dict:
    """(a) olmo-1b at full width and depth, bf16, through
    ``launch.train.main``: 4 steps of 8 x 2048 tokens in 2 microbatches,
    remat on.  Every loss finite; the wall step (torch.cuda.synchronize,
    as the driver times it) from its tok/s; then, on fresh weights, one
    step split by CUDA events into forward+backward of the microbatches and
    the optimizer; tokens/s, peak memory and 6·N·D over the step time
    against the card's bf16 peak."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.training import (AdamWConfig, adamw_update,
                                      init_opt_state, microbatch_grads)

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    _, steps = run_train_main(train_mod, TRAIN_ARGV)
    launches = counts.read()
    peak = torch.cuda.max_memory_allocated()
    wall_s = time.perf_counter() - t0
    if len(steps) != 4 or not all(math.isfinite(s[1]) for s in steps):
        raise AssertionError(f"olmo-1b training: steps {steps}")
    if any(launches.values()):
        raise AssertionError(f"no kernel is on the training path, yet "
                             f"{launches} launched")
    cfg = get_config("olmo-1b")
    tokens = 8 * 2048
    step_s = [tokens / s[4] for s in steps]
    n_params = cfg.param_count()
    model_flop = 6.0 * n_params * tokens

    # one step on fresh weights, split by CUDA events
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=4)
    opt = init_opt_state(params, opt_cfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=2048,
                                  global_batch=8, microbatch=4))
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in next(iter(data)).items()}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    ev[0].record()
    loss, grads, _ = microbatch_grads(cfg, params, batch, remat=True)
    ev[1].record()
    params, opt, metrics = adamw_update(opt_cfg, params, grads, opt)
    ev[2].record()
    torch.cuda.synchronize()
    split_wall = time.perf_counter() - h0
    fwd_bwd_ms = ev[0].elapsed_time(ev[1])
    opt_ms = ev[1].elapsed_time(ev[2])
    n_micro = batch["tokens"].shape[0]
    if not math.isfinite(float(loss)):
        raise AssertionError("split step: loss not finite")
    del grads
    # and one more step under the profiler: device time by kernel (the
    # device's events only; the host's ~16,000 operator events would take
    # longer to gather than the step)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter()
        _, grads, _ = microbatch_grads(cfg, params, batch, remat=True)
        adamw_update(opt_cfg, params, grads, opt)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - h0
    profiled = device_summary(prof, prof_wall,
                              "profile of one olmo-1b train step", n_top=12)
    del params, opt, grads, batch, prof
    gc.collect()
    torch.cuda.empty_cache()

    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    out = {"losses": [s[1] for s in steps],
           "grad_norms": [s[3] for s in steps],
           "lr": [s[2] for s in steps], "step_s": step_s,
           "steady_step_s": steady, "tokens_per_s": tokens / steady,
           "peak_bytes": peak, "n_params": n_params,
           "model_flop_per_step": model_flop,
           "share_of_bf16_peak": model_flop / steady / H100_BF16_FLOP_PER_S,
           "split": {"fwd_bwd_ms": fwd_bwd_ms,
                     "fwd_bwd_per_microbatch_ms": fwd_bwd_ms / n_micro,
                     "optimizer_ms": opt_ms, "host_wall_ms": split_wall * 1e3,
                     "n_micro": n_micro},
           "profile": profiled, "launches": launches, "wall_s": wall_s}
    say(f"[smoke] olmo-1b training, full width and depth ({n_params / 1e9:.3f}"
        f" B parameters, bf16, remat), 4 steps of 8 x 2048 tokens: losses "
        f"{out['losses']}, wall steps {[f'{t * 1e3:.1f}' for t in step_s]} ms "
        f"(torch.cuda.synchronize); steady {steady * 1e3:.1f} ms, "
        f"{out['tokens_per_s']:.0f} tokens/s; peak "
        f"{peak / 2**30:.2f} GiB")
    say(f"[smoke] one olmo-1b step split by CUDA events: forward+backward "
        f"{fwd_bwd_ms:.1f} ms for {n_micro} microbatches of 4 x 2048 "
        f"({fwd_bwd_ms / n_micro:.1f} ms each), optimizer {opt_ms:.1f} ms; "
        f"host wall {split_wall * 1e3:.1f} ms")
    say(f"[smoke] 6·N·D = {model_flop / 1e12:.1f} TFLOP a step over "
        f"{steady * 1e3:.1f} ms: {out['share_of_bf16_peak']:.4f} of the "
        f"card's bf16 peak ({H100_BF16_FLOP_PER_S / 1e12:.1f} TFLOP/s) "
        f"[{time.perf_counter() - t0:.1f} s]")
    return out


def train_vs_cpu(arch: str) -> dict:
    """(b) One ``make_train_step`` step of ``arch`` at 2 layers of full
    width in float32 (TF32 off), on the card and on the CPU from the same
    weights (drawn on the CPU, seed 0) and batch: loss and grad norm within
    TRAIN_LOSS_TOL / TRAIN_GNORM_TOL, the updated parameters parting by a
    learning rate or more (an Adam sign flip parts them by 2·lr) in at
    most TRAIN_PARTED_SHARE of the elements, and the largest other part in
    units of lr reported."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)
    from repro_torch.tree import leaves, tree_map

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), n_layers=2, dtype="float32")
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=4)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    kw = TRAIN_VS_CPU_ARGV
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, **kw))
    batch = {k: torch.from_numpy(v) for k, v in next(iter(data)).items()}
    res = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t, dev=dev: t.to(dev), params)
        step = make_train_step(cfg, opt_cfg, remat=True)
        h0 = time.perf_counter()
        new_p, _, m = step(p, init_opt_state(p, opt_cfg),
                           {k: v.to(dev) for k, v in batch.items()})
        if dev == "cuda":
            torch.cuda.synchronize()
        res[dev] = (float(m["loss"]), float(m["grad_norm"]), float(m["lr"]),
                    [t.cpu() for t in leaves(new_p)],
                    time.perf_counter() - h0, float(m["dropped"]))
    (l_c, g_c, lr, p_c, s_c, d_c), (l_g, g_g, _, p_g, s_g, d_g) = \
        res["cpu"], res["cuda"]
    n = sum(t.numel() for t in p_c)
    parted, worst = 0, 0.0
    for a, b in zip(p_g, p_c):
        d = (a - b).abs()
        parted += int((d >= lr).sum())
        worst = max(worst, float(torch.where(d >= lr, 0.0, d).max()) / lr)
    out = {"loss": (l_g, l_c), "grad_norm": (g_g, g_c), "lr": lr,
           "parted": parted, "elements": n, "worst_other_in_lr": worst,
           "dropped": (d_g, d_c), "cpu_s": s_c, "card_s": s_g}
    say(f"[smoke] {arch} (2 layers, full width, f32) one train step, card "
        f"against CPU: loss {l_g:.7g} / {l_c:.7g}, grad norm {g_g:.7g} / "
        f"{g_c:.7g}; {parted} of {n} parameters part by >= lr "
        f"({lr:.3g}), the rest by at most {worst:.3g} lr"
        + (f"; dropped {d_g:.4g} / {d_c:.4g}" if cfg.moe else "")
        + f" [card {s_g:.2f} s, CPU {s_c:.2f} s, "
          f"{time.perf_counter() - t0:.1f} s]")
    if not (abs(l_g - l_c) <= TRAIN_LOSS_TOL * abs(l_c)
            and abs(g_g - g_c) <= TRAIN_GNORM_TOL * abs(g_c)
            and parted <= TRAIN_PARTED_SHARE * n):
        raise AssertionError(f"{arch}: card and CPU train steps part: {out}")
    return out


def _dir_bytes(path: str) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def train_resume(train_mod) -> dict:
    """(c) olmo-1b at 2 layers of full width (bf16) through
    ``launch.train.main``: 4 steps straight against 2 steps then 2 resumed
    from the checkpoint, under torch.use_deterministic_algorithms (the
    embedding's backward adds rows with atomics otherwise), in a temporary
    directory removed afterwards: the same step lines but tok/s, and the
    step-4 checkpoints equal byte for byte."""
    t0 = time.perf_counter()
    full = train_mod.get_config
    train_mod.get_config = lambda arch: dataclasses.replace(full(arch),
                                                            n_layers=2)
    written = 0
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            runs = {}
            for name, steps, d in (("straight", 4, "a"), ("first", 2, "b"),
                                   ("resumed", 4, "b")):
                before = _dir_bytes(tmp)
                lines, parsed = run_train_main(
                    train_mod, RESUME_ARGV + ["--steps", str(steps),
                                              "--ckpt-dir", f"{tmp}/{d}"])
                written += _dir_bytes(tmp) - before
                runs[name] = (lines, [s[:4] for s in parsed])
            with np.load(f"{tmp}/a/step_00000004/arrays.npz") as a, \
                    np.load(f"{tmp}/b/step_00000004/arrays.npz") as b:
                same = sorted(a.files) == sorted(b.files) and all(
                    a[k].tobytes() == b[k].tobytes() for k in a.files)
                n_leaves = len(a.files)
    finally:
        torch.use_deterministic_algorithms(deterministic)
        train_mod.get_config = full
    resumed = runs["resumed"][0]
    lines_equal = runs["straight"][1] == runs["first"][1] + runs["resumed"][1]
    ok = (same and lines_equal
          and resumed[0] == "[train] resumed from step 2"
          and resumed[1].startswith("[train] warm-started"))
    out = {"bitwise": same, "leaves": n_leaves, "bytes_written": written,
           "steps": runs["straight"][1], "wall_s": time.perf_counter() - t0}
    say(f"[smoke] olmo-1b (2 layers, full width) resume check under "
        f"deterministic algorithms: 4 steps straight against 2 + 2 resumed: "
        f"step lines equal {lines_equal}, the {n_leaves} leaves of the "
        f"step-4 checkpoints equal byte for byte {same}; "
        f"{written / 1e9:.2f} GB written to checkpoints "
        f"(removed) [{out['wall_s']:.1f} s]")
    if not ok:
        raise AssertionError(f"resume check failed: {runs}")
    return out


def train_phase(counts) -> dict:
    """Phase 12, training: (a) olmo-1b at full width and depth, (b) card
    against CPU at 2 layers, (c) the resume check."""
    from repro_torch.launch import train as train_mod

    t0 = time.perf_counter()
    say(f"[smoke] device memory allocated before training: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    out = {"olmo-1b": train_full(counts, train_mod),
           "vs_cpu": {arch: train_vs_cpu(arch) for arch in TRAIN_VS_CPU},
           "resume": train_resume(train_mod)}
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[smoke] training phase: {time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------------------------------ sharding --
SHARD_STEPS = 3           # (b) sharded olmo-1b steps, the first one warm-up
SHARD_RDV = Path(__file__).resolve().parent / "build" / "shard_rendezvous"


def shard_setup():
    """An NCCL process group of world size 1 through the port's
    ``init_cluster`` (a file rendezvous under build/, no network), and the
    (1, 1) ``("data", "model")`` mesh on the card."""
    import torch.distributed as dist

    from repro_torch.launch.cluster import init_cluster
    from repro_torch.launch.mesh import make_debug_mesh

    SHARD_RDV.parent.mkdir(parents=True, exist_ok=True)
    SHARD_RDV.unlink(missing_ok=True)
    if not init_cluster(f"file://{SHARD_RDV}", 1, 0, device="cuda"):
        raise AssertionError("init_cluster did not join a process group")
    if dist.get_backend() != "nccl":
        raise AssertionError(f"backend {dist.get_backend()}, not nccl")
    mesh = make_debug_mesh(1, 1, device="cuda")
    if mesh.device_type != "cuda":
        raise AssertionError(f"mesh on {mesh.device_type}")
    return mesh


def _shard_tree(mesh, params, opt):
    """Parameters and optimizer state as DTensors by their shardings, and
    the parameters' shardings (the step's ``grad_shardings``)."""
    from repro_torch.sharding import distribute, opt_shardings, param_shardings

    ps = param_shardings(mesh, params)
    tree = distribute({"params": params, "opt": opt},
                      {"params": ps, "opt": opt_shardings(mesh, opt, ps)})
    return tree["params"], tree["opt"], ps


def _shard_batch(mesh, batch):
    from repro_torch.sharding import batch_shardings, distribute

    return distribute(batch, batch_shardings(mesh, batch, batch_dim=1))


def shard_vs_plain(mesh, tmp: str) -> dict:
    """(a) One ``make_train_step`` step of olmo-1b at 2 layers of full width
    in float32 (TF32 off), plain and on the (1, 1) mesh (DTensor
    parameters, optimizer state and batch, ``grad_shardings``) from the
    same weights and batch: loss and grad norm within TRAIN_LOSS_TOL /
    TRAIN_GNORM_TOL, parameters parting by >= lr in at most
    TRAIN_PARTED_SHARE of the elements, and whether the two are bitwise
    equal.  (c) The plain step's parameters and state, saved, restored with
    ``shardings=`` onto the mesh: bitwise the plain restore."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import restore, save
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.sharding import (activation_sharding, opt_shardings,
                                      param_shardings)
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)
    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("olmo-1b"), n_layers=2,
                              dtype="float32")
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=4)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  **TRAIN_VS_CPU_ARGV))
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in next(iter(data)).items()}
    step = make_train_step(cfg, opt_cfg, remat=True)
    plain_p, plain_o, pm = step(params, init_opt_state(params, opt_cfg),
                                batch)
    dparams, dopt, ps = _shard_tree(mesh, params,
                                    init_opt_state(params, opt_cfg))
    sstep = make_train_step(cfg, opt_cfg, remat=True, grad_shardings=ps)
    with activation_sharding(mesh):
        shard_p, shard_o, sm = sstep(dparams, dopt, _shard_batch(mesh, batch))
    torch.cuda.synchronize()
    if not all(isinstance(t, DTensor) and t.device_mesh is mesh
               for t in leaves(shard_p) + leaves(shard_o)):
        raise AssertionError("the sharded step left the mesh")
    lr = float(pm["lr"])
    n = parted = 0
    bitwise = (float(pm["loss"]) == float(sm["loss"])
               and float(pm["grad_norm"]) == float(sm["grad_norm"]))
    worst = 0.0
    for a, b in zip(leaves(shard_p), leaves(plain_p)):
        a = a.full_tensor()
        d = (a - b).abs()
        n += b.numel()
        parted += int((d >= lr).sum())
        worst = max(worst, float(d.max()) / lr)
        bitwise = bitwise and torch.equal(a, b)
    l_p, l_s = float(pm["loss"]), float(sm["loss"])
    g_p, g_s = float(pm["grad_norm"]), float(sm["grad_norm"])
    out = {"loss": (l_s, l_p), "grad_norm": (g_s, g_p), "lr": lr,
           "parted": parted, "elements": n, "worst_in_lr": worst,
           "bitwise": bitwise}
    say(f"[smoke] olmo-1b (2 layers, full width, f32) one train step on the "
        f"(1, 1) mesh against the plain step: loss {l_s:.7g} / {l_p:.7g}, "
        f"grad norm {g_s:.7g} / {g_p:.7g}; {parted} of {n} parameters part "
        f"by >= lr ({lr:.3g}), the most by {worst:.3g} lr; bitwise equal "
        f"{bitwise}")
    if not (abs(l_s - l_p) <= TRAIN_LOSS_TOL * abs(l_p)
            and abs(g_s - g_p) <= TRAIN_GNORM_TOL * abs(g_p)
            and parted <= TRAIN_PARTED_SHARE * n):
        raise AssertionError(f"sharded and plain steps part: {out}")

    # (c) restore onto the mesh
    tree = {"params": plain_p, "opt": plain_o}
    save(tmp, 1, tree)
    plain_r, _ = restore(tmp, 1, tree, device="cuda")
    ps = param_shardings(mesh, plain_p)
    onto, _ = restore(tmp, 1, tree, device="cuda", shardings={
        "params": ps, "opt": opt_shardings(mesh, plain_o, ps)})
    same = all(isinstance(a, DTensor) and a.device_mesh is mesh
               and a.dtype == b.dtype and torch.equal(a.full_tensor(), b)
               for a, b in zip(leaves(onto), leaves(plain_r)))
    out["restore_bitwise"] = same
    out["restore_leaves"] = len(leaves(onto))
    out["wall_s"] = time.perf_counter() - t0
    say(f"[smoke] the plain step's checkpoint restored onto the (1, 1) mesh "
        f"with shardings=: {out['restore_leaves']} DTensor leaves bitwise "
        f"equal to the plain restore {same} [{out['wall_s']:.1f} s]")
    if not same:
        raise AssertionError("restore onto the mesh is not bitwise")
    return out


def _olmo_steps(counts, mesh, n_steps: int) -> dict:
    """``n_steps`` train steps of olmo-1b whole (bf16, remat, 2 microbatches
    of 4 x 2048 tokens) from fresh weights, plain or on ``mesh``: each
    step's host time to return and wall time (torch.cuda.synchronize),
    peak memory, and the kernels' launches (held at 0)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.sharding import activation_sharding
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("olmo-1b")
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=4)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    opt = init_opt_state(params, opt_cfg)
    ps = None
    if mesh is not None:
        params, opt, ps = _shard_tree(mesh, params, opt)
    step = make_train_step(cfg, opt_cfg, remat=True, grad_shardings=ps)
    data = iter(SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=2048, global_batch=8,
                                       microbatch=4)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    host, wall, losses = [], [], []
    for _ in range(n_steps):
        batch = {k: torch.from_numpy(v).cuda() for k, v in next(data).items()}
        if mesh is not None:
            batch = _shard_batch(mesh, batch)
        t0 = time.perf_counter()
        with (activation_sharding(mesh) if mesh is not None
              else contextlib.nullcontext()):
            params, opt, m = step(params, opt, batch)
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    launches = counts.read()
    peak = torch.cuda.max_memory_allocated()
    del params, opt, m, batch
    gc.collect()
    torch.cuda.empty_cache()
    if any(launches.values()):
        raise AssertionError(f"no kernel is on the training path, yet "
                             f"{launches} launched")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"olmo-1b losses {losses}")
    steady = sorted(wall[1:])[len(wall[1:]) // 2]
    return {"host_s": host, "wall_s": wall, "losses": losses,
            "steady_step_s": steady, "tokens_per_s": 8 * 2048 / steady,
            "peak_bytes": peak, "launches": launches}


def shard_cost(counts, mesh, plain_steady) -> dict:
    """(b) olmo-1b whole on the (1, 1) mesh, SHARD_STEPS steps: the steady
    wall step, tokens/s, peak memory and the ratio to the plain steady step
    (phase 12's in a whole run; with ``--phases shard``, SHARD_STEPS plain
    steps measured here first)."""
    t0 = time.perf_counter()
    plain = None
    if plain_steady is None:
        plain = _olmo_steps(counts, None, SHARD_STEPS)
        plain_steady = plain["steady_step_s"]
    out = _olmo_steps(counts, mesh, SHARD_STEPS)
    out["plain_steady_step_s"] = plain_steady
    out["plain"] = plain
    out["ratio_to_plain"] = out["steady_step_s"] / plain_steady
    say(f"[smoke] olmo-1b whole (bf16, remat, 8 x 2048 tokens in 2 "
        f"microbatches) on the (1, 1) mesh: wall steps "
        f"{[f'{t * 1e3:.1f}' for t in out['wall_s']]} ms, host to return "
        f"{[f'{t * 1e3:.1f}' for t in out['host_s']]} ms; steady "
        f"{out['steady_step_s'] * 1e3:.1f} ms, {out['tokens_per_s']:.0f} "
        f"tokens/s, peak {out['peak_bytes'] / 2**30:.2f} GiB; plain steady "
        f"{plain_steady * 1e3:.1f} ms"
        + (" (measured here)" if plain is not None else " (phase 12)")
        + f": ratio {out['ratio_to_plain']:.4f}; losses {out['losses']}; "
          f"launches {out['launches']} [{time.perf_counter() - t0:.1f} s]")
    return out


def shard_phase(counts, plain_steady=None) -> dict:
    """Phase 13, sharding: the NCCL world of 1 and its (1, 1) mesh; (a) and
    (c) at 2 layers, (b) olmo-1b whole."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    mesh = shard_setup()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = shard_vs_plain(mesh, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        out["cost"] = shard_cost(counts, mesh, plain_steady)
    finally:
        dist.destroy_process_group()
        SHARD_RDV.unlink(missing_ok=True)
    out["wall_s"] = time.perf_counter() - t0
    say(f"[smoke] sharding phase: {out['wall_s']:.1f} s")
    return out


# ------------------------------------------------------------- dry run --
DRYRUN_TIMEOUT_S = 600
# phase 14's subprocess: the port's dry run of one production cell over a
# fake world of 256 ranks, then phase 12's own step on a world of 1; it
# writes its results to the JSON file named by its argument
DRYRUN_SCRIPT = r"""
import importlib.util, json, math, sys, time
sys.path.insert(0, sys.argv[2])
from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.launch.dryrun import (SUMMARY_KEYS, init_fake_world,
                                       production_mesh, trace_cell)

out = {"jax_importable": importlib.util.find_spec("jax") is not None}
# (a) olmo-1b x train_4k on the 16x16 mesh, full width and depth
init_fake_world(256)
mesh = production_mesh()
got = trace_cell(get_config("olmo-1b"), SHAPES["train_4k"], mesh,
                 arch="olmo-1b")
roof = got["roofline"].to_dict()
roof.update(mesh_shape=list(mesh.shape), trace_seconds=got["trace_seconds"],
            collectives_issued=len(got["recorder"].records),
            t_bound=got["roofline"].t_bound)
out["cell"] = {k: roof[k] for k in SUMMARY_KEYS + ("t_bound",
                                                   "collectives_issued",
                                                   "collective_ops")}
# (c) xlstm-1.3b cut to one period (8 layers, full width), its sharded
# train step on the same mesh at 16 x 128 tokens, two mLSTM chunks: the
# chunk on local shards (DTensor's own view of it raised on torch 2.11)
import dataclasses
xl = trace_cell(dataclasses.replace(get_config("xlstm-1.3b"), n_layers=8),
                ShapeSpec("train_16x128", "train", 128, 16), mesh,
                arch="xlstm-1.3b", n_micro=1)
out["xlstm_probe"] = {"trace_seconds": xl["trace_seconds"],
                      "collective_ops": xl["roofline"].collective_ops,
                      "peak_mem_bytes": xl["roofline"].peak_mem_bytes}
# (b) phase 12's step: olmo-1b, 8 x 2048 tokens in 2 microbatches, remat,
# plain on one device
t0 = time.perf_counter()
step = trace_cell(get_config("olmo-1b"), ShapeSpec("train_8x2048", "train",
                                                   2048, 8), None,
                  arch="olmo-1b", n_micro=2)
r = step["roofline"]
out["phase12_step"] = {"peak_mem_bytes": r.peak_mem_bytes,
                       "t_bound": r.t_bound, "t_compute": r.t_compute,
                       "t_memory": r.t_memory, "bottleneck": r.bottleneck,
                       "flops": r.flops, "hlo_flops_raw": r.hlo_flops_raw,
                       "trace_seconds": step["trace_seconds"]}
from repro_torch.kernels import int8_gemm, q4_matmul
out["launches"] = {"q4_matmul": q4_matmul.q4_matmul.launches,
                   "q4_matmul_db": q4_matmul.q4_matmul_db.launches,
                   "int8_gemm": int8_gemm.int8_gemm.launches}
# neither the reference package nor JAX came in with the port
out["imported"] = sorted(m for m in ("jax", "repro") if m in sys.modules)
json.dump(out, open(sys.argv[1], "w"))
"""


class DryRun:
    """Phase 14's subprocess, started by :meth:`start` and read by
    :func:`dryrun_phase`.  It traces on the host's CPU only (meta tensors,
    no kernel, no device memory), so a whole run starts it before phase 12,
    whose steps are bound by the card, and reads it after phase 13."""

    def __init__(self):
        self.tmp = tempfile.TemporaryDirectory()
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", DRYRUN_SCRIPT,
             f"{self.tmp.name}/dryrun.json",
             str(Path(__file__).resolve().parent / "src")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=self.tmp.name)

    def result(self) -> dict:
        try:
            _, err = self.proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.communicate()
            raise AssertionError(f"the dry run took over {DRYRUN_TIMEOUT_S} s")
        try:
            if self.proc.returncode != 0:
                raise AssertionError(f"the dry run failed:\n{err[-4000:]}")
            out = json.loads(Path(f"{self.tmp.name}/dryrun.json").read_text())
        finally:
            self.tmp.cleanup()
        out["subprocess_s"] = time.perf_counter() - self.t0
        return out


def dryrun_phase(run: DryRun, phase12=None) -> dict:
    """Phase 14, the dry run, in a subprocess of its own (it joins a fake
    process group): (a) olmo-1b x train_4k traced at full width and depth on
    the 16x16 mesh of a fake world of 256 ranks, its JSON summary line;
    (b) phase 12's step (olmo-1b, 8 x 2048 tokens in 2 microbatches, remat,
    a world of 1) dry-run: its predicted peak bytes, t_bound and t_compute
    beside phase 12's measured peak and steady step (``phase12``; None
    with ``--phases dryrun``, which runs no training).  Neither ``jax`` nor
    ``repro`` may be imported by the port's dry run, and no kernel wrapper
    of the subprocess may count a launch."""
    t0 = time.perf_counter()
    out = run.result()
    launches = out["launches"]
    if any(launches.values()):
        raise AssertionError(f"no kernel is on the dry run's path, yet "
                             f"{launches} launched")
    if out["imported"]:
        raise AssertionError(f"the port's dry run imported {out['imported']}")
    cell, step = out["cell"], out["phase12_step"]
    for what, v in (("cell", cell), ("step", step)):
        if not all(math.isfinite(v[k]) and v[k] > 0
                   for k in ("peak_mem_bytes", "t_bound", "t_compute")):
            raise AssertionError(f"dry run {what}: {v}")
    say("[smoke] dry run, olmo-1b x train_4k on the 16x16 mesh (fake world "
        "of 256 ranks, meta tensors): " + json.dumps(cell))
    xl = out["xlstm_probe"]
    say(f"[smoke] dry run, xlstm-1.3b cut to 8 layers, sharded train step "
        f"at 16 x 128 tokens (2 mLSTM chunks) on the 16x16 mesh: traced in "
        f"{xl['trace_seconds']:.1f} s on torch {torch.__version__}, "
        f"collectives {xl['collective_ops']}, peak "
        f"{xl['peak_mem_bytes'] / 2**30:.2f} GiB a card")
    measured = ""
    if phase12 is not None:
        out["phase12_measured"] = phase12
        measured = (f"; measured in phase 12: peak "
                    f"{phase12['peak_bytes'] / 2**30:.2f} GiB "
                    f"(predicted/measured "
                    f"{step['peak_mem_bytes'] / phase12['peak_bytes']:.3f}), "
                    f"steady step {phase12['steady_step_s']:.4f} s "
                    f"(t_bound/step "
                    f"{step['t_bound'] / phase12['steady_step_s']:.3f}, "
                    f"t_compute/step "
                    f"{step['t_compute'] / phase12['steady_step_s']:.3f})")
    out["wall_s"] = time.perf_counter() - t0
    say(f"[smoke] dry run of phase 12's step (olmo-1b, 8 x 2048 tokens, 2 "
        f"microbatches, remat, one device): predicted peak "
        f"{step['peak_mem_bytes'] / 2**30:.2f} GiB (live local tensors, a "
        f"lower bound), t_bound {step['t_bound']:.4f} s ({step['bottleneck']}"
        f"), t_compute {step['t_compute']:.4f} s, t_memory "
        f"{step['t_memory']:.4f} s{measured}; jax importable "
        f"{out['jax_importable']}, imported by the dry run "
        f"{out['imported'] or 'none'}; launches {launches} "
        f"[{out['subprocess_s']:.1f} s in its subprocess, "
        f"{out['wall_s']:.1f} s waited for]")
    return out


# --------------------------------------- the measured loop, the analysis --
TUNE_M = {"q4": (1, DECODE_M, 8), "int8": (1, DECODE_M, 8, 32)}
# where the wall-clock serving runs keep their kernel-tuner cache
TUNER_CACHE = Path(__file__).resolve().parent / "build" / "tuner.json"
# the wall-clock runs' traffic: the main traffic's 8 requests and 64-token
# prompts, each prefilled in one chunk, 16 new tokens; an eager step takes
# ~0.25-0.4 s (PERF.md), so the main traffic's 64 prefill chunks would
# take most of a minute a run.  Their captured virtual run serves the same
# traffic: the cache's length and the prefill chunks set the shapes of the
# plain ops, and so their bits.
WALL_TRAFFIC = {"--prefill-chunk": "64", "--steps": "16"}
ANALYSIS_TIMEOUT_S = 600


def variants_vs_default(q4, i8, quantize, q4_blocks) -> dict:
    """Phase 15 (a): every launch variant the kernel tuner chooses among,
    at llama2-7b's 4 distinct (N, K) (q/k/v/o; up and gate; down; head)
    and M = 1, 4, 8 (int8 also 32), f32 x for Q4: bitwise equal to the
    default entry (``q4_matmul``; ``int8_gemm``, which picks its x tile
    from M), Q4 within the reference's tolerance of the plain version and
    int8 bitwise equal to it; each variant's time per launch (CUDA events
    over 200 launches, weights rotated past the L2) beside its bound."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(15)
    rows = []
    for label, n, k, per_step in SHAPES:
        bk = q4_blocks(k)[2]
        qw = quantize(torch.randn((n, k), generator=gen, device="cuda"))
        copies = max(2, math.ceil(2 * L2_BYTES / qw.nbytes))
        qbanks = [type(qw)(qw.packed.clone(), qw.scales.clone())
                  for _ in range(copies)]
        w = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
        wbanks = [w.clone() for _ in range(max(2, math.ceil(
            2 * L2_BYTES / w.numel())))]
        for m in TUNE_M["q4"]:
            x = torch.randn((m, k), generator=gen, device="cuda")
            want = q4.q4_matmul(x, qw, bk)
            plain = q4.q4_matmul_plain(x, qw, bk)
            if not torch.allclose(want, plain, rtol=F32_TOL, atol=F32_TOL * k):
                raise AssertionError(f"q4_matmul vs plain at {label} M={m}")
            for v in ops.Q4_CANDIDATES:
                got = ops.q4_variant(x, qw, v)
                if not torch.equal(got, want):
                    raise AssertionError(f"Q4 variant {v} != q4_matmul "
                                         f"bitwise at {label} M={m}")
                t = device_ms(lambda x, b, v=v: ops.q4_variant(x, b, v),
                              [(x, b) for b in qbanks], 200)
                bnd, by = bound_ms(m, n, k)
                rows.append({"kernel": "q4", "variant": list(v),
                             "shape": label, "n": n, "k": k, "m": m,
                             "per_decode_step": per_step, "ms": t,
                             "bound_ms": bnd, "bound_by": by})
        for m in TUNE_M["int8"]:
            a = torch.randint(0, 256, (m, k), generator=gen, device="cuda",
                              dtype=torch.int32).to(torch.uint8)
            want = i8.int8_gemm(a, w)
            if not torch.equal(want, i8.int8_gemm_plain(a, w)):
                raise AssertionError(f"int8_gemm != plain at {label} M={m}")
            for v in ops.INT8_CANDIDATES:
                if not torch.equal(i8.int8_gemm(a, w, variant=v), want):
                    raise AssertionError(f"int8 variant {v} != int8_gemm "
                                         f"bitwise at {label} M={m}")
                t = device_ms(lambda a, b, v=v: i8.int8_gemm(a, b, variant=v),
                              [(a, b) for b in wbanks], 200)
                bnd, by = i8_bound_ms(m, n, k)
                rows.append({"kernel": "int8", "variant": list(v),
                             "shape": label, "n": n, "k": k, "m": m,
                             "per_decode_step": per_step, "ms": t,
                             "bound_ms": bnd, "bound_by": by})
        del qbanks, wbanks, qw, w
    torch.cuda.empty_cache()
    for kernel in ("q4", "int8"):
        for m in TUNE_M[kernel]:
            per = {}
            for r in rows:
                if r["kernel"] == kernel and r["m"] == m:
                    key = tuple(r["variant"])
                    per[key] = per.get(key, 0.0) + r["ms"] * r["per_decode_step"]
            bnd = sum(r["bound_ms"] * r["per_decode_step"] for r in rows
                      if r["kernel"] == kernel and r["m"] == m
                      and tuple(r["variant"]) == next(iter(per)))
            say(f"[smoke] {kernel} variants per decode step (225 launches) "
                f"at M={m}: " + ", ".join(
                    f"{'/'.join(map(str, v))} {t:.3f} ms" for v, t in
                    per.items()) + f"; bound {bnd:.3f} ms; every variant "
                f"bitwise equal to the default entry")
    for r in rows:
        say(f"[smoke]   {r['kernel']:4s} {'/'.join(map(str, r['variant'])):7s}"
            f" {r['shape']:11s} M={r['m']:2d} {r['ms'] * 1e3:8.2f} us  "
            f"bound {r['bound_ms'] * 1e3:6.2f} us ({r['bound_by']})")
    return {"rows": rows}


class RegionShards:
    """Non-empty core shards of every region any flat dispatcher runs
    (one kernel launch each), counted by wrapping the class's ``dispatch``
    while a serving run builds and runs its own dispatchers."""

    def __init__(self):
        from repro_torch.kernels.dispatch import HybridKernelDispatcher

        self.cls, self.n = HybridKernelDispatcher, 0
        self.plain = HybridKernelDispatcher.dispatch

        def counted(disp, *a, **k):
            st = self.plain(disp, *a, **k)
            self.n += int((st.counts > 0).sum())
            return st
        self.cls.dispatch = counted

    def remove(self) -> None:
        self.cls.dispatch = self.plain


def tuner_lines(run) -> dict:
    """Each shape class's chosen variant (the tuner's EMA argmin) and each
    ratio-table key's spread, of a wall-clock serving run."""
    tuner, table = run.tuner, run.dispatchers[0].table
    chosen = {}
    for key, tab in sorted(tuner._tables.items()):
        best = min(tab, key=lambda c: tab[c].ema)
        chosen[f"{key[0]} {'x'.join(map(str, key[1]))}"] = {
            "variant": list(best), "trials": {"/".join(map(str, c)): e.count
                                              for c, e in tab.items()},
            "ema_us": {"/".join(map(str, c)): e.ema * 1e6
                       for c, e in tab.items()}}
    spread = {key: float(table.ratios(key).max() / table.ratios(key).min())
              for key in table.keys()}
    return {"chosen": chosen, "spread": spread}


def serve_wall(counts, serve_mod, params, mode: str, quant: str,
               init_state, Request, np_rng) -> dict:
    """Phase 15 (b, c) at full width on WALL_TRAFFIC: first the captured
    virtual run, then ``serve --machine wall --tuner-cache`` twice from an
    empty cache: ``mode`` "trunk" (``--balanced-trunk --trunk-quant
    quant``: an eager trunk over the threaded dispatcher of 4 workers) or
    "head" (``--balanced-head``: the captured dense step, the head over
    the threaded dispatcher).  The second run warm-starts from the first's
    cache.  Each request's tokens against the captured virtual run's: a
    request whose tokens part must part within Q4_VS_PLAIN_TOL of max
    |logit| (reported).  One launch per non-empty core shard, of the
    tuner's picks.  Then the wall decode step of the second run (trunk),
    its ratio spread per key and each shape class's chosen variant."""
    argv = list(SERVE_ARGV)
    argv[argv.index("--trunk-quant") + 1] = quant
    for flag, value in WALL_TRAFFIC.items():
        argv[argv.index(flag) + 1] = value
    if mode == "head":
        argv.remove("--balanced-trunk")
        argv.append("--balanced-head")
    captured = serve_mod.serve(serve_mod.build_parser().parse_args(argv),
                               params=params)
    if not captured.engines[0].captured:
        raise AssertionError(f"the virtual {mode} run is not captured")
    argv[argv.index("--machine") + 1] = "wall"
    argv += ["--tuner-cache", str(TUNER_CACHE)]
    TUNER_CACHE.unlink(missing_ok=True)
    kernels = (("int8_gemm",) if quant == "int8" and mode == "trunk"
               else ("q4_matmul", "q4_matmul_db"))
    label = f"wall {mode} {quant if mode == 'trunk' else 'q4 head'}"
    want = {r.request_id: r for r in captured.requests}
    out = {"runs": []}
    for i in range(2):
        args = serve_mod.build_parser().parse_args(argv)
        shards = RegionShards()
        counts.reset()
        t0 = time.perf_counter()
        try:
            run = serve_mod.serve(args, params=params)
            torch.cuda.synchronize()
            got = counts.read()
        finally:
            shards.remove()
        wall = time.perf_counter() - t0
        lines = serve_mod.report_lines(args, run)
        for line in lines:
            say(line)
        warm = any("warm-started kernel tuner" in ln for ln in lines)
        if warm != (i == 1):
            raise AssertionError(f"{label} run {i + 1}: warm start {warm}")
        mine = sum(got[k] for k in kernels)
        if mine != shards.n or not mine or \
                any(n for k, n in got.items() if k not in kernels):
            raise AssertionError(f"{label}: launches {got} against "
                                 f"{shards.n} non-empty shards")
        gaps = {r.request_id: logit_gap(run.engines[0], init_state,
                                        want[r.request_id], r)
                for r in run.requests
                if r.generated != want[r.request_id].generated}
        if any(g > Q4_VS_PLAIN_TOL for g in gaps.values()):
            raise AssertionError(f"{label}: tokens part from the captured "
                                 f"virtual run's beyond a near-tie: {gaps}")
        say(f"[smoke] {label} run {i + 1}: {got} launches = {shards.n} "
            f"non-empty shards; tokens equal the captured virtual run's: "
            f"{not gaps}" + (f" (logit gaps where they part: {gaps})"
                             if gaps else "")
            + f"; warm start {warm}; serve wall {wall:.1f} s")
        out["runs"].append({"launches": got, "shards": shards.n,
                            "tokens_equal": not gaps, "logit_gaps": gaps,
                            "warm_start": warm, "serve_wall_s": wall})
        if i == 0:
            for d in run.dispatchers:   # their worker threads
                d.close()
    if mode == "trunk":
        out["decode"] = decode_wall(run, Request, np_rng, label)
    out.update(tuner_lines(run))
    say(f"[smoke] {label}: ratio spread per key " + json.dumps(
        {k: round(v, 3) for k, v in out["spread"].items()}))
    say(f"[smoke] {label}: chosen variant per shape class " + json.dumps(
        {k: "/".join(map(str, v["variant"])) for k, v in
         out["chosen"].items()}))
    for d in run.dispatchers:
        d.close()
    del run, captured
    torch.cuda.empty_cache()
    return out


def analysis_cli() -> dict:
    """Phase 15 (d): ``python -m repro_torch.analysis all --device cuda``
    in a subprocess: lint, the step audit (JA001 under sync debug mode on
    reduced granite-8b and on llama2-7b's captured step at full width),
    races over the threaded CUDA dispatcher, the invariants; exit 0."""
    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "all", "--device",
         "cuda", "--root", str(root / "src" / "repro_torch")],
        capture_output=True, text=True, env=env, cwd=root,
        timeout=ANALYSIS_TIMEOUT_S)
    for line in proc.stderr.splitlines() + proc.stdout.splitlines():
        say(f"[smoke]   {line}")
    if proc.returncode != 0:
        raise AssertionError(f"python -m repro_torch.analysis all exited "
                             f"{proc.returncode}")
    wall = time.perf_counter() - t0
    say(f"[smoke] python -m repro_torch.analysis all --device cuda: exit 0 "
        f"[{wall:.1f} s]")
    return {"rc": proc.returncode, "wall_s": wall,
            "summary": proc.stdout.strip().splitlines()[-1]}


def tune_phase(counts, serve_mod, params, q4, i8, quantize, q4_blocks,
               init_state, Request, np_rng) -> dict:
    """Phase 15, the measured loop and the analysis: (a) every launch
    variant against the default entry; (b) ``--machine wall
    --balanced-trunk`` twice with a tuner cache, Q4 and int8; (c)
    ``--balanced-head --machine wall`` the same way; each against a
    captured virtual run of the same traffic; (d) the analysis CLI on the
    card."""
    t0 = time.perf_counter()
    out = {"variants": variants_vs_default(q4, i8, quantize, q4_blocks)}
    for mode, quant in (("trunk", "q4"), ("trunk", "int8"), ("head", "q4")):
        key = f"wall {mode} {quant}" if mode == "trunk" else "wall head"
        out[key] = serve_wall(counts, serve_mod, params, mode, quant,
                              init_state, Request, np_rng)
    out["analysis"] = analysis_cli()
    TUNER_CACHE.unlink(missing_ok=True)
    out["wall_s"] = time.perf_counter() - t0
    say(f"[smoke] the measured loop and the analysis: {out['wall_s']:.1f} s")
    return out


# ------------------------------------------------------------ examples --
# The reference's printout of the lines on the virtual clock (its examples
# run on the CPU, letter for letter; no card figure among them)
EXAMPLE_LINES = {
    "hybrid_cpu_inference": [
        "[ultra-125h] prefill 6.08s -> 4.01s (+52%) | decode 13.9 -> 16.0 "
        "tok/s (+14%)",
        "[core-12900k] prefill 5.05s -> 3.08s (+64%) | decode 12.1 -> 13.4 "
        "tok/s (+11%)",
        "[fig4] P0 ratio trace: 2.66 1.95 1.24 1.03 0.96 0.93 0.88 0.88 0.89 "
        "0.88 ...",
        "[fig4] init 5.00 -> settled 0.89 (background load at dispatch ~5 "
        "absorbed)"],
    "serve_batch": [
        "[serve] round 0: split=[4, 4] ratios=[1.35, 0.65]",
        "[serve] round 1: split=[6, 2] ratios=[1.45, 0.54]",
        "[serve] round 2: split=[6, 2] ratios=[1.49, 0.51]",
        "[serve] round 3: split=[6, 2] ratios=[1.5, 0.5]",
        "[serve] round 4: split=[6, 2] ratios=[1.5, 0.5]",
        "[serve] done; generated shape: (8, 12)"],
    "continuous_serving": [
        "[continuous] routed: replica0=14 replica1=18",
        "[continuous] prefill ratios: [1.0, 1.0] (same speed)",
        "[continuous] decode  ratios: [0.5, 1.5] (3x gap)",
        "[continuous] finished 32/32 requests, 219 tokens in 0.622s (352.2 "
        "tok/s, goodput 51.46 req/s)",
        "[continuous] ttft p50=11.05ms p90=21.58ms p99=31.96ms",
        "[continuous] tpot p50=3.00ms p90=4.63ms p99=6.00ms"],
}
QUICKSTART_SCHEDULER = ("[scheduler] static 26.36 ms -> dynamic 15.39 ms "
                        "(+71%)")
QUICKSTART_FIRST_TOL = 1e-5   # relative: one forward pass, f32 sums
QUICKSTART_LAST_TOL = 1e-3    # the CPU test's (tests/test_torch_examples.py)
Q4_EXAMPLE_LAUNCHES = 1 + 4   # the kernel section's one, the tuner's four
# (e) llama-100m: run A straight, run B relaunched on A's step-100
# checkpoint (the example writes one every 100 steps), each with these
# arguments.  The step is host-bound at ~350-430 ms on the card's host
# (PERF.md), so 300 + 100 steps would take ~180 s and carry the script
# past its 1200 s; 125 + 25 steps keep every check.
EXAMPLE_TRAIN_STEPS = 125
EXAMPLE_TRAIN_EVERY = 25          # every printed step an uneven-DP step
EXAMPLE_TRAIN_ARGV = ["--steps", str(EXAMPLE_TRAIN_STEPS),
                      "--uneven-every", str(EXAMPLE_TRAIN_EVERY)]
EXAMPLE_TRAIN_STOP = 100
EXAMPLE_TRAIN_TOKENS = 16 * 128   # a step's batch
EXAMPLE_TRAIN_LINE = re.compile(r"\[100m\] step +(\d+) loss=(\S+)"
                                r"(?: uneven counts=(.*))?")


def run_example(main, argv, **kwargs) -> tuple:
    """An example's ``main(argv)`` with its printout captured and echoed;
    returns (lines, main's result)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv, **kwargs)
    lines = buf.getvalue().splitlines()
    for line in lines:
        say(f"[smoke]   {line}")
    return lines, result


def expect_lines(name: str, lines: list) -> None:
    if lines != EXAMPLE_LINES[name]:
        raise AssertionError(f"{name}: lines {lines} differ from the "
                             f"reference's {EXAMPLE_LINES[name]}")


def expect_no_launch(counts, what: str) -> None:
    got = counts.read()
    if any(got.values()):
        raise AssertionError(f"{what}: no kernel is on its path, yet {got} "
                             f"launched")


def token_gap(cfg, params, prompt, a, b) -> float:
    """Where two generations of one prompt first part: |logit(a) -
    logit(b)| / max|logit| at the first one's context there (one plain
    forward on the CPU)."""
    from repro_torch.models import forward

    i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
    ctx = np.concatenate([np.asarray(prompt, np.int64),
                          np.asarray(a[:i], np.int64)])
    with torch.no_grad():
        lg = forward(cfg, params, torch.as_tensor(ctx[None, :])).logits[0, -1]
    return float((lg[a[i]] - lg[b[i]]).abs() / lg.abs().max())


def example_quickstart(counts, ex) -> dict:
    """(b) The scheduler line against the reference's; the card's 30
    training steps against a CPU run of the same module (the same seeded
    weights): the first loss within 1e-5, the last within the CPU test's
    tolerance; the wall time of the 30 steps."""
    counts.reset()
    lines, card = run_example(ex.main, ["--device", "cuda"])
    expect_no_launch(counts, "quickstart")
    cpu = ex.demo_training("cpu")
    first, last = card["training"]["losses"][0], card["training"]["losses"][-1]
    want_first, want_last = cpu["losses"][0], cpu["losses"][-1]
    first_rel = abs(first - want_first) / abs(want_first)
    last_rel = abs(last - want_last) / abs(want_last)
    out = {"lines": lines, "losses": card["training"]["losses"],
           "cpu_losses": cpu["losses"], "first_rel": first_rel,
           "last_rel": last_rel, "steps_s": card["training"]["seconds"],
           "cpu_steps_s": cpu["seconds"]}
    say(f"[smoke] quickstart: scheduler line the reference's "
        f"{lines[0] == QUICKSTART_SCHEDULER}; reduced granite-8b 30 steps on "
        f"the card in {out['steps_s']:.2f} s (CPU {out['cpu_steps_s']:.2f} "
        f"s), loss {first:.6f} -> {last:.6f}, against the CPU's "
        f"{first_rel:.2e} / {last_rel:.2e} relative (tolerances "
        f"{QUICKSTART_FIRST_TOL:g} / {QUICKSTART_LAST_TOL:g})")
    if (lines[0] != QUICKSTART_SCHEDULER or first_rel > QUICKSTART_FIRST_TOL
            or last_rel > QUICKSTART_LAST_TOL):
        raise AssertionError(f"quickstart: {out}")
    return out


def example_q4(counts, ex, q4, q4_blocks) -> dict:
    """(c) The kernel section on the card: ``q4_matmul`` against
    ``q4_matmul_plain`` on the same inputs within the reference's f32
    tolerance; the tuner's four calls launch only the two Q4 entries; 7
    matrices quantized."""
    counts.reset()
    lines, out = run_example(ex.main, ["--device", "cuda"])
    launches = counts.read()
    x, qw, y = out["x"], out["qw"], out["y_kernel"]
    k = x.shape[1]
    plain = q4.q4_matmul_plain(x, qw, q4_blocks(k)[2])
    err = float((y - plain).abs().max())
    within = bool(torch.all((y - plain).abs()
                            <= F32_TOL * k + F32_TOL * plain.abs()))
    res = {"lines": lines, "launches": launches, "n_quantized":
           out["n_quantized"], "variant": list(out["variant"]),
           "route": out["route"], "max_abs_err": err,
           "oracle_err": out["kernel_err"], "quant_rel": out["quant_rel"],
           "agree": out["agree"]}
    say(f"[smoke] q4_inference on the card: {out['n_quantized']} matrices "
        f"quantized; q4_matmul at (8, {k}) x ({qw.out_features}, {k}) "
        f"against q4_matmul_plain: max abs err {err:.3g} (within rtol "
        f"{F32_TOL:g}, atol {F32_TOL:g}·K: {within}); launches {launches}; "
        f"the tuner chose {out['variant']}")
    if not (out["route"] == "cuda" and within and out["n_quantized"] == 7
            and launches["q4_matmul"] >= 1 and launches["int8_gemm"] == 0
            and launches["q4_matmul"] + launches["q4_matmul_db"]
            == Q4_EXAMPLE_LAUNCHES
            and tuple(out["variant"]) in (("direct",), ("ring",))):
        raise AssertionError(f"q4_inference: {res}")
    return res


def example_serving(counts, ex, name: str) -> dict:
    """(d) A serving example on the card: its lines the reference's; its
    tokens against a CPU run's (a parting reported at its logit gap)."""
    from repro_torch.configs import reduced_config
    from repro_torch.examples import seeded_params

    t0 = time.perf_counter()
    counts.reset()
    lines, card = run_example(ex.main, ["--device", "cuda"])
    expect_no_launch(counts, name)
    expect_lines(name, lines)
    cpu = ex.run("cpu")
    if name == "serve_batch":
        pairs = [(p[:8], a[8:].tolist(), b[8:].tolist())
                 for p, a, b in zip(card["tokens"], card["tokens"],
                                    cpu["tokens"])]
    else:
        pairs = [(r.prompt, list(r.generated), list(s.generated))
                 for r, s in zip(card["requests"], cpu["requests"])]
    parted = [(p, a, b) for p, a, b in pairs if a != b]
    gaps = []
    if parted:
        cfg = reduced_config("granite-8b")
        params = seeded_params(cfg, "cpu")
        gaps = [token_gap(cfg, params, p, a, b) for p, a, b in parted]
    out = {"lines": lines, "sequences": len(pairs), "parted": len(parted),
           "gaps": gaps, "wall_s": time.perf_counter() - t0}
    say(f"[smoke] {name}: the virtual-clock lines the reference's; "
        f"{len(pairs) - len(parted)} of {len(pairs)} generations equal to "
        f"the CPU's" + (f", the rest part at logit gaps "
                        f"{[f'{g:.2e}' for g in gaps]}" if gaps else "")
        + f" [{out['wall_s']:.1f} s]")
    return out


def example_train(counts, ex) -> dict:
    """(e) llama-100m at full width (f32, 56M parameters) under
    deterministic algorithms: run A ``--steps 125 --uneven-every 25``
    straight, writing its checkpoint at 100; run B the same command
    relaunched on a directory that holds that checkpoint alone, as A would
    have left it had it stopped there.  B resumes at 100: its losses of
    steps 101-125 and its line bitwise A's; every
    ``uneven counts=`` line the planner's on the pods' simulated speeds;
    A's steady step, tokens/s, 6·N·D over the step against the f32 peak,
    peak memory.  (A stop right after a checkpoint
    and the relaunch are held on the CPU by
    ``tests/test_torch_examples_train.py``.)"""
    t0 = time.perf_counter()
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    runs = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for name, d in (("A", "a"), ("B", "b")):
                if name == "B":   # hard links: nothing is copied
                    stop = f"step_{EXAMPLE_TRAIN_STOP:08d}"
                    shutil.copytree(f"{tmp}/a/{stop}", f"{tmp}/b/{stop}",
                                    copy_function=os.link)
                args = ex.build_parser().parse_args(
                    EXAMPLE_TRAIN_ARGV + ["--ckpt-dir", f"{tmp}/{d}",
                                          "--device", "cuda"])
                record, lines = [], []
                for line in ex.train(args, record=record):
                    say(f"[smoke]   {name}: {line}")
                    lines.append(line)
                runs[name] = {"lines": lines, "record": record}
                if name == "A":
                    peak = torch.cuda.max_memory_allocated()
    finally:
        torch.use_deterministic_algorithms(deterministic)
    expect_no_launch(counts, "train_100m")
    a, b = runs["A"], runs["B"]
    losses_a = [l for _, l, _ in a["record"]]
    resumed_equal = ([s for s, _, _ in b["record"]]
                     == list(range(EXAMPLE_TRAIN_STOP + 1,
                                   EXAMPLE_TRAIN_STEPS + 1))
                     and [l for _, l, _ in b["record"]]
                     == losses_a[EXAMPLE_TRAIN_STOP:])
    parsed = {k: [m.groups() for m in map(EXAMPLE_TRAIN_LINE.fullmatch,
                                          r["lines"]) if m]
              for k, r in runs.items()}
    lines_equal = (parsed["B"] == [g for g in parsed["A"]
                                   if int(g[0]) > EXAMPLE_TRAIN_STOP])
    # the counts a fresh planner gives (each run plans afresh from its
    # first step), fed back with the pods' simulated times
    from repro_torch.runtime import DeviceRuntime, UnevenBatchPlanner

    counts_ok = True
    for k, start in (("A", 0), ("B", EXAMPLE_TRAIN_STOP)):
        planner = UnevenBatchPlanner(DeviceRuntime(n_slices=4, alpha=0.3))
        want = {}
        for step in range(start + 1, EXAMPLE_TRAIN_STEPS + 1):
            if step % EXAMPLE_TRAIN_EVERY == 0:
                plan = planner.plan(4)
                planner.report(plan, plan.counts / ex.POD_SPEED)
                want[step] = str(plan.counts.tolist())
        got = {int(s): c for s, _, c in parsed[k] if c is not None}
        counts_ok &= all(want[s] == c for s, c in got.items()) and bool(got)
    resumed_line = b["lines"][1] == (f"[100m] resumed at step "
                                     f"{EXAMPLE_TRAIN_STOP}")
    step_s = [s for st, _, s in a["record"] if st > 25]
    steady = sorted(step_s)[len(step_s) // 2]
    n_params = ex.CFG.param_count()
    model_flop = 6.0 * n_params * EXAMPLE_TRAIN_TOKENS
    out = {"lines": a["lines"], "losses": losses_a, "step_s": step_s,
           "steady_step_s": steady,
           "tokens_per_s": EXAMPLE_TRAIN_TOKENS / steady,
           "n_params": n_params, "model_flop_per_step": model_flop,
           "share_of_f32_peak": model_flop / steady / F32_FLOP_PER_S,
           "peak_bytes": peak, "resumed_bitwise": resumed_equal,
           "lines_equal": lines_equal,
           "uneven_counts_ok": counts_ok,
           "wall_s": time.perf_counter() - t0}
    say(f"[smoke] llama-100m ({n_params / 1e6:.1f}M parameters, f32), "
        f"{EXAMPLE_TRAIN_ARGV}, deterministic algorithms: A straight, B "
        f"relaunched on A's step-{EXAMPLE_TRAIN_STOP} checkpoint: losses of "
        f"steps {EXAMPLE_TRAIN_STOP + 1}-{EXAMPLE_TRAIN_STEPS} bitwise A's "
        f"{resumed_equal}, lines equal {lines_equal}, uneven counts the "
        f"planner's {counts_ok}")
    say(f"[smoke] llama-100m run A: steady step {steady * 1e3:.2f} ms "
        f"(median of steps 26-{EXAMPLE_TRAIN_STEPS}), "
        f"{out['tokens_per_s']:.0f} tokens/s; "
        f"6·N·D = {model_flop / 1e12:.3f} TFLOP a step: "
        f"{out['share_of_f32_peak']:.4f} of the card's f32 peak "
        f"({F32_FLOP_PER_S / 1e12:.0f} TFLOP/s); peak "
        f"{peak / 2**30:.2f} GiB [{out['wall_s']:.1f} s]")
    if not (resumed_equal and lines_equal and counts_ok
            and resumed_line
            and all(math.isfinite(l) for l in losses_a)):
        raise AssertionError(f"train_100m: {out}")
    return out


def examples_phase(counts, q4, q4_blocks) -> dict:
    """Phase 16: the six examples of ``repro_torch.examples`` in process,
    on the card (and on the CPU where their tokens or losses are held to
    it)."""
    from repro_torch.examples import (continuous_serving, hybrid_cpu_inference,
                                      q4_inference, quickstart, serve_batch,
                                      train_100m)

    t0 = time.perf_counter()
    counts.reset()
    lines, _ = run_example(hybrid_cpu_inference.main, ["--device", "cuda"])
    expect_no_launch(counts, "hybrid_cpu_inference")
    expect_lines("hybrid_cpu_inference", lines)
    say("[smoke] hybrid_cpu_inference: its lines the reference's (virtual "
        "clock)")
    out = {"hybrid_cpu_inference": {"lines": lines},
           "quickstart": example_quickstart(counts, quickstart),
           "q4_inference": example_q4(counts, q4_inference, q4, q4_blocks),
           "serve_batch": example_serving(counts, serve_batch, "serve_batch"),
           "continuous_serving": example_serving(counts, continuous_serving,
                                                 "continuous_serving"),
           "train_100m": example_train(counts, train_100m)}
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    say(f"[smoke] examples phase: {out['wall_s']:.1f} s")
    return out


def variant_steps(tune: dict, kernel: str) -> dict:
    """Each launch variant's time per decode step's worth of launches (225
    at M = 4) and its bound, from phase 15 (a)."""
    out = {}
    for r in tune["variants"]["rows"]:
        if r["kernel"] == kernel and r["m"] == DECODE_M:
            v = out.setdefault("/".join(map(str, r["variant"])),
                               {"ms": 0.0, "bound_ms": 0.0})
            v["ms"] += r["ms"] * r["per_decode_step"]
            v["bound_ms"] += r["bound_ms"] * r["per_decode_step"]
    return out


def kernel_entries(phase2: dict, launches: dict, p2i8: dict,
                   i8_launches: int, paths: dict, tune: dict) -> list:
    """One entry per kernel: ``launches`` from its own path's serving run,
    ``paths`` its launches on every other path that drives it (each run
    with the counts set to 0 just before and read just after); ``ms``,
    ``plain_ms`` and ``bound_ms`` for one decode step's worth of its
    launches (225 at the main path's shapes, M = 4; f32 x for Q4);
    ``variants`` the same step's time through each launch variant the
    kernel tuner chooses among (phase 15)."""
    q4_variants = variant_steps(tune, "q4")
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
            "library_ms": None, "per": per, "paths": paths[name],
            "variants": {k: v for k, v in q4_variants.items()
                         if k == {"q4_matmul": "direct",
                                  "q4_matmul_db": "ring"}[name]}})

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
        "library_ms": None, "per": per, "paths": paths["int8_gemm"],
        "variants": variant_steps(tune, "int8"),
        **{f"at_m{m}": {"ms": step_sum(m, "int8_gemm_ms"),
                        "library_ms": step_sum(m, "library_ms"),
                        "library": "torch._int_mm on a - 128, + 128 * colsum"}
           for m in LIBRARY_MS}})
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--phases",
                    choices=("all", "kernels", "recurrent", "train",
                             "shard", "dryrun", "tune", "examples"),
                    default="all",
                    help="kernels: only the header and every kernel "
                         "against its plain version, with times (a quick "
                         "check of a kernel change); recurrent: the header, "
                         "the kernels at the recurrent archs' shapes and "
                         "phase 11; train: the header and phase 12; shard: "
                         "the header and phase 13; dryrun: the header and "
                         "phase 14; tune: the header and phase 15; "
                         "examples: the header and phase 16; all "
                         "(default): every phase")
    args = ap.parse_args(argv)
    # the resume check runs under deterministic algorithms, whose cuBLAS
    # calls need this set before CUDA initialises (on Hopper it is the
    # workspace PyTorch takes by default)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import int8_gemm as i8
    from repro_torch.kernels import q4_matmul as q4
    from repro_torch.kernels.compiled import q4_blocks
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import forward, init_slot_state, init_state
    from repro_torch.quant.q4 import quantize_q4_0
    from repro_torch.serving import Request

    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 plain versions
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    counts = Counts(q4, i8)
    head = header([q4, i8])
    if args.phases == "train":
        trained = train_phase(counts)
        say(f"[smoke] train only: {time.perf_counter() - t_all:.1f} s on "
            f"{head['card']}")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(
                {"card": head["card"], "build_s": head["build_s"],
                 "train": trained}, indent=1))
        say(device_line())
        return 0
    if args.phases == "shard":
        sharded = shard_phase(counts)
        say(f"[smoke] shard only: {time.perf_counter() - t_all:.1f} s on "
            f"{head['card']}")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(
                {"card": head["card"], "build_s": head["build_s"],
                 "shard": sharded}, indent=1))
        say(device_line())
        return 0
    if args.phases == "dryrun":
        dry = dryrun_phase(DryRun())
        say(f"[smoke] dry run only: {time.perf_counter() - t_all:.1f} s on "
            f"{head['card']}")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(
                {"card": head["card"], "build_s": head["build_s"],
                 "dryrun": dry}, indent=1))
        say(device_line())
        return 0
    if args.phases == "tune":
        cfg, device, params = serve_mod.setup(
            serve_mod.build_parser().parse_args(SERVE_ARGV))
        tune = tune_phase(counts, serve_mod, params, q4, i8, quantize_q4_0,
                          q4_blocks, init_state, Request,
                          np.random.default_rng(0))
        say(f"[smoke] tune only: {time.perf_counter() - t_all:.1f} s on "
            f"{head['card']}")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(
                {"card": head["card"], "build_s": head["build_s"],
                 "tune": tune}, indent=1))
        say(device_line())
        return 0
    if args.phases == "examples":
        ex = examples_phase(counts, q4, q4_blocks)
        say(f"[smoke] examples only: {time.perf_counter() - t_all:.1f} s on "
            f"{head['card']}")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(
                {"card": head["card"], "build_s": head["build_s"],
                 "examples": ex}, indent=1))
        say(device_line())
        return 0
    if args.phases == "recurrent":
        p2rec = zoo_kernels_vs_plain(q4, i8, quantize_q4_0, q4_blocks,
                                     RECURRENT_SHAPES, "recurrent shape")
        rec = recurrent_phase(counts, serve_mod, forward, init_state,
                              init_slot_state, Request,
                              np.random.default_rng(0))
        say(f"[smoke] recurrent only: {time.perf_counter() - t_all:.1f} s "
            f"on {head['card']}")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(
                {"card": head["card"], "build_s": head["build_s"],
                 "recurrent": rec, "recurrent_kernels": p2rec}, indent=1))
        say(device_line())
        return 0
    phase2 = kernels_vs_plain(q4, quantize_q4_0, q4_blocks)
    p2i8 = int8_vs_plain(i8)
    p2zoo = zoo_kernels_vs_plain(q4, i8, quantize_q4_0, q4_blocks)
    p2rec = zoo_kernels_vs_plain(q4, i8, quantize_q4_0, q4_blocks,
                                 RECURRENT_SHAPES, "recurrent shape")
    if args.phases == "kernels":
        say(f"[smoke] kernels only: {time.perf_counter() - t_all:.1f} s on "
            f"{head['card']}")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(
                {"card": head["card"], "build_s": head["build_s"],
                 "kernels": phase2["rows"],
                 "int8": {"kernels": p2i8["rows"]},
                 "zoo_kernels": p2zoo, "recurrent_kernels": p2rec},
                indent=1))
        say(device_line())
        return 0
    phase3 = serve_full_width(counts, serve_mod)
    np_rng = np.random.default_rng(0)
    wall, prof = {}, {}
    for mode, key in (("captured", "run"), ("uncaptured", "eager_run")):
        wall[mode] = decode_wall(phase3[key], Request, np_rng, "q4")
        prof[mode] = profile_decode(phase3[key], Request, np_rng, "q4")
    del phase3["eager_run"]
    phase5 = main_path_vs_plain(phase3["run"], forward, init_state, np_rng,
                                "q4", Q4_VS_PLAIN_TOL)
    params = phase3["run"].engines[0].params
    p3i8 = serve_int8(counts, serve_mod, params)
    wall_i8, prof_i8 = {}, {}
    for mode, key in (("captured", "run"), ("uncaptured", "eager_run")):
        wall_i8[mode] = decode_wall(p3i8[key], Request, np_rng, "int8")
        prof_i8[mode] = profile_decode(p3i8[key], Request, np_rng, "int8")
    del p3i8["eager_run"]
    p5i8 = main_path_vs_plain(p3i8["run"], forward, init_state, np_rng,
                              "int8", INT8_VS_PLAIN_TOL)
    torch.cuda.empty_cache()
    lanes = {"q4": serve_lanes(counts, serve_mod, params, phase3["run"],
                               init_state, init_slot_state, np_rng, "q4",
                               "q4_matmul_db"),
             "int8": serve_lanes(counts, serve_mod, params, p3i8["run"],
                                 init_state, init_slot_state, np_rng, "int8",
                                 "int8_gemm")}
    bhead = balanced_head_phase(counts, serve_mod, params, q4, q4_blocks)
    legacy = legacy_phase(serve_mod, params)
    phase4 = eager_vs_compiled(params)
    torch.cuda.empty_cache()
    topo = {"q4 dual-125h": serve_topology(
                counts, serve_mod, params, "dual-125h", "q4", "q4_matmul_db",
                Q4_VS_PLAIN_TOL, forward, init_state, Request, np_rng),
            "int8 2s-12900k": serve_topology(
                counts, serve_mod, params, "2s-12900k", "int8", "int8_gemm",
                INT8_VS_PLAIN_TOL, forward, init_state, Request, np_rng)}
    topo_eager = topology_eager_vs_compiled(counts, params)
    fleet = fleet_phase(serve_mod, params)
    torch.cuda.empty_cache()
    tune = tune_phase(counts, serve_mod, params, q4, i8, quantize_q4_0,
                      q4_blocks, init_state, Request, np_rng)
    reports = {"q4": phase3["run"].report.to_dict(),
               "int8": p3i8["run"].report.to_dict()}
    # llama2-7b's weights and engines go before the zoo's
    del phase3["run"], p3i8["run"], params
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[smoke] device memory allocated before the zoo: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    zoo = zoo_phase(counts, serve_mod, forward, init_state, Request, np_rng)
    rec = recurrent_phase(counts, serve_mod, forward, init_state,
                          init_slot_state, Request, np_rng)
    dry_run = DryRun()   # on the host's CPU while phases 12-13 run
    trained = train_phase(counts)
    sharded = shard_phase(counts, trained["olmo-1b"]["steady_step_s"])
    dry = dryrun_phase(dry_run, {
        k: trained["olmo-1b"][k] for k in ("peak_bytes", "steady_step_s")})
    examples = examples_phase(counts, q4, q4_blocks)
    paths = {"q4_matmul": {}, "q4_matmul_db": {}, "int8_gemm": {}}
    paths["q4_matmul_db"]["topology dual-125h (captured and uncaptured, "
                          "each)"] = topo["q4 dual-125h"]["launches"]
    paths["int8_gemm"]["topology 2s-12900k (captured and uncaptured, "
                       "each)"] = topo["int8 2s-12900k"]["launches"]
    for label, got in topo_eager["launches"].items():
        for name, n in got.items():
            if n:
                paths[name][f"{label} (2 layers)"] = n
    for arch, res in zoo.items():
        served = "trunk_calls" in res["q4"]
        label = (f"{arch} (full width, each serving run)" if served
                 else f"{arch} (2 layers, prefill + decode)")
        for name, quant in (("q4_matmul_db", "q4"), ("int8_gemm", "int8")):
            n = res[quant]["launches"]
            paths[name][label] = n if served else n[name]
    xl = rec[RECURRENT_SERVED]
    for name, quant in (("q4_matmul_db", "q4"), ("int8_gemm", "int8")):
        paths[name][f"{RECURRENT_SERVED} (whole, each serving run)"] = \
            xl[quant]["launches"]
    paths["int8_gemm"][f"{RECURRENT_SERVED} ({LANES} prefill lanes)"] = \
        xl["lanes"]["launches"]
    arch, n_cut = RECURRENT_CUT
    for name, quant in (("q4_matmul_db", "q4"), ("int8_gemm", "int8")):
        paths[name][f"{arch} ({n_cut} layers, prefill + decode)"] = \
            rec[arch][quant]["launches"][name]
    for mode in ("wall trunk q4", "wall trunk int8", "wall head"):
        for name, n in tune[mode]["runs"][0]["launches"].items():
            if n:
                paths[name][f"{mode} (eager shards over 4 threads, tuned, "
                            f"each run)"] = n
    for name in ("q4_matmul", "q4_matmul_db"):
        paths[name]["q4_inference example (reduced granite-8b: its kernel "
                    "section and the tuner's 4 calls)"] = \
            examples["q4_inference"]["launches"][name]
    entries = kernel_entries(phase2, phase3["launches"], p2i8,
                             p3i8["launches"], paths, tune)
    say(f"[smoke] total {time.perf_counter() - t_all:.1f} s on {head['card']}")
    if args.out:
        detail = {"card": head["card"], "build_s": head["build_s"],
                  "kernels": phase2["rows"], "launches": phase3["launches"],
                  "trunk_calls": phase3["trunk_calls"],
                  "peak_bytes": phase3["peak_bytes"],
                  "serve_wall_s": phase3["serve_wall_s"],
                  "uncaptured_serve_wall_s":
                      phase3["uncaptured_serve_wall_s"],
                  "report": reports["q4"],
                  "decode": wall, "profile": prof, "vs_plain": phase5,
                  "int8": {"kernels": p2i8["rows"],
                           "launches": p3i8["launches"],
                           "trunk_calls": p3i8["trunk_calls"],
                           "peak_bytes": p3i8["peak_bytes"],
                           "serve_wall_s": p3i8["serve_wall_s"],
                           "uncaptured_serve_wall_s":
                               p3i8["uncaptured_serve_wall_s"],
                           "report": reports["int8"],
                           "decode": wall_i8, "profile": prof_i8,
                           "vs_plain": p5i8},
                  "lanes": lanes, "balanced_head": bhead, "legacy": legacy,
                  "eager_vs_compiled": phase4, "topology": topo,
                  "topology_eager_vs_compiled": topo_eager["runs"],
                  "fleet": fleet, "zoo": zoo, "zoo_kernels": p2zoo,
                  "recurrent": rec, "recurrent_kernels": p2rec,
                  "train": trained, "shard": sharded, "dryrun": dry,
                  "tune": tune, "examples": examples}
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
