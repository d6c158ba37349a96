#!/usr/bin/env python3
"""Time builds of the int8 kernel against each other on one NVIDIA GPU.

    python3 scripts/int8_gemm_variants.py [--out FILE.json] \
        [--variant NAME=CONST=VALUE[,CONST=VALUE...] ...] \
        [--source NAME=PATH ...] [--iters N]

Each variant is a copy of ``src/repro_torch/kernels/csrc/int8_gemm.cu``
with other values of its tuning constants (``kMtSmall``, ``kStagesSmall``,
``kMtLarge``, ``kMtWide``, ``kStagesLarge``, ``kWarps``, ``kWPrefetch``),
written under ``build/variants/``; each ``--source`` is another file with
the same C entry (an older kernel unpacked from git, say).  Without
``--variant`` a fixed sweep runs.  All are built in parallel by one
``nvcc`` each, held bitwise against ``int8_gemm_plain`` at every shape and
M, and timed as ``chip_smoke.py`` times the kernel (CUDA events over
``--iters`` launches, weights rotated past the 50 MB L2), in turns: every
build at one (shape, M) before the next.  ``torch._int_mm`` is timed
beside them where it runs (M > 16); at M = 1 so are an empty kernel
(``torch.cuda._sleep(0)``: the cost of a launch in this loop) and
``torch.amax`` over the weights (a library kernel that reads the same
bytes).  Prints one line per (shape, M) and a decode step's worth (225
launches) per build and M.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import int8_gemm as I8  # noqa: E402

MS = (1, 4, 8, 16, 32, 64)
SWEEP = {  # name: constants that differ from the source's
    "default": "",
    "no-l2-prefetch": "kWPrefetch=false",
    "small-s4": "kStagesSmall=4",
    "small-s8": "kStagesSmall=8",
    "small-mt2": "kMtSmall=2",
    "wide-off": "kMtWide=2",
    "wide-off-s4": "kMtWide=2,kStagesLarge=4",
    "warps4-mt2": "kWarps=4,kMtSmall=2",
}


def variant_source(name: str, consts: str, out_dir: Path) -> Path:
    """The kernel source with ``consts`` ("kA=1,kB=2") in place of its own
    values, as ``out_dir/<name>.cu`` (the source itself when empty)."""
    if not consts:
        return I8.SOURCE
    text = I8.SOURCE.read_text()
    for item in consts.split(","):
        const, value = item.split("=")
        text, n = re.subn(rf"(constexpr \w+ {const} = )[^;]+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise ValueError(f"{const} is not a constant of "
                             f"{I8.SOURCE.name}")
    path = out_dir / f"{name}.cu"
    path.write_text(text)
    return path


def build(name: str, source: Path, out_dir: Path) -> Path:
    """nvcc ``source`` with the repo's flags into ``out_dir/lib<name>.so``;
    raises with nvcc's log on failure."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    out = out_dir / f"lib{name}.so"
    proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-o", str(out),
                           str(source)], capture_output=True, text=True,
                          check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[variants] {name} ptxas: {line.strip()}", flush=True)
    return out


def entry(path: Path):
    """The library's ``int8_gemm`` as a function of (a, w) -> s32 out."""
    lib = ctypes.CDLL(str(path))
    fn = lib.int8_gemm
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
    fn.restype = ctypes.c_int

    def run(a, w, out):
        m, k = a.shape
        n = w.shape[0]
        err = fn(a.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, n,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{path.name}: cudaError {err} at "
                               f"M={m} N={n} K={k}")
        return out
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=CONST=VALUE[,...]",
                    help="a build with other values of the constants")
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH", help="another source, same C entry")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--out", default=None, help="write every time as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("int8_gemm_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    variants = dict(v.split("=", 1) for v in args.variant) or SWEEP
    specs = [(n, variant_source(n, c, out_dir), c)
             for n, c in variants.items()]
    specs += [(n, Path(p), "") for n, p in
              (s.split("=", 1) for s in args.source)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(specs)) as pool:
        futs = {n: pool.submit(build, n, src, out_dir)
                for n, src, _ in specs}
    runs = {}
    for n, fut in futs.items():
        try:
            runs[n] = entry(fut.result())
        except RuntimeError as err:   # a variant that does not build
            print(f"[variants] {n} skipped: {err}", flush=True)
    print(f"[variants] {len(runs)} builds in {time.perf_counter() - t0:.1f} "
          f"s: " + "; ".join(f"{n} [{f or src}]" for n, src, f in specs),
          flush=True)

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for label, n, k, per in chip_smoke.SHAPES:
        w = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
        copies = max(2, math.ceil(2 * chip_smoke.L2_BYTES / w.numel()))
        banks = [w.clone() for _ in range(copies)]
        corr = 128 * torch.sum(w, dim=-1, dtype=torch.int32)[None, :]
        for m in MS:
            a = torch.randint(0, 256, (m, k), generator=gen, device="cuda",
                              dtype=torch.int32).to(torch.uint8)
            want = I8.int8_gemm_plain(a, w)
            out = torch.empty((m, n), dtype=torch.int32, device="cuda")
            times = {}
            for name, run in runs.items():
                out.fill_(-1)
                if not torch.equal(run(a, w, out), want):
                    raise AssertionError(f"{name} != plain at {label} M={m}")
                times[name] = chip_smoke.device_ms(
                    run, [(a, bank, out) for bank in banks], args.iters)
            if m == 1:   # yardsticks that do not depend on M
                times["empty"] = chip_smoke.device_ms(
                    torch.cuda._sleep, [(0,)], args.iters)
                times["read"] = chip_smoke.device_ms(
                    torch.amax, [(bank.view(torch.int64),) for bank in banks],
                    args.iters)
            if m > 16:
                a_s8 = (a ^ 0x80).view(torch.int8)
                times["_int_mm"] = chip_smoke.device_ms(
                    chip_smoke.int8_library,
                    [(a_s8, bank, corr) for bank in banks], args.iters)
            bound, _ = chip_smoke.i8_bound_ms(m, n, k)
            rows.append({"shape": label, "n": n, "k": k, "m": m,
                         "per_decode_step": per, "bound_ms": bound,
                         "ms": times})
            print(f"[variants] {label:11s} M={m:2d} bound "
                  f"{bound * 1e3:6.2f} us  " + "  ".join(
                      f"{name} {t * 1e3:7.2f}" for name, t in times.items()),
                  flush=True)
        del banks
        torch.cuda.empty_cache()
    for m in MS:
        at = [r for r in rows if r["m"] == m]
        bound = sum(r["bound_ms"] * r["per_decode_step"] for r in at)
        steps = {name: sum(r["ms"][name] * r["per_decode_step"] for r in at)
                 for name in at[0]["ms"]}
        print(f"[variants] decode step M={m:2d}: bound {bound:.3f} ms  " +
              "  ".join(f"{name} {t:.3f}" for name, t in steps.items()),
              flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": smi, "builds": {n: f or str(src) for n, src, f in specs},
             "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
