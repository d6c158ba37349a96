"""The paper's scenario end to end: llama2-7B Q4_0 inference on two hybrid
CPUs, static-OpenMP against dynamic scheduling, with the Fig. 4 ratio
trace.  The port of ``examples/hybrid_cpu_inference.py``.

  python -m repro_torch.examples.hybrid_cpu_inference [--device cuda|cpu]

Everything here runs on the machine model's virtual clock and makes no
tensor; ``--device`` is resolved as every example resolves it and not
used.  The end-to-end model (:func:`simulate` with its kernel lists,
:data:`PROMPT`, :data:`DECODE_STEPS` and :data:`Q4_BYTES_PER_ELEM`) is a
copy of what the reference takes from ``benchmarks/bench_e2e.py`` and
``benchmarks/common.py``, which the port does not import.
"""

# lint: virtual-clock-module
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import VirtualWorkerPool, make_machine
from repro_torch.device import resolve_device
from repro_torch.runtime import (CPURuntime, DynamicScheduler, KernelSpec,
                                 StaticScheduler)

__all__ = ["PROMPT", "DECODE_STEPS", "Q4_BYTES_PER_ELEM", "GEMM", "simulate",
           "lines", "main"]

PROMPT = 1024
DECODE_STEPS = 16
Q4_BYTES_PER_ELEM = 0.5625        # int4 + fp16 scale / group32

GEMM = KernelSpec("int8_gemm", "avx_vnni", granularity=16,
                  work_per_unit=2 * 1024 * 4096)


def _prefill_kernels(cfg, s: int, eff: float, attn_factor: float = 4.0):
    """(name, N, work_MACs_per_N_unit) for one layer, prefill phase."""
    d, hd = cfg.d_model, cfg.hd
    qkv_n = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    return [
        ("qkv", qkv_n, s * d / eff),
        # attention runs the fp32 (non-VNNI) path: ~4x the MAC-equivalent
        # work; static in both variants (paper: MHA is not dispatched)
        ("attn", cfg.n_heads, attn_factor * 2 * s * s * hd),
        ("wo", d, s * cfg.n_heads * hd / eff),
        ("w13", 2 * cfg.d_ff, s * d / eff),
        ("w2", d, s * cfg.d_ff / eff),
    ]


def _decode_kernels(cfg, ctx: int, eff: float):
    """(name, N, work_bytes_per_N_unit) for one layer, decode phase."""
    d, hd = cfg.d_model, cfg.hd
    qkv_n = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    kv_bytes = 2 * ctx * hd * 2  # k+v fp16 per kv head
    return [
        ("qkv", qkv_n, d * Q4_BYTES_PER_ELEM / eff),
        ("attn", cfg.n_kv_heads, kv_bytes / eff),      # static in both
        ("wo", d, cfg.n_heads * hd * Q4_BYTES_PER_ELEM / eff),
        ("w13", 2 * cfg.d_ff, d * Q4_BYTES_PER_ELEM / eff),
        ("w2", d, cfg.d_ff * Q4_BYTES_PER_ELEM / eff),
    ]


def simulate(machine_name: str, *, dynamic: bool, gemm_eff: float = 1.0,
             gemv_eff: float = 1.0, warm_iters: int = 3,
             attn_factor: float = 4.0):
    """Returns (prefill_seconds, decode_seconds_per_token) of llama2-7b on
    ``machine_name``, every GEMM/GEMV dispatched through the dynamic (or
    the static) scheduler and attention statically in both."""
    cfg = get_config("llama2-7b")
    machine = make_machine(machine_name)
    runtime = CPURuntime(machine.n_cores, alpha=0.3)

    def run_phase(isa: str, kernels, layers: int, head_work: float,
                  elt_bytes_per_layer: float = 0.0):
        pool = VirtualWorkerPool(machine, isa=isa)
        dyn = DynamicScheduler(runtime, pool)
        sta = StaticScheduler(pool)
        # norms / rope / residual / dynamic-quant passes: bandwidth-bound
        # elementwise work, outside the scheduler in both variants
        elt = elt_bytes_per_layer / machine.true_throughput("membw").sum()
        t0 = pool.clock
        for _ in range(layers):
            for name, n, work in kernels:
                spec = KernelSpec(name=name, isa=isa, granularity=8,
                                  work_per_unit=work)
                if name == "attn" or not dynamic:
                    sta.dispatch(spec, n)
                else:
                    dyn.dispatch(spec, n)
            pool.clock += elt
        head = KernelSpec(name="head", isa=isa, granularity=8,
                          work_per_unit=head_work)
        (dyn if dynamic else sta).dispatch(head, cfg.vocab_size)
        return pool.clock - t0

    elt_prefill = 20 * PROMPT * cfg.d_model  # bytes per layer
    elt_decode = 20 * cfg.d_model
    # warm the ratio table the way the paper does (first kernels adapt fast)
    for _ in range(warm_iters):
        run_phase("avx_vnni", _prefill_kernels(cfg, PROMPT, gemm_eff,
                                               attn_factor),
                  cfg.n_layers, PROMPT * cfg.d_model / gemm_eff, elt_prefill)
    prefill = run_phase("avx_vnni", _prefill_kernels(cfg, PROMPT, gemm_eff,
                                                     attn_factor),
                        cfg.n_layers, PROMPT * cfg.d_model / gemm_eff,
                        elt_prefill)
    for _ in range(warm_iters):
        run_phase("membw", _decode_kernels(cfg, PROMPT, gemv_eff),
                  cfg.n_layers, cfg.d_model * Q4_BYTES_PER_ELEM / gemv_eff,
                  elt_decode)
    decode = np.mean([
        run_phase("membw", _decode_kernels(cfg, PROMPT + i, gemv_eff),
                  cfg.n_layers, cfg.d_model * Q4_BYTES_PER_ELEM / gemv_eff,
                  elt_decode)
        for i in range(DECODE_STEPS)
    ])
    return prefill, float(decode)


def lines() -> List[str]:
    """The example's printout: each machine's static-to-dynamic prefill and
    decode, then the Fig. 4 trace of P-core 0's ratio."""
    out = []
    for machine in ("ultra-125h", "core-12900k"):
        pf_d, dec_d = simulate(machine, dynamic=True)
        pf_s, dec_s = simulate(machine, dynamic=False)
        out.append(f"[{machine}] prefill {pf_s:.2f}s -> {pf_d:.2f}s "
                   f"(+{(pf_s / pf_d - 1) * 100:.0f}%) | "
                   f"decode {1 / dec_s:.1f} -> {1 / dec_d:.1f} tok/s "
                   f"(+{(dec_s / dec_d - 1) * 100:.0f}%)")

    # Fig. 4: watch a P-core's ratio converge from the too-high init of 5,
    # then absorb a background program stealing half of core 0.
    machine = make_machine("ultra-125h")
    machine.background.append((0.05, 1e9, 0, 2.0))
    runtime = CPURuntime(machine.n_cores, alpha=0.3, init_ratio=5.0)
    sched = DynamicScheduler(runtime, VirtualWorkerPool(machine,
                                                        isa="avx_vnni"))
    trace = []
    for _ in range(30):
        sched.dispatch(GEMM, 4096)
        trace.append(runtime.ratios("avx_vnni")[0])
    t = np.array(trace)
    out.append("[fig4] P0 ratio trace: "
               + " ".join(f"{v:.2f}" for v in t[:10]) + " ...")
    out.append(f"[fig4] init 5.00 -> settled {t[-1]:.2f} "
               f"(background load at dispatch ~5 absorbed)")
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="llama2-7B Q4_0 on two "
                                             "simulated hybrid CPUs.")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; unused (virtual clock)")
    return ap


def main(argv: Optional[list] = None) -> List[str]:
    """Print the example's lines; returns them."""
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    out = lines()
    for line in out:
        print(line)
    return out


if __name__ == "__main__":
    main()
