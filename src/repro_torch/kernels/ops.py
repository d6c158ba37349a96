"""Public front end of the kernels.

``q4_matmul`` keeps the reference's block-tuple interface and its ``bk``
fix-up (the largest group multiple that divides K when the requested one
does not); ``int8_gemm`` and ``int8_linear`` are the INT8 GEMM and the
full quantized linear around it.  Unlike the TPU wrappers they pad
nothing: the CUDA kernels mask their ragged edges themselves.  The kernel
wrappers pick the route by device: the CUDA kernel for CUDA tensors, the
plain version for CPU ones; given ``out=``, a column slice of a larger
output, they write straight into it (the eager shards' preallocated
output).  ``f32_matmul`` is the fp32 trunk's product, left to
``torch.matmul`` as the reference left it to XLA.

**Launch variants and the tuner.**  The reference's kernel tuner picks
among MXU block shapes (``CANDIDATE_BLOCKS``); the CUDA kernels read no
block shape (``bk`` is only validated), so the port's candidates are the
launch variants that really exist: for Q4 the direct and the ring entry
(:data:`Q4_CANDIDATES`), for int8 the kernel's five compiled x tiles
(:data:`INT8_CANDIDATES`).  Every variant of a kernel gives the same bits
(the sums' order is set by K alone, or the sums are exact integers), so a
choice changes the time and never the output.  :class:`TunedMatmul` is
the reference's front end over them: per (kernel, shape class) the
:class:`~repro_torch.core.tuner.KernelTuner` selects a variant, the
launch is timed (:func:`time_call`) and reported.  Configs are tuples of
str/int, so :class:`~repro_torch.core.tuner.TunerStore` stores them as
it stores the reference's; a reference cache loaded into the port keeps
its MXU tuples, which ``select`` never offers (it ranks only the
candidates it is given).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch.core.tuner import KernelTuner, shape_class

from repro_torch.quant.int8 import (
    QuantizedActivation,
    QuantizedWeightI8,
    u8s8_matmul_decompose,
)
from repro_torch.quant.q4 import GROUP, QuantizedLinear

from . import int8_gemm as _i8
from . import q4_matmul as _q4
from .int8_gemm import int8_gemm  # u8 (M,K) x s8 (N,K) -> s32 (M,N), exact

__all__ = ["q4_matmul", "q4_blocks", "fit_bk", "int8_gemm", "int8_linear",
           "f32_matmul", "q4_variant", "time_call", "Q4_CANDIDATES",
           "INT8_CANDIDATES", "TunedMatmul"]

# the tuner's candidates: tuples of str/int, as TunerStore encodes them
Q4_CANDIDATES = (("direct",), ("ring",))
INT8_CANDIDATES = _i8.VARIANTS
_Q4_ENTRIES = {"direct": _q4.q4_matmul, "ring": _q4.q4_matmul_db}


def fit_bk(k: int, bk: int) -> int:
    """``bk`` if it divides ``k``, else the largest group multiple in
    (1024, 512, ..., 32) that does (the reference's ops-layer fix-up)."""
    if k % bk == 0:
        return bk
    for cand in (1024, 512, 256, 128, 64, 32):
        if k % cand == 0:
            return cand
    return GROUP


def q4_blocks(k: int) -> tuple:
    """The deterministic block config every Q4 launch of the port takes for
    a reduction dim ``k`` (compiled and eager alike) — DEFAULT_BLOCKS with
    the ``bk`` fix-up.  Only its ``bk`` is read: it sets the plain version's
    order of sums; the CUDA kernels validate it and sum in an order set by
    K alone."""
    bm, bn, bk = _q4.DEFAULT_BLOCKS
    return (bm, bn, fit_bk(k, bk))


def q4_matmul(x: torch.Tensor, qw: QuantizedLinear, *,
              blocks: tuple = _q4.DEFAULT_BLOCKS,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32/bf16 (M,K) x Q4_0 (N,K) -> (M,N) in x's dtype, through the
    direct (single-load) kernel at the fixed-up ``bk``.  K must be a
    multiple of 32 (Q4_0 groups)."""
    return _q4.q4_matmul(x, qw, fit_bk(x.shape[1], blocks[2]), out=out)


def q4_variant(x: torch.Tensor, qw: QuantizedLinear, variant: tuple, *,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The Q4 product through the entry ``variant`` names (one of
    :data:`Q4_CANDIDATES`: ``("direct",)`` or ``("ring",)``) at
    :func:`q4_blocks`; bitwise equal either way."""
    entry = _Q4_ENTRIES.get(variant[0]) if len(variant) == 1 else None
    if entry is None:
        raise ValueError(f"Q4 variant {variant} is not one of "
                         f"{Q4_CANDIDATES}")
    return entry(x, qw, q4_blocks(x.shape[1])[2], out=out)


def int8_linear(a: QuantizedActivation, w: QuantizedWeightI8, *,
                plain: bool = False,
                variant: Optional[tuple] = None) -> torch.Tensor:
    """Full quantized linear (u8s8 -> s32 -> dequant f32).  ``plain=True``
    takes the kernel's plain version on any device; ``variant`` names the
    kernel's instantiation (:data:`INT8_CANDIDATES`)."""
    acc = (_i8.int8_gemm_plain(a.q, w.q) if plain
           else _i8.int8_gemm(a.q, w.q, variant=variant))
    return u8s8_matmul_decompose(a, w, acc)


def f32_matmul(x: torch.Tensor, w: torch.Tensor, *,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32 ``x (M,K) @ w (N,K).T`` by ``torch.matmul``: full float32 as long
    as TF32 is off, PyTorch's default (the fp32 trunk switches it off once,
    where it is built)."""
    return torch.matmul(x.to(torch.float32), w.T, out=out)


def time_call(fn: Callable[[], object], device: torch.device) -> tuple:
    """``(fn(), seconds it took)``: on a CUDA device by CUDA events around
    it on the current stream, read after the end event has completed; on
    the CPU by the wall clock (there every variant runs the plain version,
    so the times only exercise the tuner)."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        got = fn()
        return got, time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    got = fn()
    end.record()
    end.synchronize()
    return got, start.elapsed_time(end) * 1e-3


class TunedMatmul:
    """The reference's tuned front end: a :class:`KernelTuner` picks each
    launch's variant online (per-(kernel, shape-class) EMA argmin, the
    paper's table re-keyed), the launch is timed and reported.  The output
    does not depend on the choice."""

    def __init__(self, tuner: Optional[KernelTuner] = None):
        self.tuner = tuner or KernelTuner()

    def q4(self, x: torch.Tensor, qw: QuantizedLinear) -> torch.Tensor:
        key = ("q4_matmul", shape_class(x.shape[0], qw.out_features,
                                        x.shape[1]))
        cfg = self.tuner.select(key, Q4_CANDIDATES)
        out, secs = time_call(lambda: q4_variant(x, qw, cfg), x.device)
        self.tuner.report(key, cfg, secs)
        return out

    def int8(self, a: QuantizedActivation,
             w: QuantizedWeightI8) -> torch.Tensor:
        key = ("int8_gemm", shape_class(a.q.shape[0], w.q.shape[0],
                                        a.q.shape[1]))
        cfg = self.tuner.select(key, INT8_CANDIDATES)
        out, secs = time_call(lambda: int8_linear(a, w, variant=cfg),
                              a.q.device)
        self.tuner.report(key, cfg, secs)
        return out
