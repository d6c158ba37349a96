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
"""

from __future__ import annotations

from typing import Optional

import torch

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
           "f32_matmul"]


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
    the ``bk`` fix-up.  The kernels read only its ``bk``, which fixes their
    order of sums."""
    bm, bn, bk = _q4.DEFAULT_BLOCKS
    return (bm, bn, fit_bk(k, bk))


def q4_matmul(x: torch.Tensor, qw: QuantizedLinear, *,
              blocks: tuple = _q4.DEFAULT_BLOCKS,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32/bf16 (M,K) x Q4_0 (N,K) -> (M,N) in x's dtype, through the
    direct (single-load) kernel at the fixed-up ``bk``.  K must be a
    multiple of 32 (Q4_0 groups)."""
    return _q4.q4_matmul(x, qw, fit_bk(x.shape[1], blocks[2]), out=out)


def int8_linear(a: QuantizedActivation, w: QuantizedWeightI8, *,
                plain: bool = False) -> torch.Tensor:
    """Full quantized linear (u8s8 -> s32 -> dequant f32).  ``plain=True``
    takes the kernel's plain version on any device."""
    gemm = _i8.int8_gemm_plain if plain else _i8.int8_gemm
    return u8s8_matmul_decompose(a, w, gemm(a.q, w.q))


def f32_matmul(x: torch.Tensor, w: torch.Tensor, *,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32 ``x (M,K) @ w (N,K).T`` by ``torch.matmul``: full float32 as long
    as TF32 is off, PyTorch's default (the fp32 trunk switches it off once,
    where it is built)."""
    return torch.matmul(x.to(torch.float32), w.T, out=out)
