"""Public front end of the Q4 kernels.

``q4_matmul`` keeps the reference's block-tuple interface and its ``bk``
fix-up (the largest group multiple that divides K when the requested one
does not).  Unlike the TPU wrappers it pads nothing: the CUDA kernels mask
the ragged M and N edges themselves.  The kernel wrapper picks the route by
device: the CUDA kernel for CUDA tensors, the plain version for CPU ones.
"""

from __future__ import annotations

import torch

from repro_torch.quant.q4 import GROUP, QuantizedLinear

from . import q4_matmul as _q4

__all__ = ["q4_matmul", "fit_bk"]


def fit_bk(k: int, bk: int) -> int:
    """``bk`` if it divides ``k``, else the largest group multiple in
    (1024, 512, ..., 32) that does (the reference's ops-layer fix-up)."""
    if k % bk == 0:
        return bk
    for cand in (1024, 512, 256, 128, 64, 32):
        if k % cand == 0:
            return cand
    return GROUP


def q4_matmul(x: torch.Tensor, qw: QuantizedLinear, *,
              blocks: tuple = _q4.DEFAULT_BLOCKS) -> torch.Tensor:
    """f32/bf16 (M,K) x Q4_0 (N,K) -> (M,N) in x's dtype, through the
    direct (single-load) kernel at the fixed-up ``bk``.  K must be a
    multiple of 32 (Q4_0 groups)."""
    return _q4.q4_matmul(x, qw, fit_bk(x.shape[1], blocks[2]))
