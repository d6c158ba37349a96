"""Plain-torch oracle for the Q4 kernels (ground truth for allclose)."""

from __future__ import annotations

import torch

from repro_torch.quant.q4 import QuantizedLinear, dequantize_q4_0


def q4_matmul_ref(x: torch.Tensor, qw: QuantizedLinear) -> torch.Tensor:
    """f32/bf16 (M,K) x Q4_0 (N,K) -> (M,N): dequantize-then-matmul in f32.

    This is the paper's "Fp32-Int4-Fp32" GEMV/GEMM path (weights dequantized
    group-wise; activations stay float).
    """
    w = dequantize_q4_0(qw, dtype=torch.float32)
    return (x.to(torch.float32) @ w.T).to(x.dtype)
