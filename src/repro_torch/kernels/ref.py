"""Plain-torch oracles for the kernels (ground truth for allclose)."""

from __future__ import annotations

import torch

from repro_torch.quant.int8 import (
    QuantizedActivation,
    QuantizedWeightI8,
    u8s8_matmul_decompose,
)
from repro_torch.quant.q4 import QuantizedLinear, dequantize_q4_0


def int8_gemm_ref(a_u8: torch.Tensor, w_s8: torch.Tensor) -> torch.Tensor:
    """u8 (M,K) x s8 (N,K) -> s32 (M,N): raw VNNI accumulation, as an
    int64 matmul (CPU tensors: CUDA has no integer matmul)."""
    return (a_u8.to(torch.int64) @ w_s8.to(torch.int64).T).to(torch.int32)


def int8_gemm_f32_ref(a: QuantizedActivation,
                      w: QuantizedWeightI8) -> torch.Tensor:
    """Full quantized linear: u8s8 accumulation + dequant to f32."""
    return u8s8_matmul_decompose(a, w, int8_gemm_ref(a.q, w.q))


def q4_matmul_ref(x: torch.Tensor, qw: QuantizedLinear) -> torch.Tensor:
    """f32/bf16 (M,K) x Q4_0 (N,K) -> (M,N): dequantize-then-matmul in f32.

    This is the paper's "Fp32-Int4-Fp32" GEMV/GEMM path (weights dequantized
    group-wise; activations stay float).
    """
    w = dequantize_q4_0(qw, dtype=torch.float32)
    return (x.to(torch.float32) @ w.T).to(x.dtype)
