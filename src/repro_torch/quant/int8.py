"""Dynamic INT8 activation quantization (the paper's GEMM operands), in
torch.

The paper's INT8 GEMM uses unsigned-INT8 activations against signed-INT8
weights (the AVX-VNNI ``vpdpbusd`` contract; on Hopper the s8 x u8
``mma.sync.m16n8k32`` of the port's ``int8_mma_kernel``, behind
``int8_gemm``).

* Activations: per-row asymmetric u8 — scale + zero-point.
* Weights: per-channel symmetric s8, carrying their int32 column sums.

Codes, scales and zero points are bit-identical to ``repro.quant.int8`` for
the same float32 input (``torch.round`` and ``jnp.round`` both round half
to even).  :func:`u8s8_matmul_decompose` is the zero-point algebra::

  y = (a_u8 - zp) @ w_s8^T * (sa * sw)
    = (a_u8 @ w_s8^T - zp * colsum(w_s8)) * (sa * sw)

The reference sums ``w_s8`` on every call; here the sums are taken once,
at quantization time (exact integers, so the same bits), which spares a
second pass over the weight and an int32 copy of it at every projection.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["QuantizedActivation", "QuantizedWeightI8", "quantize_u8_dynamic",
           "dequantize_u8", "quantize_s8_symmetric", "dequantize_s8",
           "u8s8_matmul_decompose"]


class QuantizedActivation(NamedTuple):
    q: torch.Tensor      # uint8 (M, K)
    scale: torch.Tensor  # float32 (M, 1)
    zero: torch.Tensor   # int32 (M, 1) zero-point in the u8 domain


class QuantizedWeightI8(NamedTuple):
    q: torch.Tensor       # int8 (N, K)
    scale: torch.Tensor   # float32 (N,) per output channel
    colsum: torch.Tensor  # int32 (N,) sum of each row of q

    @property
    def out_features(self) -> int:
        return self.q.shape[0]

    @property
    def in_features(self) -> int:
        return self.q.shape[1]


def quantize_u8_dynamic(x: torch.Tensor) -> QuantizedActivation:
    """Per-row asymmetric quantization to u8 (llama.cpp-style dynamic)."""
    x = x.to(torch.float32)
    xmin = torch.amin(x, dim=-1, keepdim=True)
    xmax = torch.amax(x, dim=-1, keepdim=True)
    scale = (xmax - xmin) / 255.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    zero = torch.round(-xmin / scale)
    q = torch.clamp(torch.round(x / scale) + zero, 0, 255).to(torch.uint8)
    return QuantizedActivation(q=q, scale=scale, zero=zero.to(torch.int32))


def dequantize_u8(qa: QuantizedActivation) -> torch.Tensor:
    return (qa.q.to(torch.float32) - qa.zero.to(torch.float32)) * qa.scale


def quantize_s8_symmetric(w: torch.Tensor) -> QuantizedWeightI8:
    """Per-channel symmetric s8 for weights (N, K), with their column
    sums; the codes come out contiguous (the kernel's layout) whatever
    the strides of ``w``."""
    w = w.to(torch.float32).contiguous()
    absmax = torch.amax(torch.abs(w), dim=-1)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 127.0)
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    colsum = torch.sum(q, dim=-1, dtype=torch.int32)
    return QuantizedWeightI8(q=q, scale=scale, colsum=colsum)


def dequantize_s8(qw: QuantizedWeightI8) -> torch.Tensor:
    return qw.q.to(torch.float32) * qw.scale[:, None]


def u8s8_matmul_decompose(a: QuantizedActivation, w: QuantizedWeightI8,
                          acc_s32: torch.Tensor) -> torch.Tensor:
    """Turn a raw u8*s8 s32 accumulation ``a.q @ w.q.T`` into the f32
    result, in the reference's order of operations:
    ``(acc - zero * colsum) * a.scale * w.scale``."""
    corrected = acc_s32.to(torch.float32) - (
        a.zero.to(torch.float32) * w.colsum[None, :].to(torch.float32))
    return corrected * a.scale * w.scale[None, :]
