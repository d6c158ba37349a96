"""Q4_0 weight-only quantization (llama.cpp-compatible layout), in torch.

Bit-identical to ``repro.quant.q4`` for the same float32 input: per group
of 32 consecutive K elements

  * scale  d = (signed absmax) / -8  (the max maps to code 0, i.e. -8)
  * codes  q = clamp(round(x / d) + 8, 0, 15), rounding half to even
    (``torch.round`` and ``jnp.round`` agree), 4 bits each
  * packing: byte j of the group holds element j in its LOW nibble and
    element j + 16 in its HIGH nibble (llama.cpp block_q4_0).

A weight matrix W of shape (N, K) is stored as
  packed : uint8 (N, K/2)    — K/32 groups of 16 bytes each
  scales : float16 (N, K/32)

Bytes per K element: 0.5 (int4) + 2/32 (scale) = 0.5625.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

GROUP = 32
BYTES_PER_ELEM = 0.5 + 2.0 / GROUP  # 0.5625


class QuantizedLinear(NamedTuple):
    """Q4_0 weights for ``y = x @ W.T`` with W logically (N, K)."""

    packed: torch.Tensor  # uint8 (N, K // 2)
    scales: torch.Tensor  # float16 (N, K // GROUP)

    @property
    def out_features(self) -> int:
        return self.packed.shape[0]

    @property
    def in_features(self) -> int:
        return self.packed.shape[1] * 2

    @property
    def nbytes(self) -> int:
        return self.packed.numel() + 2 * self.scales.numel()


def quantize_q4_0(w: torch.Tensor) -> QuantizedLinear:
    """Quantize W (N, K) to Q4_0 on W's device.  K must be a multiple of 32."""
    n, k = w.shape
    if k % GROUP:
        raise ValueError(f"K={k} must be a multiple of {GROUP}")
    g = w.reshape(n, k // GROUP, GROUP).to(torch.float32)
    # llama.cpp: d = max-by-|.| / -8 (keeps the sign of the absmax element);
    # argmax returns the first maximum, as jnp.argmax does
    idx = torch.argmax(g.abs(), dim=-1, keepdim=True)
    maxval = torch.gather(g, -1, idx)
    d = maxval / -8.0
    inv = torch.where(d == 0, torch.zeros_like(d), 1.0 / d)
    q = torch.clamp(torch.round(g * inv) + 8.0, 0.0, 15.0).to(torch.uint8)
    lo = q[..., :GROUP // 2]
    hi = q[..., GROUP // 2:]
    packed = (lo | (hi << 4)).reshape(n, k // 2)
    return QuantizedLinear(packed=packed.contiguous(),
                           scales=d[..., 0].to(torch.float16).contiguous())


def dequantize_q4_0(qw: QuantizedLinear,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Exact inverse of the packing (not of the rounding)."""
    n, half_k = qw.packed.shape
    k = half_k * 2
    b = qw.packed.reshape(n, k // GROUP, GROUP // 2)
    q = torch.cat([b & 0x0F, b >> 4], dim=-1).to(torch.float32)
    d = qw.scales.to(torch.float32)[..., None]
    return ((q - 8.0) * d).reshape(n, k).to(dtype)
