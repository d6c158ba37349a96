"""Quantization substrate of the port: Q4_0 weights (llama.cpp layout)."""

from .q4 import (
    GROUP,
    BYTES_PER_ELEM,
    QuantizedLinear,
    quantize_q4_0,
    dequantize_q4_0,
)

__all__ = [
    "GROUP",
    "BYTES_PER_ELEM",
    "QuantizedLinear",
    "quantize_q4_0",
    "dequantize_q4_0",
]
