"""Quantization substrate of the port: Q4_0 weights (llama.cpp layout) and
dynamic u8 activations against symmetric s8 weights."""

from .q4 import (
    GROUP,
    BYTES_PER_ELEM,
    QuantizedLinear,
    quantize_q4_0,
    dequantize_q4_0,
)
from .int8 import (
    QuantizedActivation,
    QuantizedWeightI8,
    quantize_u8_dynamic,
    dequantize_u8,
    quantize_s8_symmetric,
    dequantize_s8,
    u8s8_matmul_decompose,
)

__all__ = [
    "GROUP",
    "BYTES_PER_ELEM",
    "QuantizedLinear",
    "quantize_q4_0",
    "dequantize_q4_0",
    "QuantizedActivation",
    "QuantizedWeightI8",
    "quantize_u8_dynamic",
    "dequantize_u8",
    "quantize_s8_symmetric",
    "dequantize_s8",
    "u8s8_matmul_decompose",
]
