"""Kernels of the port: the Q4_0 dequant-matmul as hand-written CUDA for
Hopper, its plain torch version and oracle, the balanced kernel dispatcher
(virtual replay side), and the compiled balanced-decode lowering.

``q4_matmul.py`` holds the kernel wrappers (the CUDA sources are under
``csrc/``), ``ops.py`` the front end, ``ref.py`` the oracle,
``dispatch.py`` the per-core balanced dispatcher, ``compiled.py`` the
offsets-in / cost-tape-out lowering of every trunk projection.  (The
front end is not re-exported here: ``repro_torch.kernels.q4_matmul`` names
the kernel module.)
"""

from .dispatch import (
    GEMM_ISA,
    GEMV_ISA,
    TRUNK_KINDS,
    HybridKernelDispatcher,
    kernel_key,
)
from .compiled import CompiledDispatcher, CompiledSpec, q4_blocks
from . import ref

__all__ = [
    "ref",
    "HybridKernelDispatcher",
    "GEMM_ISA",
    "GEMV_ISA",
    "TRUNK_KINDS",
    "kernel_key",
    "CompiledDispatcher",
    "CompiledSpec",
    "q4_blocks",
]
