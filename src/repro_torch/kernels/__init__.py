"""Kernels of the port: the Q4_0 dequant-matmul and the u8 x s8 GEMM as
hand-written CUDA for Hopper, their plain torch versions and oracles, the
balanced kernel dispatcher, and the compiled balanced-decode lowering.

``q4_matmul.py`` and ``int8_gemm.py`` hold the kernel wrappers (the CUDA
sources are under ``csrc/``, built by ``_build.py``), ``ops.py`` the front
end, ``ref.py`` the oracles, ``dispatch.py`` the per-core balanced
dispatcher (eager shards and the compiled feedback replay),
``compiled.py`` the offsets-in / cost-tape-out lowering of every trunk
projection.  (The front end is not re-exported here:
``repro_torch.kernels.q4_matmul`` and ``repro_torch.kernels.int8_gemm``
name the kernel modules.)  :data:`COUNTED` lists every wrapper that
counts its launches.
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
from . import int8_gemm as _i8
from . import q4_matmul as _q4

# every kernel wrapper that counts its launches in ``.launches``
COUNTED = (_q4.q4_matmul, _q4.q4_matmul_db, _i8.int8_gemm)

__all__ = [
    "ref",
    "COUNTED",
    "HybridKernelDispatcher",
    "GEMM_ISA",
    "GEMV_ISA",
    "TRUNK_KINDS",
    "kernel_key",
    "CompiledDispatcher",
    "CompiledSpec",
    "q4_blocks",
]
