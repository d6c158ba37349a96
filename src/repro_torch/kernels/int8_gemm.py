"""u8 x s8 -> s32 GEMM (the paper's INT8 GEMM) as a CUDA kernel for
Hopper, with its plain PyTorch version.

:func:`int8_gemm` replaces ``int8_gemm_pallas`` of
``repro/kernels/int8_gemm.py``; see ``csrc/int8_gemm.cu`` for what bounds
it and its design.  The sum is an exact integer, so the kernel and
:func:`int8_gemm_plain` agree bit for bit at every shape.

Launch variants: the kernel body is compiled for five x tiles
(:data:`VARIANTS`, each ``(kNT, kMT, kStages)``: tiles of 8 x rows and of
16 W rows per block, ring slots per thread).  Without ``variant=`` the C
entry picks one from M; ``variant=`` launches the one named, whatever M
is (the kernel tuner's candidates for an eager shard).  All give the
same bits.

The source is compiled by ``nvcc`` for ``sm_90a`` at first launch
(:mod:`._build`) and loaded with :mod:`ctypes`.  The wrapper takes
:func:`int8_gemm_plain` only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.  It counts its launches in the plain
integer ``int8_gemm.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["int8_gemm", "int8_gemm_plain", "compile_library",
           "reset_launch_counts", "SOURCE", "VARIANTS"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "int8_gemm.cu"

# (kNT, kMT, kStages) of every instantiation of int8_mma_kernel that
# csrc/int8_gemm.cu compiles, in the order of the M regimes
VARIANTS = ((1, 1, 6), (2, 2, 3), (4, 2, 3), (8, 2, 3), (8, 4, 3))


def int8_gemm_plain(a_u8: torch.Tensor, w_s8: torch.Tensor) -> torch.Tensor:
    """``a_u8 (M, K) @ w_s8 (N, K).T`` as s32 in plain torch ops.  The
    product is taken in float64, which is exact here and runs on both
    devices (CUDA has no int32 matmul): every product is at most
    255 * 127 = 32,385 and every partial sum stays far below 2**53, so the
    float64 sum is the integer sum in any order."""
    return (a_u8.to(torch.float64) @ w_s8.to(torch.float64).T).to(torch.int32)


def compile_library(force: bool = False) -> Tuple[Path, str]:
    """Compile ``csrc/int8_gemm.cu`` (see :func:`._build.compile_library`);
    returns the shared library's path and nvcc's log."""
    return _build.compile_library(SOURCE, force=force)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return _build.load_library(SOURCE, {
        "int8_gemm": [vp, vp, vp, ci, ci, ci, ci, vp],
        "int8_gemm_variant": [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp]})


def _check(a_u8: torch.Tensor, w_s8: torch.Tensor) -> None:
    """What the kernel takes: contiguous row-major a u8 (M, K) and w s8
    (N, K) on one device, every dimension within int32 (M within the
    grid's 65,535 tiles of 8 rows)."""
    if a_u8.dim() != 2 or w_s8.dim() != 2:
        raise ValueError(f"a and w must be 2-D, got {tuple(a_u8.shape)} and "
                         f"{tuple(w_s8.shape)}")
    if a_u8.dtype != torch.uint8 or w_s8.dtype != torch.int8:
        raise ValueError(f"a must be uint8 and w int8, not {a_u8.dtype} and "
                         f"{w_s8.dtype}")
    if a_u8.shape[1] != w_s8.shape[1]:
        raise ValueError(f"K mismatch: a {tuple(a_u8.shape)}, w "
                         f"{tuple(w_s8.shape)}")
    if w_s8.device != a_u8.device:
        raise ValueError(f"w is on {w_s8.device}, a on {a_u8.device}")
    if not (a_u8.is_contiguous() and w_s8.is_contiguous()):
        raise ValueError("a and w must be contiguous")
    m, k = a_u8.shape
    if max(w_s8.shape[0], k) >= 2 ** 31 or m > 8 * 65535:
        raise ValueError(f"shape out of range: M={m}, N={w_s8.shape[0]}, "
                         f"K={k}")


def _route(a_u8: torch.Tensor) -> bool:
    """True for the plain path (CPU tensors); False for the kernel (CUDA
    tensors); raises for any other device."""
    if a_u8.device.type == "cpu":
        return True
    if a_u8.device.type == "cuda":
        return False
    raise ValueError(f"no int8 kernel for device {a_u8.device}")


def _launch(a_u8: torch.Tensor, w_s8: torch.Tensor,
            out: Optional[torch.Tensor],
            variant: Optional[tuple] = None) -> torch.Tensor:
    """Launch the kernel (the instantiation ``variant``, else the one the C
    entry picks from M) into ``out`` (or a new tensor) and add one to
    ``int8_gemm.launches`` (an empty product launches nothing and counts
    nothing)."""
    _check(a_u8, w_s8)
    m, k = a_u8.shape
    n = w_s8.shape[0]
    out, ldc = _build.output(out, m, n, torch.int32, a_u8.device)
    if m == 0 or n == 0 or k == 0:
        return out.zero_()
    with torch.cuda.device(a_u8.device):
        stream = torch.cuda.current_stream(a_u8.device).cuda_stream
        ptrs = (a_u8.data_ptr(), w_s8.data_ptr(), out.data_ptr(), m, n, k,
                ldc)
        if variant is None:
            err = _library().int8_gemm(*ptrs, stream)
        else:
            err = _library().int8_gemm_variant(*ptrs, *variant, stream)
    if err != 0:
        raise RuntimeError(f"int8_gemm kernel launch failed: cudaError {err} "
                           f"(M={m}, N={n}, K={k}, variant={variant})")
    int8_gemm.launches += 1
    return out


def int8_gemm(a_u8: torch.Tensor, w_s8: torch.Tensor, *,
              out: Optional[torch.Tensor] = None,
              variant: Optional[tuple] = None) -> torch.Tensor:
    """``a_u8 (M, K) @ w_s8 (N, K).T -> (M, N)`` s32 (replaces
    ``int8_gemm_pallas``), written into ``out`` when given (a row-major
    (M, N) tensor whose rows may lie further apart than N).  Nothing is
    padded: the kernel masks ragged M, N and K itself.  ``variant`` (one of
    :data:`VARIANTS`) names the instantiation to launch; the plain version
    has none to choose."""
    if variant is not None and tuple(variant) not in VARIANTS:
        raise ValueError(f"int8 variant {variant} is not one of {VARIANTS}")
    if _route(a_u8):
        y = int8_gemm_plain(a_u8, w_s8)
        return y if out is None else out.copy_(y)
    return _launch(a_u8, w_s8, out, variant)


int8_gemm.launches = 0


def reset_launch_counts() -> None:
    """Set the wrapper's launch count to 0."""
    int8_gemm.launches = 0
