"""Fused Q4_0 dequant + matmul (the paper's INT4 GEMV) as CUDA kernels for
Hopper, with their plain PyTorch version.

Two kernels, one per Pallas TPU kernel of ``repro/kernels/q4_matmul.py``:

* :func:`q4_matmul` replaces ``q4_matmul_pallas`` (weights loaded straight
  into registers);
* :func:`q4_matmul_db` replaces ``q4_matmul_pallas_db`` (weights staged
  through a two-slot ``cp.async`` ring in shared memory, the next chunk in
  flight while the current one computes) — the kernel of every Q4
  projection of compiled balanced decode.

x's dtype picks the kernel body, the same for both entries: float32 x runs
on the f32 pipes (``q4_gemv_kernel``), bfloat16 x on the tensor cores
(``q4_mma_kernel``, one pass over W for every 64 rows of x; y rounded once
from the f32 sums to bf16, or written as f32 into a float32 ``out``).
Each body sums in an order set by K alone, so the entries are bitwise
equal at every shape and ``bk``, and row i of a launch equals a launch of
row i alone; see ``csrc/q4_matmul.cu`` for what bounds them and the
design.

The source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first launch (:mod:`._build`: into
``build/kernels/`` of the checkout, keyed by a hash of the source) and
loaded with :mod:`ctypes`.
A wrapper takes :func:`q4_matmul_plain` only for tensors on the CPU; for
CUDA tensors it launches its kernel or raises.  Each wrapper counts its
launches in a plain integer attribute, ``q4_matmul.launches`` and
``q4_matmul_db.launches``, and those that took the tensor-core body (bf16 x)
in ``tc_launches`` beside it.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.quant.q4 import GROUP, QuantizedLinear

from . import _build

__all__ = ["q4_matmul", "q4_matmul_db", "q4_matmul_plain", "compile_library",
           "reset_launch_counts", "DEFAULT_BLOCKS", "SOURCE"]

# (bm, bn, bk): the reference's default block tuple.  The plain version
# reads bk, the K tile, which sets its order of sums; the CUDA kernels
# only validate it.
DEFAULT_BLOCKS = (8, 256, 512)

SOURCE = Path(__file__).resolve().parent / "csrc" / "q4_matmul.cu"


# ------------------------------------------------------------ plain version --
def q4_matmul_plain(x: torch.Tensor, qw: QuantizedLinear, bk: int,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x (M, K) @ dequant(W (N, K)).T`` in plain torch ops, mirroring the
    TPU kernel body: per K tile of ``bk`` columns, the low-plane matmul then
    the high-plane matmul, accumulated in float32; the result in
    ``out_dtype`` (x's dtype when None)."""
    m, k = x.shape
    n = qw.packed.shape[0]
    if qw.packed.shape[1] * 2 != k:
        raise ValueError("K mismatch between x and packed weights")
    if bk % GROUP or k % bk:
        raise ValueError(f"bk={bk} must be a multiple of {GROUP} dividing "
                         f"K={k}")
    groups, half = bk // GROUP, bk // 2
    x32 = x.to(torch.float32)
    acc = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for kt in range(k // bk):
        p = qw.packed[:, kt * half:(kt + 1) * half].reshape(n, groups,
                                                            GROUP // 2)
        s = qw.scales[:, kt * groups:(kt + 1) * groups].to(
            torch.float32)[..., None]
        w_lo = (((p & 0x0F).to(torch.float32) - 8.0) * s).reshape(n, half)
        w_hi = (((p >> 4).to(torch.float32) - 8.0) * s).reshape(n, half)
        xt = x32[:, kt * bk:(kt + 1) * bk].reshape(m, groups, GROUP)
        acc += xt[:, :, :GROUP // 2].reshape(m, half) @ w_lo.T
        acc += xt[:, :, GROUP // 2:].reshape(m, half) @ w_hi.T
    return acc.to(out_dtype or x.dtype)


# ------------------------------------------------------------------- build --
def compile_library(force: bool = False) -> Tuple[Path, str]:
    """Compile ``csrc/q4_matmul.cu`` (see :func:`._build.compile_library`);
    returns the shared library's path and nvcc's log."""
    return _build.compile_library(SOURCE, force=force)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    args = [ci, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
    return _build.load_library(SOURCE, {"q4_matmul": args,
                                        "q4_matmul_db": args})


# ---------------------------------------------------------------- wrappers --
def _check(x: torch.Tensor, qw: QuantizedLinear, bk: int) -> None:
    """What the kernels take: contiguous row-major tensors on one CUDA
    device, x f32/bf16 (16-byte aligned), packed u8 (N, K/2), scales f16
    (N, K/32), and a K tile bk = 32 * G with G a power of two <= 32."""
    packed, scales = qw.packed, qw.scales
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K), got shape {tuple(x.shape)}")
    m, k = x.shape
    n = packed.shape[0]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, not {x.dtype}")
    if packed.dtype != torch.uint8 or scales.dtype != torch.float16:
        raise ValueError("Q4_0 weights must be uint8 packed + float16 scales")
    if tuple(packed.shape) != (n, k // 2) or \
            tuple(scales.shape) != (n, k // GROUP) or k % GROUP:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, packed "
                         f"{tuple(packed.shape)}, scales {tuple(scales.shape)}")
    g = bk // GROUP
    if bk % GROUP or k % bk or g > 32 or g & (g - 1):
        raise ValueError(f"bk={bk}: the kernels take 32 * 2**i <= 1024 "
                         f"dividing K={k}")
    for name, t in (("x", x), ("packed", packed), ("scales", scales)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError("x and packed must be 16-byte aligned")
    if max(m, n, k) >= 2 ** 31:
        raise ValueError("dimensions must fit in int32")


def _launch(wrapper, entry: str, x: torch.Tensor, qw: QuantizedLinear,
            bk: int, out: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch ``entry`` into ``out`` (or a new tensor) and add one to
    ``wrapper.launches``, and to ``wrapper.tc_launches`` for bf16 x (an
    empty product launches nothing and counts nothing).  x that is not
    contiguous or not 16-byte aligned is copied to the kernels' layout."""
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    _check(x, qw, bk)
    m, k = x.shape
    n = qw.packed.shape[0]
    bf16 = x.dtype == torch.bfloat16
    y, ldy = _build.output(out, m, n, _out_dtype(x, out), x.device)
    if m == 0 or n == 0:
        return y
    fn = getattr(_library(), entry)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        types = 0 if not bf16 else 1 if y.dtype == torch.bfloat16 else 2
        err = fn(types, x.data_ptr(),
                 qw.packed.data_ptr(), qw.scales.data_ptr(), y.data_ptr(),
                 m, n, k, bk, ldy, stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err} "
                           f"(M={m}, N={n}, K={k}, bk={bk})")
    wrapper.launches += 1
    if bf16:
        wrapper.tc_launches += 1
    return y


def _route(x: torch.Tensor) -> bool:
    """True for the plain path (CPU tensors); False for the kernel (CUDA
    tensors); raises for any other device."""
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"no Q4 kernel for device {x.device}")


def _out_dtype(x: torch.Tensor, out: Optional[torch.Tensor]) -> torch.dtype:
    """y's dtype: x's, or float32 where bf16 x is written into a float32
    ``out``."""
    if out is not None and x.dtype == torch.bfloat16 and \
            out.dtype == torch.float32:
        return torch.float32
    return x.dtype


def _plain(x: torch.Tensor, qw: QuantizedLinear, bk: int,
           out: Optional[torch.Tensor]) -> torch.Tensor:
    y = q4_matmul_plain(x, qw, bk, _out_dtype(x, out))
    return y if out is None else out.copy_(y)


def q4_matmul(x: torch.Tensor, qw: QuantizedLinear, bk: int, *,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x (M, K) f32/bf16 @ dequant(Q4_0 (N, K)).T -> (M, N)`` in x's dtype
    (replaces ``q4_matmul_pallas``), written into ``out`` when given (a
    row-major (M, N) tensor whose rows may lie further apart than N; of x's
    dtype, or float32 for bf16 x: the f32 sums unrounded)."""
    if _route(x):
        return _plain(x, qw, bk, out)
    return _launch(q4_matmul, "q4_matmul", x, qw, bk, out)


def q4_matmul_db(x: torch.Tensor, qw: QuantizedLinear, bk: int, *,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same product with the K stream double-buffered through shared
    memory (replaces ``q4_matmul_pallas_db``); bitwise equal to
    :func:`q4_matmul` at every ``bk``."""
    if _route(x):
        return _plain(x, qw, bk, out)
    return _launch(q4_matmul_db, "q4_matmul_db", x, qw, bk, out)


def reset_launch_counts() -> None:
    """Set both wrappers' launch counts, and their tensor-core counts, to 0."""
    for wrapper in (q4_matmul, q4_matmul_db):
        wrapper.launches = 0
        wrapper.tc_launches = 0


reset_launch_counts()
