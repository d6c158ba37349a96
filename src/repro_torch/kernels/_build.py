"""Build and load the port's CUDA kernel libraries, and check the outputs
their wrappers write.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``build/kernels/`` of the checkout (keyed by a hash of the source, so an
edited source builds anew), and loaded with :mod:`ctypes`.  There is no
fallback: a library that cannot be built raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "compile_library", "load_library",
           "output"]

# src/repro_torch/kernels/_build.py -> <checkout>/build/kernels
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def compile_library(source: Path, build_dir: Path = BUILD_DIR,
                    force: bool = False) -> Tuple[Path, str]:
    """Compile ``source`` with nvcc for sm_90a into
    ``build_dir/lib<stem>-<sha1 of the source>.so`` (unless that build
    exists and ``force`` is False).  Returns the library's path and nvcc's
    log (register and shared-memory use per kernel; empty when the build
    was found)."""
    src = source.read_bytes()
    out = build_dir / f"lib{source.stem}-{hashlib.sha1(src).hexdigest()[:12]}.so"
    if out.exists() and not force:
        return out, ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found (PATH or /usr/local/cuda/bin): "
                           f"{source.name} cannot be built")
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} "
                               f"({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees half
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stdout + proc.stderr


def load_library(source: Path,
                 entries: Dict[str, Sequence]) -> ctypes.CDLL:
    """Build ``source`` if needed and load it; every C entry named in
    ``entries`` gets its ``argtypes`` and an ``int`` (cudaError_t) return.
    Pointers and the stream must be ``c_void_p``: ctypes would otherwise
    pass them as 32-bit ints."""
    path, _ = compile_library(source)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in entries.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def output(out: Optional[torch.Tensor], m: int, n: int, dtype: torch.dtype,
           device: torch.device) -> Tuple[torch.Tensor, int]:
    """The (M, N) tensor a kernel writes and its row stride in elements:
    a new contiguous tensor when ``out`` is None, else ``out`` checked to
    be (M, N) of ``dtype`` on ``device`` with unit column stride.  Its rows
    may lie further apart than N, as in a column slice of a wider output
    (one eager shard's columns)."""
    if out is None:
        return torch.empty((m, n), dtype=dtype, device=device), n
    if tuple(out.shape) != (m, n) or out.dtype != dtype or \
            out.device != device:
        raise ValueError(f"out must be ({m}, {n}) {dtype} on {device}, got "
                         f"{tuple(out.shape)} {out.dtype} on {out.device}")
    ld = out.stride(0) if m > 1 else n
    if (n > 1 and out.stride(1) != 1) or ld < n or ld >= 2 ** 31:
        raise ValueError(f"out must be row-major, got strides {out.stride()}")
    return out, ld
