"""Decode attention (one new query per batch row against the KV cache) as a
CUDA kernel for Hopper, with its plain PyTorch version.

:func:`decode_attention` takes the grouped query ``q (B, Hkv, G, 1, hd)``
of one decode step, the slot cache ``k, v (B, Hkv, S_max, hd)`` as stored
(bf16 or f32), each row's query position and the cache's valid length, and
returns ``(B, Hkv, G, 1, hd)`` in the cache's dtype: the value of
``models/attention.py`` ``_sdpa_grouped`` at ``Sq = 1``.  It replaces no
TPU kernel (the JAX package's attention is plain jnp); see
``csrc/decode_attention.cu`` for what bounds it and its design.

The sequence is split into blocks of :func:`split_span` positions, a
length set by ``S_max`` alone, so a row's result does not depend on how
many rows ride along; each split keeps a running max and sum, and the
splits merge by log-sum-exp.  :func:`decode_attention_plain` does the same
arithmetic in plain torch ops, in float32.

The source is compiled by ``nvcc`` for ``sm_90a`` at first launch
(:mod:`._build`) and loaded with :mod:`ctypes`.  The wrapper takes CUDA
tensors only and raises on anything else (``models/attention.py`` keeps
its plain path for the CPU and the mesh).  It counts its launches in the
plain integer ``decode_attention.launches``: one per call, the split
kernel and the merge together.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.sharding.specs import is_dtensor

from . import _build

__all__ = ["decode_attention", "decode_attention_plain", "compile_library",
           "reset_launch_counts", "split_span", "SOURCE", "MAX_GROUP"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"

MAX_GROUP = 16          # query heads per KV head
_HEAD_DIMS = range(16, 257, 8)
_DTYPES = (torch.bfloat16, torch.float32)
# positions of one split block: on an H100 at the long-decode cell's shape
# (32 x 8 x 2568 x 128, mixed lengths) 384 beat 256 and 512 by 6-10%
_SPAN = 384


def split_span(s_max: int) -> int:
    """Positions per split: 384, or the whole cache where it is shorter."""
    return min(_SPAN, s_max)


def _lengths(q_pos: torch.Tensor, kv_len: torch.Tensor, b: int,
             s_max: int) -> torch.Tensor:
    """Each row's live length, ``min(q_pos + 1, kv_len, S_max)`` (B,)."""
    pos = q_pos.reshape(b, -1)[:, 0].to(torch.int64)
    length = torch.broadcast_to(kv_len.to(torch.int64), (b,))
    return torch.clamp(torch.minimum(pos + 1, length), max=s_max)


# ------------------------------------------------------------ plain version --
def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           q_pos: torch.Tensor,
                           kv_len: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain torch ops: float32 scores over each
    split of :func:`split_span` positions, masked past the row's length;
    per split the max, the sum of ``exp(score - max)`` and the P.V sums;
    the splits merged by log-sum-exp; the result in v's dtype.  A row with
    no live position attends uniformly over every position."""
    b, hkv, g, _, hd = q.shape
    s_max = k.shape[2]
    span = split_span(s_max)
    n = -(-s_max // span)
    lengths = _lengths(q_pos, kv_len, b, s_max)
    empty = lengths <= 0
    lengths = torch.where(empty, s_max, lengths)
    scale = torch.full((b,), hd ** -0.5, dtype=torch.float32,
                       device=k.device).masked_fill(empty, 0.0)
    scores = torch.einsum("bhgd,bhsd->bhgs", q[:, :, :, 0].to(torch.float32),
                          k.to(torch.float32)) * scale[:, None, None, None]
    live = torch.arange(s_max, device=k.device)[None, :] < lengths[:, None]
    scores = scores.masked_fill(~live[:, None, None, :], float("-inf"))
    pad = n * span - s_max
    scores = torch.nn.functional.pad(scores, (0, pad), value=float("-inf"))
    vs = torch.nn.functional.pad(v.to(torch.float32), (0, 0, 0, pad))
    scores = scores.reshape(b, hkv, g, n, span)
    m = scores.amax(-1)                                   # -inf: no live row
    p = torch.exp(scores - torch.where(m.isinf(), 0.0, m)[..., None])
    total = p.sum(-1)
    acc = torch.einsum("bhgns,bhnsd->bhgnd", p, vs.reshape(b, hkv, n, span,
                                                             hd))
    w = torch.exp(m - m.amax(-1, keepdim=True))           # 0 for a dead split
    out = (acc * w[..., None]).sum(-2) / (total * w).sum(-1)[..., None]
    return out[:, :, :, None].to(v.dtype)


# ------------------------------------------------------------------- build --
def compile_library(force: bool = False) -> Tuple[Path, str]:
    """Compile ``csrc/decode_attention.cu`` (see
    :func:`._build.compile_library`); returns the shared library's path and
    nvcc's log."""
    return _build.compile_library(SOURCE, force=force)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return _build.load_library(SOURCE, {"decode_attention": [
        ci, ci, vp, ll, ll, ll, vp, vp, ll, ll, ll, ll, ll, ll,
        vp, ci, ll, vp, ci, ll, ci, ci, ci, ci, ci, ci, ctypes.c_float,
        vp, vp, vp, vp]})


# ----------------------------------------------------------------- wrapper --
def _check(q, k, v, q_pos, kv_len) -> None:
    """What the kernel takes: CUDA tensors on one device (no DTensor); q
    (B, Hkv, G, 1, hd) in bf16 or f32 with unit stride in hd; k and v of
    one shape (B, Hkv, S_max, hd) and one dtype, bf16 or f32, unit stride
    in hd and 16-byte aligned rows; hd a multiple of 8 in [16, 256]; G at
    most 16; q_pos (B, 1) or (B,) and kv_len () or (B,), int32 or int64."""
    if q.dim() != 5 or q.shape[3] != 1:
        raise ValueError(f"q must be (B, Hkv, G, 1, hd), got "
                         f"{tuple(q.shape)}")
    b, hkv, g, _, hd = q.shape
    if k.dim() != 4 or tuple(k.shape) != tuple(v.shape) or \
            (k.shape[0], k.shape[1], k.shape[3]) != (b, hkv, hd):
        raise ValueError(f"k and v must be (B, Hkv, S_max, hd) = "
                         f"({b}, {hkv}, S_max, {hd}), got {tuple(k.shape)} "
                         f"and {tuple(v.shape)}")
    if k.dtype not in _DTYPES or v.dtype != k.dtype:
        raise ValueError(f"k and v must both be bfloat16 or float32, not "
                         f"{k.dtype} and {v.dtype}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q must be bfloat16 or float32, not {q.dtype}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the kernel takes multiples of 8 "
                         f"from 16 to 256")
    if not 1 <= g <= MAX_GROUP:
        raise ValueError(f"{g} query heads per KV head: the kernel takes 1 "
                         f"to {MAX_GROUP}")
    for name, t in (("q_pos", q_pos), ("kv_len", kv_len)):
        if t.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"{name} must be int32 or int64, not {t.dtype}")
    if q_pos.numel() != b or (kv_len.numel() not in (1, b)) or \
            kv_len.dim() > 1:
        raise ValueError(f"q_pos must hold one position per row and kv_len "
                         f"one length or one per row, got "
                         f"{tuple(q_pos.shape)} and {tuple(kv_len.shape)}")
    if q.stride(4) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("q, k and v must be contiguous along hd")
    size = k.element_size()
    for name, t in (("k", k), ("v", v)):
        if any(t.stride(i) * size % 16 for i in range(3)):
            raise ValueError(f"{name}'s rows must be 16-byte aligned")
    if b > 65535:
        raise ValueError(f"{b} rows: the grid takes at most 65,535")
    tensors = {"q": q, "k": k, "v": v, "q_pos": q_pos, "kv_len": kv_len}
    for name, t in tensors.items():
        if is_dtensor(t):
            raise ValueError(f"{name} is a DTensor: the mesh path is plain")
        if t.device.type != "cuda":
            raise ValueError(f"decode attention needs CUDA tensors, {name} "
                             f"is on {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k and v must be 16-byte aligned")


def _row_stride(t: torch.Tensor) -> int:
    """The stride between rows of a (B, ...) or (B,) tensor, 0 for one
    value shared by every row."""
    return t.stride(0) if t.dim() and t.shape[0] > 1 else 0


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """Attention of one query per row, ``q (B, Hkv, G, 1, hd)``, over the
    live positions of ``k, v (B, Hkv, S_max, hd)``: position s of row b
    counts where ``s <= q_pos[b]`` and ``s < kv_len[b]`` (``kv_len`` one
    length or one per row).  Returns ``(B, Hkv, G, 1, hd)`` in k's dtype.
    CUDA tensors only: raises on anything else."""
    _check(q, k, v, q_pos, kv_len)
    b, hkv, g, _, hd = q.shape
    s_max = k.shape[2]
    span = split_span(s_max)
    n = -(-s_max // span)
    dev = q.device
    part_acc = torch.empty((b, hkv, g, n, hd), dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty((b, hkv, g, n, 2), dtype=torch.float32, device=dev)
    out = torch.empty((b, hkv, g, 1, hd), dtype=k.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().decode_attention(
            int(k.dtype == torch.bfloat16), int(q.dtype == torch.bfloat16),
            q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
            k.data_ptr(), v.data_ptr(), k.stride(0), k.stride(1),
            k.stride(2), v.stride(0), v.stride(1), v.stride(2),
            q_pos.data_ptr(), int(q_pos.dtype == torch.int64),
            _row_stride(q_pos), kv_len.data_ptr(),
            int(kv_len.dtype == torch.int64), _row_stride(kv_len),
            b, hkv, g, s_max, hd, span, hd ** -0.5,
            part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {err} (B={b}, Hkv={hkv}, G={g}, "
                           f"S_max={s_max}, hd={hd})")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def reset_launch_counts() -> None:
    """Set the wrapper's launch count to 0."""
    decode_attention.launches = 0
