"""INT8 gradient compression with error feedback (distributed-optimization
trick for cross-pod all-reduce), the reference's codes bit for bit.

Per-tensor symmetric int8 quantization cuts gradient bytes 4x (vs f32
grads) / 2x (vs bf16); the residual (quantization error) is carried to the
next step (error feedback), which keeps SGD/Adam convergence — standard
1-bit/8-bit Adam practice.  ``x`` is divided by its scale (not multiplied
by the scale's reciprocal) and ``torch.round`` rounds half to even, as
``jnp.round`` does, so the codes equal the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.tree import tree_map

__all__ = ["Compressed", "compress", "decompress", "compress_tree",
           "decompress_tree", "init_errors"]


class Compressed(NamedTuple):
    q: torch.Tensor      # int8 payload
    scale: torch.Tensor  # () f32 per tensor


def compress(g: torch.Tensor, err: torch.Tensor
             ) -> tuple[Compressed, torch.Tensor]:
    """Quantize g + carried error; returns (payload, new_error)."""
    x = g.to(torch.float32) + err
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return Compressed(q=q, scale=scale), x - deq


def decompress(c: Compressed) -> torch.Tensor:
    return c.q.to(torch.float32) * c.scale


def compress_tree(grads, errors):
    """Tree-mapped compress; errors tree matches grads."""
    out = tree_map(compress, grads, errors)
    comp = tree_map(lambda _, o: o[0], grads, out)
    new_err = tree_map(lambda _, o: o[1], grads, out)
    return comp, new_err


def decompress_tree(comp):
    return tree_map(decompress, comp,
                    is_leaf=lambda x: isinstance(x, Compressed))


def init_errors(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
