"""Fault-tolerant checkpointing of torch trees: atomic, versioned, in the
reference's layout.

* Atomicity: write into ``step_XXXXXXXX.tmp`` then ``os.replace`` — a crash
  mid-write never corrupts the latest valid checkpoint.
* Fault tolerance: ``latest_step``/``restore`` let a relaunched job resume
  (see ``launch/train.py``); ``keep_last`` bounds disk.
* One format for both packages: ``step_XXXXXXXX/arrays.npz`` holds every
  leaf under its path (:mod:`repro_torch.tree`, the reference's spelling:
  ``params/embed/tok``, ``opt/mu/...``, ``opt/step``) and ``meta.json``
  the step, the caller's ``extra`` and the sorted keys.  A checkpoint of
  float32 and integer leaves is read by either package.

numpy has no bfloat16 of its own, so the port writes a bfloat16 leaf as
float32 (exact) and ``restore`` casts it back to the template's dtype.  The
reference writes a bfloat16 leaf as numpy's raw two-byte void (``|V2``,
what ``np.savez`` makes of ``ml_dtypes.bfloat16``), which it cannot read
back itself; the port reads such a leaf as bfloat16 bits where the
template's leaf is bfloat16, and refuses it anywhere else.

On a mesh (the reference's elastic restore): ``save`` of a tree of
DTensors writes the full tensors, gathered on every rank, from rank 0
while the other ranks wait for it, so ``latest_step`` is the same on every
rank; ``restore(..., shardings=)`` lays each leaf out by its sharding
(:func:`repro_torch.sharding.distribute`), on any mesh whatever the one it
was saved from.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.sharding.specs import distribute, is_dtensor
from repro_torch.tree import leaves_with_path, map_with_path

__all__ = ["save", "restore", "latest_step", "all_steps"]


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    t = leaf.detach()
    if is_dtensor(t):
        t = t.full_tensor()  # a collective: every rank saves
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def _flatten(tree) -> dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in leaves_with_path(tree)}


def save(ckpt_dir: str, step: int, tree: Any, *, extra: Optional[dict] = None,
         keep_last: int = 3) -> str:
    flat = _flatten(tree)
    sharded = any(is_dtensor(leaf) for _, leaf in leaves_with_path(tree))
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if sharded and dist.get_rank() != 0:
        dist.barrier()  # rank 0 writes
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "extra": extra or {},
                   "keys": sorted(flat)}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _cleanup(ckpt_dir, keep_last)
    if sharded:
        dist.barrier()
    return final


def _cleanup(ckpt_dir: str, keep_last: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d{8})", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "meta.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _leaf(key: str, arr: np.ndarray, like: torch.Tensor,
          device: torch.device) -> torch.Tensor:
    """One stored array as a tensor of ``like``'s shape and dtype."""
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"shape mismatch for {key}: "
                         f"{arr.shape} vs {tuple(like.shape)}")
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2 or like.dtype != torch.bfloat16:
            raise ValueError(
                f"{key}: stored as raw {arr.dtype.str} bytes (the reference's "
                f"bfloat16 leaves) but the template's leaf is {like.dtype}")
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device=device, dtype=like.dtype)


def restore(ckpt_dir: str, step: int, template: Any, *,
            device="cuda", shardings: Any = None) -> tuple[Any, dict]:
    """Restore into the structure of ``template`` (only its leaves' shapes
    and dtypes are read; they may lie on the meta device), each leaf on
    ``device`` and cast to its template's dtype.  ``shardings`` (a tree of
    :class:`~repro_torch.sharding.Sharding` matching ``template``, over a
    mesh on ``device``) restores each leaf as a DTensor in that layout:
    the elastic restore onto a different mesh."""
    dev = resolve_device(device)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        tree = map_with_path(lambda key, like: _leaf(key, data[key], like,
                                                     dev), template)
    if shardings is not None:
        tree = distribute(tree, shardings)
    return tree, meta
