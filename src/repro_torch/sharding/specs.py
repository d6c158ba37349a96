"""Sharding rules: FSDP(+pod) x TP/EP layouts for every param/state, as
DTensor placements.

Layout summary (mesh axes ``("pod",)? + ("data", "model")``), the
reference's (``repro.sharding.specs``) rule for rule:

* FSDP: the non-TP dim of every matrix is sharded over ``fsdp_axes`` =
  ("pod","data") on the multi-pod mesh, ("data",) on one pod — weights,
  moments and grad accumulators all scale 1/(pod*data).
* TP: attention heads / MLP hidden / vocab shard over "model".
* EP: MoE expert dim shards over "model".
* Mamba/xLSTM: channel dim (d_inner / heads) shards over "model".
* Stacked-period params carry a leading (n_periods) axis -> prepend None.

A :class:`Sharding` is a mesh and a **spec**: a tuple with one entry per
tensor dim (trailing entries may be left out), each ``None``, an axis name
or a tuple of axis names — entry for entry the reference's
``PartitionSpec``, normalized as jax normalizes it (a one-name tuple is
the name).  Its :attr:`Sharding.placements` are DTensor's, one per mesh
dim: mesh dim ``a`` gets ``Shard(i)`` if tensor dim ``i``'s entry names
``a`` and ``a`` has more than one rank, and ``Replicate()`` otherwise; an
entry ``("pod", "data")`` shards its dim over both, pod-major, as jax
does.

The spec functions read only axis names and sizes, so they take a live
:class:`~torch.distributed.device_mesh.DeviceMesh` or a
:class:`MeshLayout` (names and sizes, no process group): the placements
of a 512-device mesh are computed in one process.  ``_fit_spec``
replicates every dim its axes do not divide, so every shard is even;
:func:`distribute` asserts that and builds no uneven DTensor.

Where DTensor's own choice would raise or move far more than GSPMD
does, the model goes through :func:`reshape` (a head split the model
axis does not divide), :func:`gather_fsdp` (a layer's weights, where the
layer runs) and :func:`copy_into` (a recurrent state advanced in its own
layout); each is the plain operation off a mesh.

``torch.distributed.tensor`` is imported only where a mesh is in use: it
brings ~70k objects that every full garbage collection then walks, which
slows the host's Python loops (the serving feedback) of a run that never
shards.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math
import re
import sys
from dataclasses import dataclass
from typing import Any, NamedTuple

from repro_torch.tree import leaves_with_path, map_with_path, tree_map

__all__ = ["MeshLayout", "Sharding", "layout_of", "is_dtensor",
           "is_sharded", "shard_offsets", "fsdp_axes",
           "data_axes", "param_shardings", "state_shardings",
           "batch_shardings", "opt_shardings", "distribute",
           "activation_sharding", "constrain", "constrain_tree", "reshape",
           "gather_fsdp", "copy_into", "current_mesh"]


class MeshLayout(NamedTuple):
    """A mesh's axis names and sizes, without devices."""
    axis_names: tuple
    dims: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.dims))


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor, without importing DTensor's module (no
    DTensor exists before it is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def is_sharded(x, dim: int) -> bool:
    """Whether ``x`` is a DTensor whose tensor dim ``dim`` is split over a
    mesh dim (``Shard(dim)``)."""
    if not is_dtensor(x):
        return False
    dim %= x.dim()
    return any(getattr(p, "dim", None) == dim and p.is_shard()
               for p in x.placements)


def shard_offsets(t) -> list:
    """Where this rank's local shard of DTensor ``t`` starts, per tensor
    dim (even shards; a dim split over several mesh dims in mesh order,
    as :attr:`Sharding.placements` lays it out)."""
    coord = t.device_mesh.get_coordinate()
    sizes = t.device_mesh.shape
    local = t.to_local().shape
    out = []
    for d in range(t.dim()):
        chunk = 0
        for m, p in enumerate(t.placements):
            if p.is_shard() and p.dim == d:
                chunk = chunk * sizes[m] + coord[m]
        out.append(chunk * local[d])
    return out


def layout_of(mesh) -> MeshLayout:
    """The layout of a :class:`MeshLayout` or a named ``DeviceMesh``."""
    if isinstance(mesh, MeshLayout):
        return mesh
    return MeshLayout(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def _sizes(mesh) -> dict:
    return layout_of(mesh).shape


def P(*entries) -> tuple:
    """A spec, normalized as ``jax.sharding.PartitionSpec`` normalizes its
    entries: a one-name tuple is the name, an empty one is None."""
    out = []
    for e in entries:
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = None if not e else (e[0] if len(e) == 1 else e)
        out.append(e)
    return tuple(out)


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclass(frozen=True)
class Sharding:
    """A mesh (``DeviceMesh`` or :class:`MeshLayout`) and a spec."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        lay = layout_of(self.mesh)
        names = lay.axis_names
        out = [Replicate() for _ in names]
        for i, entry in enumerate(self.spec):
            axes = _names(entry)
            # DTensor shards one tensor dim over several mesh dims in mesh
            # order: the entry must list them in that order, as jax does
            assert list(axes) == sorted(axes, key=names.index), self.spec
            for a in axes:
                # over a mesh dim of size 1 its one rank holds the whole dim
                # either way; DTensor's views refuse to flatten a size-1
                # tensor dim marked Shard (a microbatch of one row)
                if lay.shape[a] > 1:
                    out[names.index(a)] = Shard(i)
        return tuple(out)


def fsdp_axes(mesh):
    pod = "pod" in layout_of(mesh).axis_names
    return ("pod", "data") if pod else ("data",)


def data_axes(mesh):
    pod = "pod" in layout_of(mesh).axis_names
    return ("pod", "data") if pod else ("data",)


# --------------------------------------------------------------- params ---
def _param_spec(path: str, leaf, fsdp) -> tuple:
    """Spec for one parameter, from its tree path."""
    f = fsdp
    rules: list[tuple[str, tuple]] = [
        # embeddings
        (r"embed/tok$", P("model", f)),
        (r"embed/out$", P(f, "model")),
        # attention
        (r"mixer/w[qkv]$", P(f, "model")),
        (r"mixer/wo$", P("model", f)),
        (r"mixer/b[qkv]$", P("model")),
        # dense mlp
        (r"ffn/w[ig]$", P(f, "model")),
        (r"ffn/wo$", P("model", f)),
        # moe
        (r"ffn/router$", P(f, None)),
        (r"ffn/w[ig]$", P("model", f, None)),      # (E, d, ff) — EP
        (r"ffn/swo$", P("model", f)),
        (r"ffn/sw[ig]$", P(f, "model")),
        # mamba
        (r"mixer/in_proj$", P(f, "model")),
        (r"mixer/conv_w$", P(None, "model")),
        (r"mixer/conv_b$", P("model")),
        (r"mixer/x_proj$", P("model", None)),
        (r"mixer/dt_proj$", P(None, "model")),
        (r"mixer/dt_bias$", P("model")),
        (r"mixer/A_log$", P("model", None)),
        (r"mixer/D$", P("model")),
        (r"mixer/out_proj$", P("model", f)),
        # mlstm / slstm: TP over 'model' on the inner dim like the other
        # mixers (the attention rule above matches w[qkv] first, as in the
        # reference)
        (r"mixer/w_(up|z)$", P(f, "model")),
        (r"mixer/w[qkv]$", P("model", None, None)),  # per-head blockdiag
        (r"mixer/w_if$", P("model", None)),
        (r"mixer/b_if$", P(None)),
        (r"mixer/w_down$", P("model", f)),
        # slstm
        (r"mixer/w_x$", P(f, "model")),
        (r"mixer/r_h$", P("model", None, None)),
        (r"mixer/bias$", P(None)),
        (r"mixer/w_out$", P(f, "model")),
    ]
    ndim = len(leaf.shape)
    for pat, spec in rules:
        if re.search(pat, path):
            if re.search(r"ffn/w[ig]$", path):
                rank = ndim - (1 if path.startswith("period") else 0)
                spec = P("model", f, None) if rank == 3 else P(f, "model")
            if path.startswith("period"):
                spec = P(None, *spec)
            return spec
    # norms / scalars / anything small: replicate
    return P(None) if not path.startswith("period") else P(None, None)


def _axis_size(mesh, axis) -> int:
    sizes = _sizes(mesh)
    return math.prod(sizes[a] for a in _names(axis))


def _fit_spec(mesh, spec: tuple, shape) -> tuple:
    """Drop (replicate) any axis that does not divide its dimension (e.g.
    kv=8 heads or 4 xLSTM heads against model=16)."""
    out = []
    for i, axis in enumerate((list(spec) + [None] * len(shape))[: len(shape)]):
        n = _axis_size(mesh, axis)
        out.append(axis if n > 1 and shape[i] % n == 0 else
                   (axis if n == 1 else None))
    return P(*out)


def _serve_spec(path: str, leaf, base: tuple) -> tuple:
    """Inference placement: weights stay stationary (no FSDP gathers).  MoE
    expert tensors shard over BOTH axes (E on 'model', ff on 'data');
    everything else drops its fsdp axis (replicated across 'data', TP over
    'model')."""
    rank = len(leaf.shape) - (1 if path.startswith("period") else 0)
    if re.search(r"ffn/w[ig]$", path) and rank == 3:
        spec = P("model", None, "data")
    elif re.search(r"ffn/wo$", path) and rank == 3:
        spec = P("model", "data", None)
    else:
        cleaned = []
        for ax in base:
            if ax is None:
                cleaned.append(None)
            elif isinstance(ax, tuple):
                kept = tuple(a for a in ax if a == "model")
                cleaned.append(kept[0] if kept else None)
            else:
                cleaned.append(ax if ax == "model" else None)
        return P(*cleaned)
    if path.startswith("period"):
        spec = P(None, *spec)
    return spec


def param_shardings(mesh, params, mode: str = "train") -> Any:
    """A :class:`Sharding` per parameter (leaves need only ``.shape``);
    ``mode="serve"`` keeps weights stationary (no FSDP axes)."""
    f = fsdp_axes(mesh)

    def one(path, leaf):
        spec = _param_spec(path, leaf, f)
        if mode == "serve":
            spec = _serve_spec(path, leaf, spec)
        return Sharding(mesh, _fit_spec(mesh, spec, leaf.shape))

    return map_with_path(one, params)


# ---------------------------------------------------------------- states --
def _state_spec(path: str, leaf, dp, batch_sharded: bool,
                phase: str = "decode") -> tuple:
    """Decode/prefill state layout.  Leading axis is n_periods (stacked).

    KV caches (P, B, Hkv, S, hd): decode shards the sequence over model;
    prefill shards heads over model when they divide 16, else the
    sequence.  Mamba h: (P, B, di, n) -> di over model.  conv: (P, B, k-1,
    di).  mLSTM c: (P, B, H, dv, dk) -> heads over model; n, m similar.
    sLSTM c/n/m/h: (P, B, d) -> d over model.
    """
    b_ax = dp if batch_sharded else None
    ndim = len(leaf.shape)
    if re.search(r"(k|v)$", path) and ndim == 5:
        if phase == "decode":
            return P(None, b_ax, None, "model", None)
        if leaf.shape[2] % 16 == 0:
            return P(None, b_ax, "model", None, None)
        return P(None, b_ax, None, "model", None)     # KVCache.k/.v
    if re.search(r"idx$", path):
        return P(None)
    if re.search(r"conv$", path):
        return P(None, b_ax, None, "model")
    if re.search(r"/h$", path) and ndim == 4:
        return P(None, b_ax, "model", None)            # mamba h
    if ndim == 5:
        return P(None, b_ax, "model", None, None)      # mlstm c
    if ndim == 4:
        return P(None, b_ax, "model", None)            # mlstm n
    if ndim == 3:
        return P(None, b_ax, "model")                  # mlstm m / slstm vecs
    return P(None)


def state_shardings(mesh, state, batch: int, phase: str = "decode") -> Any:
    dp = data_axes(mesh)
    dp_size = _axis_size(mesh, dp)
    batch_sharded = batch % dp_size == 0 and batch >= dp_size

    def one(path, leaf):
        spec = _state_spec(path, leaf, dp, batch_sharded, phase)
        return Sharding(mesh, _fit_spec(mesh, spec, leaf.shape))

    return map_with_path(one, state)


# ---------------------------------------------------------------- batch ---
def batch_shardings(mesh, batch, batch_dim: int = 0) -> Any:
    """Token/label/embed inputs: batch over ("pod","data"); for microbatched
    train inputs (n_micro leading axis) the batch dim is 1."""
    dp = data_axes(mesh)
    dp_size = _axis_size(mesh, dp)

    def one(leaf):
        shape = leaf.shape
        spec = [None] * len(shape)
        if len(shape) > batch_dim and shape[batch_dim] % dp_size == 0 and \
                shape[batch_dim] >= dp_size:
            spec[batch_dim] = dp
        return Sharding(mesh, P(*spec))

    return tree_map(one, batch)


def opt_shardings(mesh, opt, params_shardings) -> Any:
    """Optimizer state follows param sharding; factored row/col stats drop
    the last/second-last dim's axis respectively; step is replicated."""
    by_path = dict(leaves_with_path(params_shardings))

    def one(path, leaf):
        ndim = len(leaf.shape)
        m = re.match(r"(mu|nu)/(.*?)(/row|/col)?$", path)
        if not m:
            return Sharding(mesh, P())  # step
        target = by_path.get(m.group(2))
        tail = m.group(3)
        if target is None:
            return Sharding(mesh, P(*([None] * ndim)))
        spec = list(target.spec)
        spec = (spec + [None] * ndim)[: max(ndim, len(spec))]
        if tail == "/row":
            spec = spec[:-1]
        elif tail == "/col":
            spec = spec[:-2] + spec[-1:]
        spec = (spec + [None] * ndim)[:ndim]
        return Sharding(mesh, _fit_spec(mesh, P(*spec), leaf.shape))

    return map_with_path(one, opt)


# ------------------------------------------------------------ placement --
def _check_even(shape, sharding: Sharding) -> None:
    for i, entry in enumerate(sharding.spec):
        n = _axis_size(sharding.mesh, entry)
        assert shape[i] % n == 0, (
            f"uneven shard: dim {i} of {tuple(shape)} over {entry} ({n})")


def distribute(tree, shardings) -> Any:
    """Each tensor of ``tree`` as a DTensor laid out by its sharding (the
    reference's ``jax.device_put(tree, shardings)``); the mesh must be a
    live ``DeviceMesh`` on the tensors' device type.  Every rank passes the
    same full tensor; each keeps its shard."""
    from torch.distributed.tensor import distribute_tensor

    def one(x, s: Sharding):
        _check_even(x.shape, s)
        if is_dtensor(x):
            return x.redistribute(s.mesh, s.placements)
        return distribute_tensor(x, s.mesh, s.placements)

    return tree_map(one, tree, shardings)


# ------------------------------------------------ activation constraints --
# Model code calls ``constrain(x, ("dp", None, "tp"))``; the caller installs
# the mesh via ``activation_sharding(mesh)``.  With no context installed,
# or on a plain tensor, the helpers are no-ops, so single-device runs are
# untouched.

_ACT_MESH: "contextvars.ContextVar" = contextvars.ContextVar(
    "activation_mesh", default=None)


@contextlib.contextmanager
def activation_sharding(mesh):
    """Install ``mesh`` for :func:`constrain` and the MoE's mesh branches.
    Inside, a plain tensor that meets a DTensor counts as replicated over
    the mesh (DTensor's implicit replication), as an unsharded constant
    does under GSPMD: the model's positions, masks and scalars stay plain
    tensors.  Nested entries (the remat recompute inside a backward that
    runs in the context) restore the state they found, which DTensor's
    own ``implicit_replication()`` does not: it turns the flag off on
    exit."""
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    token = _ACT_MESH.set(mesh)
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before
        _ACT_MESH.reset(token)


def constrain(x, dims) -> Any:
    """dims: per-axis entries of {"dp", "tp", None} (trailing Nones may be
    omitted).  Redistributes a DTensor to the fitted placements (the
    reference's ``with_sharding_constraint``); no-op outside an
    :func:`activation_sharding` context and on a plain tensor."""
    mesh = _ACT_MESH.get()
    if mesh is None or not is_dtensor(x):
        return x
    dp = data_axes(mesh)
    spec = P(*(dp if d == "dp" else ("model" if d == "tp" else None)
               for d in dims))
    s = Sharding(mesh, _fit_spec(mesh, spec, x.shape))
    return x.redistribute(x.device_mesh, s.placements)


def _view_groups(src: tuple, dst: tuple) -> list:
    """The reshape ``src`` -> ``dst`` as groups (input dims, output dims)
    of equal element counts, in order; trailing size-1 dims are groups of
    their own."""
    groups, i, j = [], 0, 0
    while i < len(src) and j < len(dst):
        ins, outs, a, b = [i], [j], src[i], dst[j]
        i, j = i + 1, j + 1
        while a != b:
            if a < b:
                ins.append(i)
                a *= src[i]
                i += 1
            else:
                outs.append(j)
                b *= dst[j]
                j += 1
        groups.append((ins, outs))
    groups += [([k], []) for k in range(i, len(src))]
    groups += [([], [k]) for k in range(j, len(dst))]
    return groups


def reshape(x, shape) -> Any:
    """``x.reshape(shape)``; on a DTensor, each tensor dim sharded where the
    view cannot carry its shard is first made ``Replicate()`` on its mesh
    dims, as GSPMD reshards before such a reshape.  A shard survives a
    view when its dim is the first (non-unit) input dim of its group and
    the group's first (non-unit) output dim divides by the dim's number of
    shards: heads split out of a projection sharded 16 ways keep the shard
    when 16 divides the head count, and are gathered when it does not (8
    kv heads against ``"model"`` = 16).  The backward reshapes the
    gradient back by the same rule (a head merge in the forward is a split
    in the backward).  A plain tensor is reshaped as it is, so the path
    off a mesh keeps its bits."""
    if not is_dtensor(x):
        return x.reshape(shape)
    return _dtensor_reshape().apply(x, tuple(shape))


@functools.cache
def _dtensor_reshape():
    """The autograd function behind :func:`reshape` on a DTensor (made on
    first use: no DTensor import when nothing shards)."""
    import torch

    class Reshape(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, shape):
            ctx.src = tuple(x.shape)
            return _reshard_and_reshape(x, shape)

        @staticmethod
        def backward(ctx, g):
            return reshape(g, ctx.src), None

    return Reshape


def _reshard_and_reshape(x, shape):
    from torch.distributed.tensor import Replicate, Shard

    src = tuple(x.shape)
    dst = tuple(_resolve_shape(src, shape))
    sizes = tuple(x.device_mesh.shape)
    placements = list(x.placements)
    if 0 not in src:
        for ins, outs in _view_groups(src, dst):
            ins = [d for d in ins if src[d] != 1]
            outs = [d for d in outs if dst[d] != 1]
            for i in ins:
                mdims = [m for m, p in enumerate(placements)
                         if isinstance(p, Shard) and p.dim == i]
                n = math.prod(sizes[m] for m in mdims)
                if mdims and not (i == ins[0] and outs
                                  and dst[outs[0]] % n == 0):
                    for m in mdims:
                        placements[m] = Replicate()
    if tuple(placements) != tuple(x.placements):
        x = x.redistribute(x.device_mesh, placements)
    return x.reshape(dst)


def _resolve_shape(src: tuple, shape) -> tuple:
    """``shape`` with its one ``-1`` entry worked out from ``src``."""
    shape = tuple(shape)
    if -1 in shape:
        known = math.prod(d for d in shape if d != -1)
        shape = tuple(math.prod(src) // known if d == -1 else d
                      for d in shape)
    return shape


def constrain_tree(tree, shardings) -> Any:
    """Constrain a tree (e.g. grad accumulators) to given shardings leaf by
    leaf; no-op when no mesh context is installed, and on plain tensors."""
    if _ACT_MESH.get() is None or shardings is None:
        return tree
    return tree_map(
        lambda x, s: (x.redistribute(x.device_mesh, s.placements)
                      if is_dtensor(x) else x), tree, shardings)


def gather_fsdp(tree) -> Any:
    """Each DTensor of ``tree`` whole over the FSDP axes ("pod", "data"),
    its "model" placement kept: a layer's weights gathered where the layer
    uses them, as FSDP gathers them and as GSPMD lowers a batch-sharded
    product with a weight sharded on its contraction dim.  DTensor's
    per-operator choice would instead shard the activations' contraction
    dim and all-reduce the product's partial sums, a tensor of B*S*d_ff
    elements per FFN product (``python -m repro_torch.launch.hloscan``
    shows which).  The backward returns the gradient by a
    reduce-scatter.  No-op outside an :func:`activation_sharding` context
    and on plain tensors."""
    mesh = _ACT_MESH.get()
    if mesh is None:
        return tree
    from torch.distributed.tensor import Replicate

    axes = fsdp_axes(mesh)

    def one(x):
        if not is_dtensor(x):
            return x
        names = x.device_mesh.mesh_dim_names
        placements = [Replicate() if names[m] in axes else p
                      for m, p in enumerate(x.placements)]
        if tuple(placements) == tuple(x.placements):
            return x
        return x.redistribute(x.device_mesh, placements)

    return tree_map(one, tree)


def copy_into(dst, src) -> None:
    """``dst.copy_(src)``, a DTensor ``src`` first brought to ``dst``'s
    placements (DTensor refuses, in torch 2.11, an in-place op whose
    result would change the destination's placements): a recurrent
    state advanced in its own layout."""
    if is_dtensor(dst) and is_dtensor(src) and \
            tuple(src.placements) != tuple(dst.placements):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(src)


def current_mesh():
    """The mesh installed by :func:`activation_sharding` (or None)."""
    return _ACT_MESH.get()
