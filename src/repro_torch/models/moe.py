"""Mixture-of-Experts layer with capacity-bounded sort-based dispatch (the
reference's formulation, without its mesh branches).

Token->expert assignments are sorted by expert id, positions within each
expert segment become buffer offsets, and overflow beyond the expert's
capacity is dropped: dropped entries are routed to the buffer's last row,
``e * c - 1``, with zero weight.  Expert compute is a static (E, C, d) x
(E, d, f) batched matmul over every expert, whatever the routing; the
reference computes it outside any Pallas kernel too.

Everything stays on the device with shapes fixed by (T, E, k, C), so the
layer runs inside a captured CUDA graph: the expert counts come from a
``scatter_add_`` into a zeroed (E,) vector (no ``bincount``, no boolean
masks, no ``.item()``), and the combine is deterministic — each token's
k contributions are gathered into (T, k, d) in ascending expert order and
summed in that fixed order, never with atomics.

Two of the paper's Eq.-3 mechanisms act on the experts:
:func:`balanced_expert_assignment` computes an LPT expert->shard
permutation from the load and :func:`apply_expert_permutation` applies it
(the forward output is invariant).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from .layers import _dense

__all__ = ["default_capacity", "init_moe", "moe_fwd",
           "balanced_expert_assignment", "apply_expert_permutation"]


def default_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    m = cfg.moe
    c = math.ceil(n_tokens * m.top_k / m.n_experts * m.capacity_factor)
    return max(8, (c + 7) // 8 * 8)  # a multiple of 8, as the reference's


def init_moe(cfg: ModelConfig, gen: torch.Generator, device,
             n_rep: int = 1) -> dict:
    """Router (f32) and expert weights stacked over ``n_rep`` period
    repeats: router (n_rep, d, E), wi/wg (n_rep, E, d, f), wo (n_rep, E, f,
    d), and the shared expert's swi/swg/swo where the config has one."""
    m = cfg.moe
    dff = m.d_ff or cfg.d_ff
    d, e = cfg.d_model, m.n_experts
    dt = cfg.cdtype
    p = {
        "router": _dense(gen, (n_rep, d, e), torch.float32, device),
        "wi": _dense(gen, (n_rep, e, d, dff), dt, device),
        "wg": _dense(gen, (n_rep, e, d, dff), dt, device),
        "wo": _dense(gen, (n_rep, e, dff, d), dt, device),
    }
    if m.shared_expert:
        p["swi"] = _dense(gen, (n_rep, d, dff), dt, device)
        p["swg"] = _dense(gen, (n_rep, d, dff), dt, device)
        p["swo"] = _dense(gen, (n_rep, dff, d), dt, device)
    return p


def _dispatch(cfg: ModelConfig, xf: torch.Tensor, probs: torch.Tensor,
              c: int):
    """Sort-based dispatch of ``xf`` (T, d) into an (E, C, d) buffer.

    Returns (buf, dest, swk, counts, top_e, pick): ``dest`` (T*k,) the
    buffer row of each sorted assignment, ``swk`` its kept weight, and
    ``pick`` (T, k) the sorted positions of each token's assignments in
    ascending expert order (the combine's gather)."""
    m = cfg.moe
    t, d = xf.shape
    e, k = m.n_experts, m.top_k
    # jax.lax.top_k: descending, the lower index first on ties
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]                  # (T, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(-1)                                  # (T*k,)
    flat_w = top_p.reshape(-1)
    n = t * k
    ar = torch.arange(n, device=xf.device)
    tok_of = ar // k

    order = torch.argsort(flat_e, stable=True)
    se, sw, st = flat_e[order], flat_w[order], tok_of[order]
    counts = torch.zeros((e,), dtype=torch.int64, device=xf.device)
    counts.scatter_add_(0, se, torch.ones_like(se))
    seg_start = torch.cumsum(counts, 0) - counts                # (E,)
    seg_pos = ar - seg_start[se]
    keep = seg_pos < c
    dest = torch.where(keep, se * c + seg_pos, e * c - 1)

    # Kept rows are unique; every dropped assignment goes to one spare row
    # past the buffer (written there in any order, then cut off), so the
    # buffer holds exactly the reference's sums of zero-weighted drops.
    rows = torch.where(keep, dest, e * c)
    buf = torch.zeros((e * c + 1, d), dtype=xf.dtype, device=xf.device)
    buf.index_copy_(0, rows, xf[st])
    # where each token's assignments landed in the sorted order: sorted
    # ascending, that is ascending expert order (the sort is stable and a
    # token's k experts are distinct)
    inv = torch.empty_like(order)
    inv[order] = ar
    pick = torch.sort(inv.reshape(t, k), dim=-1).values
    swk = (sw * keep).to(xf.dtype)
    return buf[:e * c].reshape(e, c, d), dest, swk, counts, top_e, pick


def _combine(out_buf: torch.Tensor, dest, swk, pick, t: int,
             dtype) -> torch.Tensor:
    """Each token's weighted expert outputs, summed in ascending expert
    order from zero in ``dtype`` (the reference's scatter-add of the
    sorted contributions, made deterministic)."""
    e, c, d = out_buf.shape
    contrib = out_buf.reshape(e * c, d)[dest] * swk[:, None].to(out_buf.dtype)
    per_tok = contrib.to(dtype)[pick]                           # (T, k, d)
    y = torch.zeros((t, d), dtype=dtype, device=out_buf.device)
    for j in range(per_tok.shape[1]):
        y = y + per_tok[:, j]
    return y


def _expert_ffn(p: dict, buf: torch.Tensor) -> torch.Tensor:
    """Expert SwiGLU on the (E, C, d) buffer: batched matmuls over E."""
    h = F.silu(torch.bmm(buf, p["wg"])) * torch.bmm(buf, p["wi"])
    return torch.bmm(h, p["wo"])


def moe_fwd(cfg: ModelConfig, p: dict, x: torch.Tensor,
            capacity: Optional[int] = None) -> tuple:
    """x: (B, S, d) -> (y, aux) with aux = {lb_loss, load, dropped, top_e}.

    The capacity (``default_capacity`` of all B*S tokens unless given)
    decides which assignments drop, so a batch routes as one: rows of a
    batch compete for the same expert slots, as in the reference.
    ``top_e`` (B*S, k) is each token's chosen experts, best first."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e = m.n_experts

    xf = x.reshape(t, d)
    logits = xf.to(torch.float32) @ p["router"]                # (T, E) f32
    probs = torch.softmax(logits, dim=-1)

    c = capacity if capacity is not None else default_capacity(cfg, t)
    buf, dest, swk, counts, top_e, pick = _dispatch(cfg, xf, probs, c)
    out_buf = _expert_ffn(p, buf)
    y = _combine(out_buf, dest, swk, pick, t, x.dtype)
    total = torch.clamp(counts.sum(), min=1).to(torch.float32)
    dropped = 1.0 - torch.clamp(counts, max=c).sum() / total

    if m.shared_expert:
        sh = F.silu(xf @ p["swg"]) * (xf @ p["swi"])
        y = y + (sh @ p["swo"]).to(x.dtype)

    # Switch-style load-balance loss + telemetry for the capacity planner.
    frac = counts.to(torch.float32) / total
    mean_prob = probs.mean(dim=0)
    aux = {
        "lb_loss": e * torch.sum(frac * mean_prob),
        "load": counts.to(torch.float32),
        "dropped": dropped,
        "top_e": top_e,
    }
    return y.reshape(b, s, d), aux


# ------------------------------------------------------- expert placement --
def balanced_expert_assignment(load: np.ndarray, n_shards: int) -> np.ndarray:
    """LPT (longest-processing-time) expert->shard placement.

    Returns a permutation ``perm`` of expert ids such that slicing
    ``perm`` into ``n_shards`` contiguous blocks yields near-equal summed
    load per block — Eq. 3 applied to expert shards, realized as placement
    because per-shard capacity stays static.
    """
    load = np.asarray(load, dtype=np.float64)
    e = len(load)
    if e % n_shards:
        raise ValueError(f"{e} experts not divisible by {n_shards} shards")
    per = e // n_shards
    shard_load = np.zeros(n_shards)
    shard_members: list[list[int]] = [[] for _ in range(n_shards)]
    for idx in np.argsort(-load):
        open_shards = [s for s in range(n_shards)
                       if len(shard_members[s]) < per]
        s = min(open_shards, key=lambda s: shard_load[s])
        shard_members[s].append(int(idx))
        shard_load[s] += load[idx]
    return np.concatenate([np.array(ms, dtype=np.int64)
                           for ms in shard_members])


def apply_expert_permutation(p: dict, perm: np.ndarray) -> dict:
    """Permute expert-stacked params (and router columns) so that logical
    expert ``perm[i]`` lives at position ``i``.  Forward output is
    invariant."""
    perm = torch.as_tensor(np.asarray(perm), dtype=torch.int64,
                           device=p["router"].device)
    q = dict(p)
    q["router"] = p["router"][:, perm]
    for name in ("wi", "wg", "wo"):
        q[name] = p[name][perm]
    return q
