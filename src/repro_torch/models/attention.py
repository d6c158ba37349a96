"""GQA attention with rotary embeddings, a KV cache, and query chunking, in
plain torch ops (the reference's attention is plain jnp too).

Scores are never materialized for more than one query chunk at a time
(``cfg.attn_chunk``), GQA is computed in grouped form (no KV head
repetition), and the softmax runs in float32 with ``NEG_INF`` masking.

The KV cache is updated **in place** (the reference's arrays are
immutable): :func:`attn_fwd` writes this chunk's K/V into the cache tensors
it is given and returns a :class:`KVCache` over the same storage with the
advanced ``idx``.  The write start is clamped to ``[0, S_max - s]`` exactly
as ``jax.lax.dynamic_update_slice`` clamps it (free continuous-batching
slots keep advancing past ``max_seq``), while ``kv_len = idx + s`` stays
unclamped.

On a mesh (DTensor weights and activations) the head reshapes go through
:func:`repro_torch.sharding.reshape` (a head count that the model axis
does not divide is gathered first), each rank attends its own batch rows
and heads where only those are split, a cache whose sequence is split
over ``"model"`` is written slice by slice (:func:`_write_cache_sharded`)
and its softmax reduced by max and sum; off a mesh every one of these is
the plain code, bit for bit.

On the card, one query per row against a cache (a decode step, or a
one-token chunk) goes to
:func:`repro_torch.kernels.decode_attention.decode_attention`, a CUDA
kernel that reads the cache in its own dtype and only up to each row's
live length; the CPU, the mesh and every chunk of more than one query
keep the plain code.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.sharding.specs import (is_dtensor, is_sharded, reshape,
                                        shard_offsets)
from .layers import _dense, apply_rope

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor    # (B, Hkv, S_max, hd)
    v: torch.Tensor    # (B, Hkv, S_max, hd)
    idx: torch.Tensor  # () int32 — number of valid positions; or (B,) int32
                       # for slot-batched serving where every row advances
                       # independently (continuous batching)


def init_attn(cfg: ModelConfig, gen: torch.Generator, device,
              n_rep: int = 1) -> dict:
    """Attention weights stacked over ``n_rep`` period repeats."""
    d, hd = cfg.d_model, cfg.hd
    dt = cfg.cdtype
    p = {
        "wq": _dense(gen, (n_rep, d, cfg.n_heads * hd), dt, device),
        "wk": _dense(gen, (n_rep, d, cfg.n_kv_heads * hd), dt, device),
        "wv": _dense(gen, (n_rep, d, cfg.n_kv_heads * hd), dt, device),
        "wo": _dense(gen, (n_rep, cfg.n_heads * hd, d), dt, device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((n_rep, width * hd), dtype=dt,
                                  device=device)
    return p


def _sdpa_grouped(q, k, v, q_pos, kv_pos, kv_len) -> torch.Tensor:
    """Grouped scaled-dot-product attention on one query chunk.

    q: (B, Hkv, G, Sq, hd);  k, v: (B, Hkv, Skv, hd)
    q_pos: (B, Sq) global query positions; kv_pos: (Skv,);
    kv_len: () number of valid kv entries, or (B,) per row.
    """
    if is_dtensor(q):
        local = _on_local_shards(q, k, v, q_pos, kv_pos, kv_len)
        if local is not None:
            return local
        # DTensor's einsum flattens the batch and head dims into one, which
        # torch 2.11 refuses when the heads are sharded: heads whole first
        q, k, v = (_heads_whole(t) for t in (q, k, v))
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bhgqd,bhsd->bhgqs", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if kv_len.dim() == 1:
        kv_len = kv_len[:, None, None]  # (B, 1, 1) against (B, Sq, Skv)
    allowed = (kv_pos[None, :] <= q_pos[..., None]) & (kv_pos < kv_len)
    scores = torch.where(allowed[:, None, None, :, :], scores,
                         torch.full((), NEG_INF, dtype=scores.dtype,
                                    device=scores.device))
    if is_sharded(scores, -1):
        # DTensor's softmax gathers a sharded softmax dim (a sequence-
        # sharded cache's); its max and sum reduce it by all-reduces of
        # one value per row, as GSPMD lowers a softmax
        e = torch.exp(scores - scores.amax(-1, keepdim=True))
        probs = e / e.sum(-1, keepdim=True)
    else:
        probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqs,bhsd->bhgqd", probs, v.to(torch.float32))
    return out.to(v.dtype)


def _heads_whole(t):
    """DTensor ``t`` with its head dim (1) replicated."""
    from torch.distributed.tensor import Replicate

    if not is_sharded(t, 1):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if getattr(p, "dim", None) == 1 and p.is_shard() else p
        for p in t.placements])


def _rows_and_heads_like(q, t):
    """DTensor ``t`` (B, H, S, hd) split over batch rows and heads as q
    (B, H, ...) is, where ``t`` is replicated on those mesh dims (a local
    slice, no collective); None where q is split over anything else or
    partial, or ``t`` is split otherwise there, or is not a DTensor."""
    from torch.distributed.tensor import Replicate, Shard

    if not is_dtensor(t) or not all(
            isinstance(p, Replicate) or (isinstance(p, Shard)
                                         and p.dim in (0, 1))
            for p in q.placements):
        return None
    want = list(t.placements)
    for m, p in enumerate(q.placements):
        if want[m] != p:
            if not isinstance(want[m], Replicate):
                return None
            want[m] = p
    if want == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, want)


def _on_local_shards(q, k, v, q_pos, kv_pos, kv_len):
    """:func:`_sdpa_grouped` of DTensors whose shards split only batch rows
    and heads (dims 0 and 1, Replicate elsewhere): each rank attends its
    own rows and heads, k and v taking q's layout (a local slice where
    they are replicated), and the result has q's layout; None where the
    shards split anything else (a sequence-sharded cache), left to
    DTensor's operators.  DTensor's einsum flattens the batch and head
    dims into one, which it refuses (torch 2.11) when the head dim is
    sharded."""
    from torch.distributed.tensor import DTensor

    mesh, placements = q.device_mesh, q.placements
    kv = [_rows_and_heads_like(q, t) for t in (k, v)]
    if any(t is None for t in kv):
        return None
    kv = [t.to_local() for t in kv]
    rows = shard_offsets(q)[0]
    b_local = q.to_local().shape[0]
    q_pos = q_pos[rows:rows + b_local]
    if is_dtensor(kv_len):
        kv_len = kv_len.full_tensor()
    if kv_len.dim():
        kv_len = kv_len[rows:rows + b_local]
    out = _sdpa_grouped(q.to_local(), kv[0], kv[1], q_pos, kv_pos, kv_len)
    return DTensor.from_local(out, mesh, placements, run_check=False,
                              shape=q.shape, stride=q.stride())


def _write_cache(buf: torch.Tensor, new: torch.Tensor,
                 idx: torch.Tensor) -> None:
    """``buf[b, :, start_b:start_b + s] = new[b]`` in place, with
    ``start = clamp(idx, 0, S_max - s)`` per row (idx () or (B,)); the
    index stays on the device, so the write needs no host sync."""
    b, h, s, hd = new.shape
    start = torch.clamp(idx.to(torch.int64), 0, buf.shape[2] - s)
    start = torch.broadcast_to(start, (b,))
    pos = start[:, None] + torch.arange(s, device=buf.device)[None, :]
    buf.scatter_(2, pos[:, None, :, None].expand(b, h, s, hd),
                 new.to(buf.dtype))


def _write_cache_sharded(buf, new, idx) -> None:
    """:func:`_write_cache` on a DTensor cache (the decode layout shards its
    sequence over ``"model"``): each rank writes, on its own local shard
    and with local offsets, the positions of ``[start, start + s)`` that
    fall in its slice; no collective moves the cache.  ``new`` comes to the
    cache's layout, whole along the sequence.  Fixed shapes, no host sync
    (the dry run traces it on meta tensors): every rank scatters s
    positions per row, the ones outside its slice clamped onto its first
    or last position and given what that position ends up holding (the
    new token that lands there, else its own value), so no two writes to
    one position differ."""
    from torch.distributed.tensor import Replicate, Shard

    whole = [Replicate() if isinstance(p, Shard) and p.dim == 2 else p
             for p in buf.placements]
    new = new.redistribute(buf.device_mesh, whole).to_local()
    local = buf.to_local()
    off = shard_offsets(buf)
    b, h, s, hd = new.shape
    start = torch.clamp((idx.to_local() if is_dtensor(idx) else idx)
                        .to(torch.int64), 0, buf.shape[2] - s)
    if start.dim():
        start = start[off[0]:off[0] + b]
    start = torch.broadcast_to(start, (b,))[:, None]
    steps = torch.arange(s, device=local.device)[None, :]
    pos = torch.clamp(start + steps - off[2], 0, local.shape[2] - 1)
    src = pos + off[2] - start          # the token that lands on pos
    lands = (src >= 0) & (src < s)

    def rows(i):
        return i[:, None, :, None].expand(b, h, s, hd)

    val = torch.where(lands[:, None, :, None],
                      new.gather(2, rows(torch.clamp(src, 0, s - 1)))
                      .to(local.dtype),
                      local.gather(2, rows(pos)))
    local.scatter_(2, rows(pos), val)


def _on_card(*ts) -> bool:
    """True where every tensor is a plain (not DTensor) CUDA tensor."""
    return all(t.device.type == "cuda" and not is_dtensor(t) for t in ts)


def _attend(cfg: ModelConfig, qg, k_all, v_all, positions, kv_pos,
            kv_len) -> torch.Tensor:
    """Attention over every query, one query chunk at a time where the
    queries split into ``cfg.attn_chunk``-sized chunks."""
    s, chunk = qg.shape[3], cfg.attn_chunk
    if s <= chunk or s % chunk:
        return _sdpa_grouped(qg, k_all, v_all, positions, kv_pos, kv_len)
    # the reference's lax.scan over query chunks
    return torch.cat([
        _sdpa_grouped(qg[:, :, :, c:c + chunk], k_all, v_all,
                      positions[:, c:c + chunk], kv_pos, kv_len)
        for c in range(0, s, chunk)], dim=3)


def attn_fwd(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[KVCache] = None,
    proj: Optional[callable] = None,
    rowwise: bool = False,
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """x: (B, S, d); positions: (B, S) global positions of these tokens.

    Without cache: plain causal self-attention.  With cache: writes this
    chunk's K/V at ``cache.idx`` in place (prefill writes a block, decode
    one token) and attends over everything valid.  ``proj(name, x, w)``
    overrides each projection matmul (balanced dispatch of the trunk).
    ``rowwise=True`` attends each batch row as its own batch-1 product,
    so a row's scores and outputs do not depend on how many rows ride
    along (on the card the batched GEMM's order of sums depends on the
    batch count); multi-lane prefill uses it (through ``forward``'s
    ``rowwise``) to stay token-identical to one-lane prefill.
    """
    b, s, d = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = hq // hkv

    mm = proj or (lambda name, x, w: x @ w)
    q = mm("wq", x, p["wq"])
    k = mm("wk", x, p["wk"])
    v = mm("wv", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = reshape(q, (b, s, hq, hd)).transpose(1, 2)
    k = reshape(k, (b, s, hkv, hd)).transpose(1, 2)
    v = reshape(v, (b, s, hkv, hd)).transpose(1, 2)

    q = apply_rope(q, positions, theta=cfg.rope_theta,
                   fraction=cfg.rope_fraction)
    k = apply_rope(k, positions, theta=cfg.rope_theta,
                   fraction=cfg.rope_fraction)

    if cache is not None:
        write = _write_cache_sharded if is_dtensor(cache.k) else _write_cache
        write(cache.k, k, cache.idx)
        write(cache.v, v, cache.idx)
        k_all, v_all = cache.k, cache.v
        new_cache = KVCache(k=k_all, v=v_all, idx=cache.idx + s)
        kv_pos = torch.arange(k_all.shape[2], device=x.device)
        kv_len = cache.idx + s
    else:
        k_all, v_all = k, v
        new_cache = None
        kv_pos = torch.arange(s, device=x.device)
        kv_len = torch.tensor(s, device=x.device)

    if cache is None and g > 1 and is_sharded(q, 1) \
            and not is_sharded(k_all, 1):
        # a model axis that divides the q heads but not the kv heads:
        # grouping q by kv head would gather q (every rank attending every
        # head, and gathering f32 score gradients in backward); each kv
        # head repeated to its q heads keeps q's shard
        k_all = torch.repeat_interleave(k_all, g, dim=1)
        v_all = torch.repeat_interleave(v_all, g, dim=1)
        qg = reshape(q, (b, hq, 1, s, hd))
    else:
        qg = reshape(q, (b, hkv, g, s, hd))
    if positions.dim() == 1:
        positions = torch.broadcast_to(positions[None, :], (b, s))
    if is_dtensor(qg):
        # k and v in q's layout once, not once a query chunk (each
        # redistribute's backward is a gather)
        kv = [_rows_and_heads_like(qg, t) for t in (k_all, v_all)]
        if all(t is not None for t in kv):
            k_all, v_all = kv

    if cache is not None and s == 1 and _on_card(qg, k_all, v_all):
        # one query per row: the decode kernel reads the live rows of the
        # cache in place (every row on its own, so rowwise needs nothing)
        out = decode_attention(qg, k_all, v_all, positions, kv_len)
    elif rowwise and b > 1:
        out = torch.cat([
            _attend(cfg, qg[i:i + 1], k_all[i:i + 1], v_all[i:i + 1],
                    positions[i:i + 1], kv_pos,
                    kv_len[i:i + 1] if kv_len.dim() else kv_len)
            for i in range(b)], dim=0)
    else:
        out = _attend(cfg, qg, k_all, v_all, positions, kv_pos, kv_len)

    out = reshape(reshape(out, (b, hq, s, hd)).transpose(1, 2),
                  (b, s, hq * hd))
    return mm("wo", out, p["wo"]).to(x.dtype), new_cache
