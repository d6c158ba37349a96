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
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
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
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bhgqd,bhsd->bhgqs", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if kv_len.dim() == 1:
        kv_len = kv_len[:, None, None]  # (B, 1, 1) against (B, Sq, Skv)
    allowed = (kv_pos[None, :] <= q_pos[..., None]) & (kv_pos < kv_len)
    scores = torch.where(allowed[:, None, None, :, :], scores,
                         torch.full((), NEG_INF, dtype=scores.dtype,
                                    device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqs,bhsd->bhgqd", probs, v.to(torch.float32))
    return out.to(v.dtype)


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
    q = q.reshape(b, s, hq, hd).transpose(1, 2)
    k = k.reshape(b, s, hkv, hd).transpose(1, 2)
    v = v.reshape(b, s, hkv, hd).transpose(1, 2)

    q = apply_rope(q, positions, theta=cfg.rope_theta,
                   fraction=cfg.rope_fraction)
    k = apply_rope(k, positions, theta=cfg.rope_theta,
                   fraction=cfg.rope_fraction)

    if cache is not None:
        _write_cache(cache.k, k, cache.idx)
        _write_cache(cache.v, v, cache.idx)
        k_all, v_all = cache.k, cache.v
        new_cache = KVCache(k=k_all, v=v_all, idx=cache.idx + s)
        kv_pos = torch.arange(k_all.shape[2], device=x.device)
        kv_len = cache.idx + s
    else:
        k_all, v_all = k, v
        new_cache = None
        kv_pos = torch.arange(s, device=x.device)
        kv_len = torch.tensor(s, device=x.device)

    qg = q.reshape(b, hkv, g, s, hd)
    if positions.dim() == 1:
        positions = torch.broadcast_to(positions[None, :], (b, s))

    if rowwise and b > 1:
        out = torch.cat([
            _attend(cfg, qg[i:i + 1], k_all[i:i + 1], v_all[i:i + 1],
                    positions[i:i + 1], kv_pos,
                    kv_len[i:i + 1] if kv_len.dim() else kv_len)
            for i in range(b)], dim=0)
    else:
        out = _attend(cfg, qg, k_all, v_all, positions, kv_pos, kv_len)

    out = out.reshape(b, hq, s, hd).transpose(1, 2).reshape(b, s, hq * hd)
    return mm("wo", out, p["wo"]).to(x.dtype), new_cache
