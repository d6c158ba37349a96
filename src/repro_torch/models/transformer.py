"""Model trunk (dense family): attention mixers + dense FFNs over the
per-architecture layer plan, in the reference's stacked-per-period layout.

Parameters of each period position are stacked over repeats
(``params["period"][j][...]`` has a leading ``n_periods`` axis) and states
follow the same stacking, so weights and caches convert leaf by leaf to and
from the reference's pytrees.  Where the reference scans one period body
with ``lax.scan``, the port runs a plain loop over the repeats; a balanced
trunk hooks its projections into the same loop.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from . import attention as A
from .layers import (
    _norm_init,
    embed_fwd,
    init_embedding,
    init_mlp,
    logits_fwd,
    mlp_fwd,
    norm_fwd,
)


def _dense_period(cfg: ModelConfig) -> tuple:
    period = cfg.period()
    for mixer, ffn in period:
        if mixer != "attn" or ffn not in ("dense", "none"):
            raise NotImplementedError(
                f"{cfg.name}: layer ({mixer}, {ffn}) is not ported yet "
                f"(the port carries the dense family)")
    if cfg.norm != "rmsnorm" or cfg.mlp != "swiglu":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.norm} / {cfg.mlp} is not ported yet (the port "
            f"carries RMSNorm + SwiGLU)")
    return period


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                device="cuda") -> dict:
    """Random weights with the reference's shapes and distributions:
    ``{"embed": ..., "period": [stacked per-position params],
    "final_norm": ...}``, drawn from ``gen`` (a generator on ``device``)."""
    device = resolve_device(device)
    n_rep = cfg.n_periods
    stacked = []
    for mixer, ffn in _dense_period(cfg):
        p: dict[str, Any] = {
            "norm1": {k: v[None].repeat(n_rep, *([1] * v.dim()))
                      for k, v in _norm_init(cfg, device).items()},
            "mixer": A.init_attn(cfg, gen, device, n_rep),
        }
        if ffn != "none":
            p["norm2"] = {k: v[None].repeat(n_rep, *([1] * v.dim()))
                          for k, v in _norm_init(cfg, device).items()}
            p["ffn"] = init_mlp(cfg, gen, device, n_rep)
        stacked.append(p)
    return {
        "embed": init_embedding(cfg, gen, device),
        "period": stacked,
        "final_norm": _norm_init(cfg, device),
    }


# --------------------------------------------------------------- states ---
def init_state(cfg: ModelConfig, batch: int, max_seq: int, *,
               device="cuda") -> list:
    """Per-period-position stacked KV caches: k/v (n_rep, B, Hkv, S, hd),
    idx (n_rep,) int32."""
    device = resolve_device(device)
    n_rep = cfg.n_periods
    shape = (n_rep, batch, cfg.n_kv_heads, max_seq, cfg.hd)
    return [A.KVCache(
        k=torch.zeros(shape, dtype=cfg.cdtype, device=device),
        v=torch.zeros(shape, dtype=cfg.cdtype, device=device),
        idx=torch.zeros((n_rep,), dtype=torch.int32, device=device))
        for _ in _dense_period(cfg)]


def init_slot_state(cfg: ModelConfig, n_slots: int, max_seq: int, *,
                    device="cuda") -> list:
    """Like :func:`init_state` but with per-row KV-cache indices, idx
    (n_rep, n_slots): each of the ``n_slots`` rows advances through its
    cache independently (continuous batching)."""
    return [A.KVCache(k=c.k, v=c.v,
                      idx=torch.zeros((c.k.shape[0], n_slots),
                                      dtype=torch.int32, device=c.k.device))
            for c in init_state(cfg, n_slots, max_seq, device=device)]


# -------------------------------------------------------------- forward ---
class ForwardOut(NamedTuple):
    logits: torch.Tensor
    state: Any
    aux: dict


def _tree_index(tree, r: int):
    """Repeat ``r`` of a stacked parameter dict (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _tree_index(v, r) for k, v in tree.items()}
    return tree[r]


def _norm(cfg, p, x, rowwise: bool) -> torch.Tensor:
    """RMSNorm over x (B, S, d), one batch row at a time when ``rowwise``
    (a reduction kernel on the card picks its order of sums by the number
    of rows it reduces)."""
    if rowwise and x.shape[0] > 1:
        return torch.cat([norm_fwd(cfg, p, x[i:i + 1])
                          for i in range(x.shape[0])])
    return norm_fwd(cfg, p, x)


def _apply_layer(cfg, ffn, p, x, positions, state, proj_attn=None,
                 proj_ffn=None, rowwise=False):
    h = _norm(cfg, p["norm1"], x, rowwise)
    mix, new_state = A.attn_fwd(cfg, p["mixer"], h, positions, state,
                                proj=proj_attn, rowwise=rowwise)
    x = x + mix
    if ffn != "none":
        h2 = _norm(cfg, p["norm2"], x, rowwise)
        x = x + mlp_fwd(cfg, p["ffn"], h2, proj=proj_ffn)
    return x, new_state


def forward(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    *,
    state: Optional[list] = None,
    pos_offset=0,
    logits_mode: str = "all",
    apply_head: bool = True,
    trunk=None,
    trunk_isa: str = "membw",
    trunk_offsets=None,
    plain: bool = False,
    rowwise: bool = False,
) -> ForwardOut:
    """Trunk forward on tokens (B, S).

    ``state`` enables prefill/decode: its KV caches are written in place
    and returned with advanced indices.  ``pos_offset`` is a scalar or a
    (B,) per-row offset (slot-batched serving).  ``apply_head=False`` skips
    the LM-head matmul and returns the final-normed hidden states (f32) in
    the ``logits`` slot.

    ``trunk`` (a :class:`~repro_torch.models.balanced.BalancedTrunk`)
    reroutes every banked projection through the compiled balanced
    lowering under the ``trunk_isa`` phase ISA, with ``trunk_offsets`` the
    device offset snapshot.  ``plain=True`` runs those projections through
    the kernels' plain torch version instead (the comparison path).
    ``rowwise=True`` runs the attention and the norms one batch row at a
    time, so that each row's result does not depend on the batch size
    (see :func:`~repro_torch.models.attention.attn_fwd`); the projections
    already give each row the same sums whatever the batch.
    """
    x = embed_fwd(cfg, params["embed"], tokens)
    b, s, _ = x.shape
    offset = torch.as_tensor(pos_offset, device=x.device)
    steps = torch.arange(s, device=x.device)
    if offset.dim() == 1:  # per-row offsets (slot-batched serving)
        positions = offset[:, None] + steps[None, :]
    else:
        positions = offset + steps[None, :]
    positions = torch.broadcast_to(positions, (b, s))

    period = _dense_period(cfg)
    have_state = state is not None
    idx_out: list = [[] for _ in period]
    for r in range(cfg.n_periods):
        for j, (_, ffn) in enumerate(period):
            p_j = _tree_index(params["period"][j], r)
            st_j = None
            if have_state:
                st_j = A.KVCache(k=state[j].k[r], v=state[j].v[r],
                                 idx=state[j].idx[r])
            proj_attn = proj_ffn = None
            if trunk is not None:
                proj_attn = trunk.projector(j, r, "attn", trunk_isa,
                                            offsets=trunk_offsets,
                                            plain=plain)
                proj_ffn = trunk.projector(j, r, "ffn", trunk_isa,
                                           offsets=trunk_offsets, plain=plain)
            x, new_st = _apply_layer(cfg, ffn, p_j, x, positions, st_j,
                                     proj_attn, proj_ffn, rowwise)
            if have_state:
                idx_out[j].append(new_st.idx)
    # k/v were written in place into the stacked caches; only idx is new
    new_state = ([A.KVCache(k=state[j].k, v=state[j].v,
                            idx=torch.stack(idx_out[j]))
                  for j in range(len(period))] if have_state else None)

    if logits_mode == "last":
        # serving prefill consumes only the last position's logits
        x = x[:, -1:, :]
    x = _norm(cfg, params["final_norm"], x, rowwise)
    if apply_head:
        logits = logits_fwd(cfg, params["embed"], x)
    else:
        logits = x.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return ForwardOut(logits=logits, state=new_state,
                      aux={"lb_loss": zero, "dropped": zero})


def balanced_lm_head(cfg: ModelConfig, params: dict, dispatcher, *,
                     device="cuda"):
    """Bind the model's LM head to a hybrid kernel dispatcher: the (vocab,
    d_model) head matrix is Q4_0-quantized on ``device`` and every call
    runs as balanced per-core shards of the direct Q4 kernel (see
    :class:`~repro_torch.models.layers.BalancedQuantLinear`).  Use with
    ``forward(..., apply_head=False)``: the decode-step Fp32-Int4-Fp32 GEMV
    — the paper's hot path — then runs through the ratio-table loop
    instead of inside the trunk's step."""
    from .layers import BalancedQuantLinear

    w = (params["embed"]["tok"] if cfg.tie_embeddings
         else params["embed"]["out"].T)  # (vocab, d_model) = (N, K)
    return BalancedQuantLinear.from_dense(w.to(resolve_device(device)),
                                          dispatcher)
