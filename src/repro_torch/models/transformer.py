"""Model trunk: the zoo's mixers (attention, mamba, mLSTM, sLSTM) + dense
or MoE FFNs over the per-architecture layer plan, in the reference's
stacked-per-period layout.

Parameters of each period position are stacked over repeats
(``params["period"][j][...]`` has a leading ``n_periods`` axis) and states
follow the same stacking (KV caches, :class:`~.ssm.MambaState`,
:class:`~.xlstm.MLSTMState`, :class:`~.xlstm.SLSTMState`, each leaf
(n_rep, B, ...)), so weights and states convert leaf by leaf to and from
the reference's pytrees.  Where the reference scans one period body with
``lax.scan``, the port runs a plain loop over the repeats; a balanced
trunk hooks its projections into the same loop.
"""

from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import events as _ev
from repro_torch.device import resolve_device
from repro_torch.sharding.specs import (activation_sharding, constrain,
                                        current_mesh, gather_fsdp,
                                        is_dtensor, is_sharded)
from . import attention as A
from . import moe as M
from . import ssm as S
from . import xlstm as X
from .layers import (
    _norm_init,
    embed_fwd,
    init_embedding,
    init_mlp,
    logits_fwd,
    mlp_fwd,
    norm_fwd,
)

MIXER_INIT = {
    "attn": A.init_attn,
    "mamba": S.init_mamba,
    "mlstm": X.init_mlstm,
    "slstm": X.init_slstm,
}
MIXER_FWD = {"mamba": S.mamba_fwd, "mlstm": X.mlstm_fwd,
             "slstm": X.slstm_fwd}
RECURRENT_STATE = {"mamba": S.init_mamba_state, "mlstm": X.init_mlstm_state,
                   "slstm": X.init_slstm_state}


def _plan(cfg: ModelConfig) -> tuple:
    """``cfg.period()``: (mixer, ffn) per period position, with mixer one of
    "attn", "mamba", "mlstm" or "slstm" and ffn one of "dense", "moe" or
    "none"."""
    period = cfg.period()
    for mixer, _ in period:
        if mixer not in MIXER_INIT:
            raise ValueError(mixer)
    return period


def _stacked_norm(cfg: ModelConfig, device, n_rep: int) -> dict:
    return {k: v[None].repeat(n_rep, *([1] * v.dim()))
            for k, v in _norm_init(cfg, device).items()}


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                device="cuda") -> dict:
    """Random weights with the reference's shapes and distributions:
    ``{"embed": ..., "period": [stacked per-position params],
    "final_norm": ...}``, drawn from ``gen`` (a generator on ``device``)."""
    device = resolve_device(device)
    n_rep = cfg.n_periods
    stacked = []
    for mixer, ffn in _plan(cfg):
        p: dict[str, Any] = {
            "norm1": _stacked_norm(cfg, device, n_rep),
            "mixer": MIXER_INIT[mixer](cfg, gen, device, n_rep),
        }
        if ffn != "none":
            p["norm2"] = _stacked_norm(cfg, device, n_rep)
            p["ffn"] = (M.init_moe(cfg, gen, device, n_rep) if ffn == "moe"
                        else init_mlp(cfg, gen, device, n_rep))
        stacked.append(p)
    return {
        "embed": init_embedding(cfg, gen, device),
        "period": stacked,
        "final_norm": _norm_init(cfg, device),
    }


def abstract_params(cfg: ModelConfig) -> dict:
    """:func:`init_params`'s tree on the meta device (shapes and dtypes, no
    allocation): the dry run's weights (the reference's ``jax.eval_shape``
    of its ``init_params``)."""
    return init_params(cfg, torch.Generator(), device="meta")


# --------------------------------------------------------------- states ---
def init_state(cfg: ModelConfig, batch: int, max_seq: int, *,
               device="cuda") -> list:
    """Per-period-position stacked decoding state: a KV cache per
    attention position, k/v (n_rep, B, Hkv, S, hd) and idx (n_rep,) int32;
    a zeroed mamba, mLSTM or sLSTM state per recurrent one, every leaf
    (n_rep, B, ...)."""
    device = resolve_device(device)
    n_rep = cfg.n_periods
    shape = (n_rep, batch, cfg.n_kv_heads, max_seq, cfg.hd)
    out = []
    for mixer, _ in _plan(cfg):
        if mixer == "attn":
            out.append(A.KVCache(
                k=torch.zeros(shape, dtype=cfg.cdtype, device=device),
                v=torch.zeros(shape, dtype=cfg.cdtype, device=device),
                idx=torch.zeros((n_rep,), dtype=torch.int32, device=device)))
        else:
            out.append(RECURRENT_STATE[mixer](cfg, batch, device=device,
                                              n_rep=n_rep))
    return out


def abstract_state(cfg: ModelConfig, batch: int, max_seq: int) -> list:
    """:func:`init_state`'s tree on the meta device."""
    return init_state(cfg, batch, max_seq, device="meta")


def init_slot_state(cfg: ModelConfig, n_slots: int, max_seq: int, *,
                    device="cuda") -> list:
    """Like :func:`init_state` but with per-row KV-cache indices, idx
    (n_rep, n_slots): each of the ``n_slots`` rows advances through its
    cache independently (continuous batching).  Recurrent states already
    carry a batch axis and stay as they are."""
    return [A.KVCache(k=c.k, v=c.v,
                      idx=torch.zeros((c.k.shape[0], n_slots),
                                      dtype=torch.int32, device=c.k.device))
            if isinstance(c, A.KVCache) else c
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


# the MoE's expert tensors: its mesh branches lay them out themselves
EXPERT_WEIGHTS = ("wi", "wg", "wo")


def _layer_weights(p: dict, ffn: str) -> dict:
    """A layer's weights gathered over the FSDP axes where the layer runs
    (:func:`~repro_torch.sharding.gather_fsdp`; nothing off a mesh), but
    for an MoE's expert tensors: the MoE's mesh branches redistribute
    them as they need, and a serve layout splits their ff over "data" on
    purpose (weights stationary at decode)."""
    if ffn != "moe":
        return gather_fsdp(p)
    out = gather_fsdp({k: v for k, v in p.items() if k != "ffn"})
    f = p["ffn"]
    out["ffn"] = dict(gather_fsdp({k: v for k, v in f.items()
                                   if k not in EXPERT_WEIGHTS}),
                      **{k: v for k, v in f.items() if k in EXPERT_WEIGHTS})
    return out


def _norm(cfg, p, x, rowwise: bool) -> torch.Tensor:
    """``cfg.norm`` over x (B, S, d), one batch row at a time when ``rowwise``
    (a reduction kernel on the card picks its order of sums by the number
    of rows it reduces)."""
    if rowwise and x.shape[0] > 1:
        return torch.cat([norm_fwd(cfg, p, x[i:i + 1])
                          for i in range(x.shape[0])])
    return norm_fwd(cfg, p, x)


def _mix(cfg, mixer, p, h, positions, state, proj_attn, rowwise):
    """The layer's mixer on normed h (B, S, d).  A recurrent mixer runs one
    batch row at a time when ``rowwise`` (its projections are products
    whose order of sums depends on the number of rows), on views of the
    state's rows, which it advances in place."""
    if mixer == "attn":
        return A.attn_fwd(cfg, p, h, positions, state, proj=proj_attn,
                          rowwise=rowwise)
    fwd = MIXER_FWD[mixer]
    if not (rowwise and h.shape[0] > 1):
        return fwd(cfg, p, h, state)
    outs = [fwd(cfg, p, h[i:i + 1],
                None if state is None else
                type(state)(*(t[i:i + 1] for t in state)))[0]
            for i in range(h.shape[0])]
    return torch.cat(outs), state


def _apply_layer(cfg, mixer, ffn, p, x, positions, state, capacity,
                 proj_attn=None, proj_ffn=None, rowwise=False, layer=0):
    # wall spans: the host's time to issue the mixer and the FFN, where
    # this runs in Python (not inside a replayed CUDA graph)
    w = _ev.WALL
    sp = w and w.begin(mixer, layer=layer)
    h = _norm(cfg, p["norm1"], x, rowwise)
    mix, new_state = _mix(cfg, mixer, p["mixer"], h, positions, state,
                          proj_attn, rowwise)
    # under a mesh the mixer's and the FFN's outputs are partial sums over
    # "model": summed here, in their own dtype, into the residual's layout
    x = x + constrain(mix, ("dp", None, None))
    if sp:
        w.end(sp)
    aux = None
    if ffn != "none":
        sp = w and w.begin("moe" if ffn == "moe" else "mlp", layer=layer)
        h2 = _norm(cfg, p["norm2"], x, rowwise)
        if ffn == "moe":
            # the rows route together: they share the experts' capacity
            y, aux = M.moe_fwd(cfg, p["ffn"], h2, capacity)
        else:
            y = mlp_fwd(cfg, p["ffn"], h2, proj=proj_ffn)
        x = x + constrain(y, ("dp", None, None))
        if sp:
            w.end(sp)
    return x, new_state, aux


def forward(
    cfg: ModelConfig,
    params: dict,
    tokens: Optional[torch.Tensor] = None,
    *,
    embeds: Optional[torch.Tensor] = None,
    prefix_embeds: Optional[torch.Tensor] = None,
    state: Optional[list] = None,
    pos_offset=0,
    capacity: Optional[int] = None,
    logits_mode: str = "all",
    apply_head: bool = True,
    trunk=None,
    trunk_isa: str = "membw",
    trunk_offsets=None,
    plain: bool = False,
    rowwise: bool = False,
    remat: bool = False,
) -> ForwardOut:
    """Trunk forward on tokens (B, S) — or ``embeds`` (B, S, d) for
    embed-input archs (the musicgen stub).  ``prefix_embeds`` (B, P, d) is
    prepended (the internvl2 stub).  ``capacity`` overrides each MoE
    layer's expert capacity (default: ``moe.default_capacity`` of the
    call's B*S tokens).  ``aux`` holds the MoE layers' mean load-balance
    loss and dropped share (zeros without MoE layers).

    ``state`` enables prefill/decode: its KV caches and recurrent states
    are written in place and returned, the caches with advanced indices.
    ``pos_offset`` is a scalar or a (B,) per-row offset (slot-batched
    serving).  ``apply_head=False`` skips the LM-head matmul and returns
    the final-normed hidden states (in the activations' dtype) in the
    ``logits`` slot.

    ``trunk`` (a :class:`~repro_torch.models.balanced.BalancedTrunk`)
    reroutes every banked projection through the compiled balanced
    lowering under the ``trunk_isa`` phase ISA, with ``trunk_offsets`` the
    device offset snapshot.  ``plain=True`` runs those projections through
    the kernels' plain torch version instead (the comparison path).
    ``rowwise=True`` runs the attention, the recurrent mixers and the norms
    one batch row at a time, so that each row's result does not depend on
    the batch size (see :func:`~repro_torch.models.attention.attn_fwd`);
    the trunk's projections already give each row the same sums whatever
    the batch.  ``remat=True`` (training: no state, no trunk) recomputes
    each period repeat's activations in backward instead of keeping them.

    Under :func:`repro_torch.sharding.activation_sharding` (DTensor
    parameters and tokens) the activations are constrained as the
    reference constrains them: batch over the data axes after the
    embedding and after every layer, the logits' vocab over "model".
    """
    period = _plan(cfg)
    if embeds is not None:
        x = embeds.to(cfg.cdtype)
    else:
        x = embed_fwd(cfg, gather_fsdp(params["embed"]), tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    x = constrain(x, ("dp", None, None))
    b, s, _ = x.shape
    offset = torch.as_tensor(pos_offset, device=x.device)
    steps = torch.arange(s, device=x.device)
    if offset.dim() == 1:  # per-row offsets (slot-batched serving)
        positions = offset[:, None] + steps[None, :]
    else:
        positions = offset + steps[None, :]
    positions = torch.broadcast_to(positions, (b, s))

    have_state = state is not None
    if remat and (have_state or trunk is not None):
        raise ValueError("remat=True is for training: no state, no trunk")
    idx_out: list = [[] for _ in period]

    def repeat(x, lb, dropped, r):
        """Period repeat ``r``: every (mixer, ffn) position in turn."""
        for j, (mixer, ffn) in enumerate(period):
            p_j = _layer_weights(_tree_index(params["period"][j], r), ffn)
            st_j = None
            if have_state:
                st_j = type(state[j])(*(t[r] for t in state[j]))
            proj_attn = proj_ffn = None
            if trunk is not None:
                proj_attn = trunk.projector(j, r, "attn", trunk_isa,
                                            offsets=trunk_offsets,
                                            plain=plain)
                proj_ffn = trunk.projector(j, r, "ffn", trunk_isa,
                                           offsets=trunk_offsets, plain=plain)
            x, new_st, aux = _apply_layer(cfg, mixer, ffn, p_j, x, positions,
                                          st_j, capacity, proj_attn, proj_ffn,
                                          rowwise, r * len(period) + j)
            # under a mesh: batch over the data axes, replicated over model
            x = constrain(x, ("dp", None, None))
            if have_state and mixer == "attn":
                idx_out[j].append(new_st.idx)
            if aux is not None:
                lb = lb + aux["lb_loss"]
                dropped = dropped + aux["dropped"]
        return x, lb, dropped

    lb = torch.zeros((), dtype=torch.float32, device=x.device)
    dropped = torch.zeros((), dtype=torch.float32, device=x.device)
    mesh = current_mesh()
    remat_kw = {}
    if mesh is not None:
        # the recompute runs in backward, on the autograd engine's thread
        # when on the card, outside the caller's mesh context: it enters
        # the context again, so it takes the forward's path
        remat_kw["context_fn"] = lambda: (contextlib.nullcontext(),
                                          activation_sharding(mesh))
    for r in range(cfg.n_periods):
        if remat:
            # the reference's jax.checkpoint of the period body: keep only
            # the repeat's inputs, recompute its activations in backward
            x, lb, dropped = checkpoint(repeat, x, lb, dropped, r,
                                        use_reentrant=False,
                                        preserve_rng_state=False, **remat_kw)
        else:
            x, lb, dropped = repeat(x, lb, dropped, r)
    # k/v and the recurrent states were written in place into the stacked
    # tensors; only the caches' idx is new
    new_state = ([A.KVCache(k=state[j].k, v=state[j].v,
                            idx=torch.stack(idx_out[j]))
                  if mixer == "attn" else state[j]
                  for j, (mixer, _) in enumerate(period)]
                 if have_state else None)

    if logits_mode == "last":
        # serving prefill consumes only the last position's logits
        x = x[:, -1:, :]
    x = _norm(cfg, params["final_norm"], x, rowwise)
    if apply_head:
        logits = logits_fwd(cfg, gather_fsdp(params["embed"]), x)
        logits = constrain(logits, ("dp", None, "tp"))
    else:
        logits = x
    n_moe = max(1, sum(1 for _, f in cfg.layer_plan() if f == "moe"))
    return ForwardOut(logits=logits, state=new_state,
                      aux={"lb_loss": lb / n_moe, "dropped": dropped / n_moe})


def balanced_lm_head(cfg: ModelConfig, params: dict, dispatcher, *,
                     device="cuda"):
    """Bind the model's LM head to a hybrid kernel dispatcher: the (vocab,
    d_model) head matrix is Q4_0-quantized on ``device`` and every call
    runs as balanced per-core shards of a Q4 kernel entry, each the
    dispatcher's tuner picks (see
    :class:`~repro_torch.models.layers.BalancedQuantLinear`).  Use with
    ``forward(..., apply_head=False)``: the decode-step Fp32-Int4-Fp32 GEMV
    — the paper's hot path — then runs through the ratio-table loop
    instead of inside the trunk's step."""
    from .layers import BalancedQuantLinear

    w = (params["embed"]["tok"] if cfg.tie_embeddings
         else params["embed"]["out"].T)  # (vocab, d_model) = (N, K)
    return BalancedQuantLinear.from_dense(w.to(resolve_device(device)),
                                          dispatcher)


def loss_fn(
    cfg: ModelConfig,
    params: dict,
    batch: dict,
    *,
    lb_coef: float = 0.01,
    capacity: Optional[int] = None,
    remat: bool = False,
) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy (+ MoE load-balance loss).

    batch: {"tokens": (B,S), "labels": (B,S) with -100 = ignore} and
    optionally "embeds"/"prefix_embeds" for stub-frontend archs.  The
    log-softmax is taken over float32 logits, as the reference's.
    """
    out = forward(
        cfg,
        params,
        batch.get("tokens"),
        embeds=batch.get("embeds"),
        prefix_embeds=batch.get("prefix_embeds"),
        capacity=capacity,
        remat=remat,
    )
    labels = batch["labels"]
    logits = out.logits
    if logits.shape[1] != labels.shape[1]:  # prefix positions carry no loss
        logits = logits[:, logits.shape[1] - labels.shape[1]:, :]
        if is_dtensor(logits):
            # DTensor propagates a shape through the op on fake tensors of
            # the mesh's device type: a strided log-softmax there needs that
            # device's kernels, which a dry run on a host without a card
            # lacks
            logits = logits.contiguous()
    valid = labels != -100
    safe = torch.where(valid, labels, 0).long()
    if is_sharded(logits, -1):
        # vocab over "model": DTensor's log-softmax would gather the
        # logits; max and sum reduce the sharded vocab by all-reduces of
        # one value per token, as GSPMD lowers it
        m = logits.amax(-1, keepdim=True).detach()
        lse = m + torch.log(torch.exp(logits - m).sum(-1, keepdim=True))
        nll = (lse - torch.gather(logits, -1, safe[..., None]))[..., 0]
    else:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    denom = torch.clamp(valid.sum(), min=1)
    ce = torch.where(valid, nll, 0.0).sum() / denom
    total = ce + lb_coef * out.aux["lb_loss"]
    metrics = {"loss": total, "ce": ce, "lb": out.aux["lb_loss"],
               "dropped": out.aux["dropped"]}
    return total, metrics
