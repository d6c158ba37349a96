"""xLSTM mixers: mLSTM (matrix memory) and sLSTM (scalar memory), in plain
torch ops (the reference's are plain jnp too).

mLSTM uses the stabilized exponential-gating recurrence of arXiv:2405.04517:

    m_t = max(f~_t + m_{t-1}, i~_t)
    C_t = e^{f~+m_{t-1}-m_t} C_{t-1} + e^{i~-m_t} v_t k_t^T
    n_t = e^{f~+m_{t-1}-m_t} n_{t-1} + e^{i~-m_t} k_t
    h_t = C_t q_t / max(|n_t . q_t|, e^{-m_t})

Prefill and decode run the reference's *chunkwise-parallel* form
(:func:`_mlstm_chunk`: an intra-chunk attention-like matrix plus the
carried inter-chunk state; decode is a chunk of one token), over the
chunks in a loop where the reference scans them.
:func:`mlstm_recurrent_reference` is the exact step recurrence, the
oracle of the chunkwise form.  sLSTM has true recurrent weights
(block-diagonal per head) and steps one token at a time.

The state is **written in place** (the reference's arrays are immutable):
the mLSTM matrix memory is decayed and updated in its own tensor (a
``(B*H, dv, dk)`` batched product added into it, with no new memory and
no copy back), the small leaves are copied into theirs, and the returned
state is the same storage, so a captured step keeps its addresses.  Nothing syncs with the host and
every shape is fixed by the input's, so both mixers run inside a captured
CUDA graph.  Without a state (training, and any stateless forward) the
mLSTM memory starts from zeros and advances out of place, so autograd can
differentiate through the chunks.

On a mesh (DTensor activations) the forget gates' log-sigmoid is taken as
``-softplus(-x)``: DTensor has no sharding strategy for
``aten.log_sigmoid_backward``, and softplus and its backward are
pointwise ones it has.  Off a mesh it stays ``F.logsigmoid``, bit for bit
(:func:`_log_sigmoid`).  An mLSTM chunk of DTensors runs on local shards
(:func:`_mlstm_chunk_on_shards`): its operands are made whole along the
chunk and the head dims, split only over batch rows and heads, and each
rank computes its own rows and heads, as the attention does.  DTensor's
own operators would flatten a sharded chunk dim into a batched product,
which torch 2.11 refuses.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.specs import copy_into, is_dtensor, reshape
from .layers import _dense

__all__ = ["NEG", "MLSTMState", "mlstm_dims", "init_mlstm",
           "init_mlstm_state", "mlstm_step", "mlstm_recurrent_reference",
           "mlstm_fwd", "SLSTMState", "init_slstm", "init_slstm_state",
           "slstm_step", "slstm_fwd"]

NEG = -1e30


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``log(sigmoid(x))``: ``F.logsigmoid`` on a plain tensor, ``-softplus(
    -x)`` on a DTensor (the same values to rounding; see the module)."""
    if is_dtensor(x):
        return -F.softplus(-x)
    return F.logsigmoid(x)


# =============================================================== mLSTM ====
class MLSTMState(NamedTuple):
    c: torch.Tensor     # (B, H, dv, dk) stabilized matrix memory
    n: torch.Tensor     # (B, H, dk)
    m: torch.Tensor     # (B, H)
    conv: torch.Tensor  # (B, conv_kernel-1, di) causal-conv tail


def mlstm_dims(cfg: ModelConfig) -> tuple:
    x = cfg.xlstm
    di = int(x.proj_factor * cfg.d_model)
    h = cfg.n_heads
    dv = di // h
    dk = max(8, int(x.qk_dim_factor * dv))
    return di, h, dv, dk


def init_mlstm(cfg: ModelConfig, gen: torch.Generator, device,
               n_rep: int = 1) -> dict:
    """mLSTM weights stacked over ``n_rep`` period repeats, with the
    reference's shapes and distributions (per-head block-diagonal q/k/v,
    the official xLSTM layout; input gate bias 0, forget gate bias 3)."""
    di, h, dv, dk = mlstm_dims(cfg)
    d = cfg.d_model
    dt = cfg.cdtype
    kk = cfg.xlstm.conv_kernel
    b_if = torch.cat([torch.zeros((h,)), 3.0 * torch.ones((h,))])
    return {
        "w_up": _dense(gen, (n_rep, d, di), dt, device),
        "w_z": _dense(gen, (n_rep, d, di), dt, device),
        "conv_w": _dense(gen, (n_rep, kk, di), dt, device),
        "conv_b": torch.zeros((n_rep, di), dtype=dt, device=device),
        "wq": _dense(gen, (n_rep, h, dv, dk), dt, device),
        "wk": _dense(gen, (n_rep, h, dv, dk), dt, device),
        "wv": _dense(gen, (n_rep, h, dv, dv), dt, device),
        "w_if": _dense(gen, (n_rep, di, 2 * h), torch.float32, device),
        "b_if": b_if.to(device)[None].repeat(n_rep, 1),
        "w_down": _dense(gen, (n_rep, di, d), dt, device),
    }


def init_mlstm_state(cfg: ModelConfig, batch: int, *, device,
                     n_rep: Optional[int] = None) -> MLSTMState:
    """A zeroed state with ``m = NEG``; with ``n_rep`` stacked over the
    period repeats, (n_rep, batch, ...)."""
    di, h, dv, dk = mlstm_dims(cfg)
    lead = (batch,) if n_rep is None else (n_rep, batch)
    f32 = torch.float32
    return MLSTMState(
        c=torch.zeros((*lead, h, dv, dk), dtype=f32, device=device),
        n=torch.zeros((*lead, h, dk), dtype=f32, device=device),
        m=torch.full((*lead, h), NEG, dtype=f32, device=device),
        conv=torch.zeros((*lead, cfg.xlstm.conv_kernel - 1, di),
                         dtype=cfg.cdtype, device=device),
    )


def _headwise_rms(h: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Non-parametric per-head RMS norm (stand-in for HeadwiseLayerNorm)."""
    return h * torch.rsqrt(torch.mean(h * h, -1, keepdim=True) + eps)


def _mlstm_chunk(q, k, v, ig, fg, state, inplace: bool = True):
    """One chunk of the chunkwise-parallel mLSTM.

    q, k: (B, H, L, dk) (q pre-scaled); v: (B, H, L, dv); ig, fg: (B, H, L)
    f32.  state: (c (B, H, dv, dk) contiguous, n (B, H, dk), m (B, H)).
    Returns h (B, H, L, dv) and the end-of-chunk state: the state's own
    tensors, advanced in place — or, with ``inplace=False``, new tensors
    holding the same values, with the chunk's inputs left as they are, so
    autograd can differentiate through the chunks (it saves ``c0`` and
    ``n0`` for the products above)."""
    if any(is_dtensor(t) for t in (q, k, v, ig, fg, *state)):
        return _mlstm_chunk_on_shards(q, k, v, ig, fg, state, inplace)
    c0, n0, m0 = state
    b = torch.cumsum(fg, dim=-1)                      # (B,H,L) log forget cum
    # D_ts = ig_s + b_t - b_s  (s <= t)
    dmat = ig[:, :, None, :] + b[:, :, :, None] - b[:, :, None, :]
    l = q.shape[2]
    causal = torch.tril(torch.ones((l, l), dtype=torch.bool, device=q.device))
    dmat = torch.where(causal, dmat, NEG)
    m_intra = dmat.amax(-1)                           # (B,H,L)
    m_t = torch.maximum(m0[:, :, None] + b, m_intra)  # (B,H,L)

    w = torch.exp(dmat - m_t[..., None])              # (B,H,L,L)
    s = torch.einsum("bhld,bhsd->bhls", q, k)         # (B,H,L,L) f32
    intra = torch.einsum("bhls,bhsv->bhlv", w * s, v)
    inter_coef = torch.exp(m0[:, :, None] + b - m_t)  # (B,H,L)
    inter = torch.einsum("bhld,bhvd->bhlv", q, c0) * inter_coef[..., None]
    num = inter + intra

    den_intra = torch.einsum("bhls,bhls->bhl", w, s)
    den_inter = torch.einsum("bhld,bhd->bhl", q, n0) * inter_coef
    den = den_inter + den_intra
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None]

    # end-of-chunk state
    bl = b[:, :, -1]                                  # (B,H)
    m_end = torch.maximum(m0 + bl, (ig + bl[..., None] - b).amax(-1))
    wk_end = torch.exp(ig + bl[..., None] - b - m_end[..., None])  # (B,H,L)
    decay = torch.exp(m0 + bl - m_end)                # (B,H)
    n_upd = torch.einsum("bhl,bhld->bhd", wk_end, k)
    bsz, nh, dv, dk = c0.shape
    wv = (wk_end[..., None] * v).transpose(2, 3)      # (B,H,dv,L)
    if not inplace:
        c = torch.baddbmm((c0 * decay[..., None, None]).reshape(
                              bsz * nh, dv, dk),
                          wv.reshape(bsz * nh, dv, l),
                          k.reshape(bsz * nh, l, dk))
        return h, (c.reshape(bsz, nh, dv, dk),
                   n0 * decay[..., None] + n_upd, m_end)
    c0.mul_(decay[..., None, None])
    c0.view(bsz * nh, dv, dk).baddbmm_(wv.reshape(bsz * nh, dv, l),
                                       k.reshape(bsz * nh, l, dk))
    n0.mul_(decay[..., None]).add_(n_upd)
    m0.copy_(m_end)
    return h, (c0, n0, m0)


def _mlstm_chunk_on_shards(q, k, v, ig, fg, state, inplace: bool):
    """:func:`_mlstm_chunk` of DTensors on local shards.  Every operand
    (a plain one taken as replicated) is brought to one layout: q's
    shards of batch rows and heads (dims 0 and 1), whole along every other
    dim.  Each rank runs the chunk on its local rows and heads, and h and
    the new state come back as DTensors of that layout.  With ``inplace``
    the state's own tensors are written, each in its own layout
    (:func:`~repro_torch.sharding.specs.copy_into`)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    lead = next(t for t in (q, k, v, ig, fg, *state) if is_dtensor(t))
    mesh = lead.device_mesh
    want = [p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate()
            for p in lead.placements]
    whole = [Replicate()] * mesh.ndim

    def local(t):
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, whole, run_check=False)
        if list(t.placements) != want:
            t = t.redistribute(mesh, want)
        return t.to_local()

    def shard(t, shape):
        stride = [1] * len(shape)
        for i in range(len(shape) - 2, -1, -1):
            stride[i] = stride[i + 1] * shape[i + 1]
        return DTensor.from_local(t, mesh, want, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=tuple(stride))

    bsz, nh, l, _ = q.shape
    h, new = _mlstm_chunk(local(q), local(k), local(v), local(ig),
                          local(fg), tuple(local(t) for t in state),
                          inplace=False)
    h = shard(h, (bsz, nh, l, v.shape[3]))
    new = tuple(shard(t, tuple(s.shape)) for t, s in zip(new, state))
    if not inplace:
        return h, new
    for dst, src in zip(state, new):
        copy_into(dst, src)
    return h, tuple(state)


def mlstm_step(q, k, v, ig, fg, state):
    """Exact stabilized recurrence for ONE step (the oracle's step).

    q, k: (B, H, dk) (q pre-scaled); v: (B, H, dv); ig, fg: (B, H)."""
    c0, n0, m0 = state
    m_t = torch.maximum(fg + m0, ig)
    f_p = torch.exp(fg + m0 - m_t)
    i_p = torch.exp(ig - m_t)
    c_t = f_p[..., None, None] * c0 + i_p[..., None, None] * torch.einsum(
        "bhv,bhd->bhvd", v, k)
    n_t = f_p[..., None] * n0 + i_p[..., None] * k
    num = torch.einsum("bhvd,bhd->bhv", c_t, q)
    den = torch.einsum("bhd,bhd->bh", n_t, q)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None]
    return h, (c_t, n_t, m_t)


def mlstm_recurrent_reference(q, k, v, ig, fg, state):
    """Step by step over time (the oracle of the chunkwise form).

    q, k: (B, H, L, dk); returns (h (B, H, L, dv), final state)."""
    hs = []
    for t in range(q.shape[2]):
        h, state = mlstm_step(q[:, :, t], k[:, :, t], v[:, :, t],
                              ig[:, :, t], fg[:, :, t], state)
        hs.append(h)
    return torch.stack(hs, dim=2), state


def _mlstm_causal_conv(cfg: ModelConfig, p: dict, u: torch.Tensor,
                       prev: Optional[torch.Tensor]) -> tuple:
    """Depthwise causal conv along time, the taps summed in the
    reference's order; returns (silu(conv), new tail)."""
    kk = cfg.xlstm.conv_kernel
    if prev is None:
        prev = torch.zeros((u.shape[0], kk - 1, u.shape[2]), dtype=u.dtype,
                           device=u.device)
    ext = torch.cat([prev, u], dim=1)
    out = ext[:, 0:u.shape[1], :] * p["conv_w"][0]
    for i in range(1, kk):
        out = out + ext[:, i:i + u.shape[1], :] * p["conv_w"][i]
    out = out + p["conv_b"]
    return F.silu(out), ext[:, -(kk - 1):, :]


def mlstm_fwd(cfg: ModelConfig, p: dict, x: torch.Tensor,
              state: Optional[MLSTMState] = None) -> tuple:
    """x: (B, S, d) -> (out, state).  With ``state`` the memory continues
    from it and is advanced in place (the returned state is the same
    storage); without, it starts from zeros, is advanced out of place (the
    training path: autograd differentiates through the chunks) and None is
    returned."""
    di, nh, dv, dk = mlstm_dims(cfg)
    b_sz, s_len, _ = x.shape

    u = x @ p["w_up"]
    z = x @ p["w_z"]
    uc, new_conv = _mlstm_causal_conv(
        cfg, p, u, state.conv if state is not None else None)

    uc_h = reshape(uc, (b_sz, s_len, nh, dv))
    u_h = reshape(u, (b_sz, s_len, nh, dv))
    # q in the compute dtype, then f32, then scaled (the reference's order)
    q = torch.einsum("bshd,hdk->bhsk", uc_h, p["wq"]).to(torch.float32) \
        * dk ** -0.5
    k = torch.einsum("bshd,hdk->bhsk", uc_h, p["wk"]).to(torch.float32)
    v = torch.einsum("bshd,hdk->bhsk", u_h, p["wv"]).to(torch.float32)
    # the product as one (B*S, di) x (di, 2H) mm: the sharded reshape
    # carries a sequence-sharded gradient through its flattening, which
    # matmul's own view refuses on a DTensor (torch 2.11)
    gates = reshape(reshape(uc.to(torch.float32), (b_sz * s_len, di))
                    @ p["w_if"] + p["b_if"], (b_sz, s_len, 2 * nh))
    ig = gates[..., :nh].transpose(1, 2)                  # (B,H,S)
    fg = _log_sigmoid(gates[..., nh:]).transpose(1, 2)

    if state is not None:
        st = (state.c, state.n, state.m)
    else:
        st = tuple(init_mlstm_state(cfg, b_sz, device=x.device)[:3])

    chunk = min(cfg.xlstm.chunk, s_len)
    if s_len % chunk:
        chunk = s_len
    hs = []
    for c0 in range(0, s_len, chunk):
        sl = slice(c0, c0 + chunk)
        h_c, st = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                               ig[:, :, sl], fg[:, :, sl], st,
                               inplace=state is not None)
        hs.append(h_c)
    h = hs[0] if len(hs) == 1 else torch.cat(hs, dim=2)

    h = _headwise_rms(h)
    h = reshape(h.transpose(1, 2), (b_sz, s_len, di)).to(x.dtype)
    out = (h * F.silu(z)) @ p["w_down"]
    if state is None:
        return out, None
    copy_into(state.conv, new_conv)
    return out, state


# =============================================================== sLSTM ====
class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, d)
    n: torch.Tensor  # (B, d)
    m: torch.Tensor  # (B, d)
    h: torch.Tensor  # (B, d)


def init_slstm(cfg: ModelConfig, gen: torch.Generator, device,
               n_rep: int = 1) -> dict:
    """sLSTM weights stacked over ``n_rep`` period repeats: the fused z, i,
    f, o gate projection, the per-head recurrent weights (f32) and the
    gate biases (z, i = 0, f = 3, o = 0)."""
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    dt = cfg.cdtype
    bias = torch.cat([torch.zeros((2 * d,)), 3.0 * torch.ones((d,)),
                      torch.zeros((d,))])
    return {
        "w_x": _dense(gen, (n_rep, d, 4 * d), dt, device),
        "r_h": _dense(gen, (n_rep, nh, dh, 4 * dh), torch.float32, device),
        "bias": bias.to(device)[None].repeat(n_rep, 1),
        "w_out": _dense(gen, (n_rep, d, d), dt, device),
    }


def init_slstm_state(cfg: ModelConfig, batch: int, *, device,
                     n_rep: Optional[int] = None) -> SLSTMState:
    """``n = 1e-6`` and ``m = NEG``, the rest zeros; with ``n_rep`` stacked
    over the period repeats, (n_rep, batch, d)."""
    shape = (batch, cfg.d_model) if n_rep is None else (n_rep, batch,
                                                          cfg.d_model)
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return SLSTMState(c=z, n=z + 1e-6,
                      m=torch.full(shape, NEG, dtype=torch.float32,
                                   device=device),
                      h=z.clone())


def slstm_step(cfg: ModelConfig, p: dict, xt: torch.Tensor,
               st: SLSTMState) -> SLSTMState:
    """One recurrent step.  xt: (B, 4d) pre-projected gate input."""
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    b = xt.shape[0]
    hh = reshape(st.h, (b, nh, dh))
    rec = reshape(torch.einsum("bhd,hde->bhe", hh, p["r_h"]), (b, 4 * d))
    g = xt.to(torch.float32) + rec + p["bias"]
    zg, ig, fg, og = torch.split(g, d, dim=-1)
    z = torch.tanh(zg)
    fg = _log_sigmoid(fg)
    m_t = torch.maximum(fg + st.m, ig)
    i_p = torch.exp(ig - m_t)
    f_p = torch.exp(fg + st.m - m_t)
    c_t = f_p * st.c + i_p * z
    n_t = torch.clamp(f_p * st.n + i_p, min=1e-6)
    h_t = torch.sigmoid(og) * (c_t / n_t)
    return SLSTMState(c=c_t, n=n_t, m=m_t, h=h_t)


def slstm_fwd(cfg: ModelConfig, p: dict, x: torch.Tensor,
              state: Optional[SLSTMState] = None) -> tuple:
    """x: (B, S, d) -> (out, state), one token at a time.  With ``state``
    the scan continues from it and the end state is copied into its
    tensors (the returned state is the same storage); without, it starts
    from :func:`init_slstm_state` and returns None."""
    b_sz, s_len, _ = x.shape
    st = (state if state is not None
          else init_slstm_state(cfg, b_sz, device=x.device))
    xg = x @ p["w_x"]                                    # (B, S, 4d)
    hs = []
    for t in range(s_len):
        st = slstm_step(cfg, p, xg[:, t], st)
        hs.append(st.h)
    h = torch.stack(hs, dim=1)
    out = h.to(x.dtype) @ p["w_out"]
    if state is None:
        return out, None
    for dst, src in zip(state, st):
        copy_into(dst, src)
    return out, state
