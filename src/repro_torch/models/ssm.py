"""Mamba (selective SSM) mixer of the hybrid architectures (jamba), in plain
torch ops (the reference's scan is plain jnp too).

Prefill runs the reference's *chunked* scan: the sequence is split into
``cfg.ssm.chunk``-length chunks (an odd length runs as one chunk), and
within a chunk the diagonal linear recurrence ``h_t = a_t h_{t-1} + b_t``
is solved as ``h_t = A_t h0 + B_t`` with the running products ``A_t`` and
sums ``B_t`` of the reference's associative scan, accumulated here by a
loop over the chunk (torch has no associative scan; the chunk is at most
``cfg.ssm.chunk`` tokens).  Decode advances one token from the recurrent
state (h, conv window).

The state is **written in place** (the reference's arrays are immutable):
:func:`mamba_fwd` copies the advanced ``h`` and conv tail into the
:class:`MambaState` tensors it is given and returns a state over the same
storage, so a captured decode step reads and writes the same addresses.
Nothing syncs with the host and every shape is fixed by the input's, so
the mixer runs inside a captured CUDA graph.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.specs import copy_into
from .layers import _dense

__all__ = ["MambaState", "dt_rank", "d_inner", "init_mamba",
           "init_mamba_state", "mamba_fwd"]


class MambaState(NamedTuple):
    h: torch.Tensor     # (B, d_inner, d_state) f32
    conv: torch.Tensor  # (B, d_conv-1, d_inner) last inputs of the causal conv


def dt_rank(cfg: ModelConfig) -> int:
    return math.ceil(cfg.d_model / 16)


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)`` at every x
    (``F.softplus`` returns x itself above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def init_mamba(cfg: ModelConfig, gen: torch.Generator, device,
               n_rep: int = 1) -> dict:
    """Mamba weights stacked over ``n_rep`` period repeats, with the
    reference's shapes and distributions: S4D-real ``A_log = log(1..n)``
    per channel, and ``dt_bias`` the inverse softplus of a dt drawn
    log-uniform in [1e-3, 0.1]."""
    s = cfg.ssm
    d, di, dr, n = cfg.d_model, d_inner(cfg), dt_rank(cfg), s.d_state
    dt = cfg.cdtype
    # log(1..n) in f64, rounded once to f32 (the same bits on every device)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float64,
                                   device=device)).to(torch.float32)
    dt_init = torch.exp(
        torch.rand((n_rep, di), generator=gen, device=device)
        * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    inv_softplus = dt_init + torch.log1p(-torch.exp(-dt_init))
    return {
        "in_proj": _dense(gen, (n_rep, d, 2 * di), dt, device),
        "conv_w": _dense(gen, (n_rep, s.d_conv, di), dt, device),
        "conv_b": torch.zeros((n_rep, di), dtype=dt, device=device),
        "x_proj": _dense(gen, (n_rep, di, dr + 2 * n), dt, device),
        "dt_proj": _dense(gen, (n_rep, dr, di), dt, device),
        "dt_bias": inv_softplus,
        "A_log": a_log[None, None, :].repeat(n_rep, di, 1),
        "D": torch.ones((n_rep, di), dtype=torch.float32, device=device),
        "out_proj": _dense(gen, (n_rep, di, d), dt, device),
    }


def init_mamba_state(cfg: ModelConfig, batch: int, *, device,
                     n_rep: Optional[int] = None) -> MambaState:
    """A zeroed state; with ``n_rep`` stacked over the period repeats,
    (n_rep, batch, ...)."""
    s = cfg.ssm
    lead = (batch,) if n_rep is None else (n_rep, batch)
    return MambaState(
        h=torch.zeros((*lead, d_inner(cfg), s.d_state), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((*lead, s.d_conv - 1, d_inner(cfg)),
                         dtype=cfg.cdtype, device=device),
    )


def _causal_conv(cfg: ModelConfig, p: dict, u: torch.Tensor,
                 prev: Optional[torch.Tensor]) -> tuple:
    """Depthwise causal conv along time.  u: (B, S, di); ``prev`` is the
    (B, d_conv-1, di) tail of the previous call (or zeros).  The taps are
    summed in the reference's order."""
    kk = cfg.ssm.d_conv
    if prev is None:
        prev = torch.zeros((u.shape[0], kk - 1, u.shape[2]), dtype=u.dtype,
                           device=u.device)
    ext = torch.cat([prev, u], dim=1)              # (B, S+k-1, di)
    out = ext[:, 0:u.shape[1], :] * p["conv_w"][0]
    for i in range(1, kk):
        out = out + ext[:, i:i + u.shape[1], :] * p["conv_w"][i]
    out = out + p["conv_b"]
    return F.silu(out), ext[:, -(kk - 1):, :]


def _ssm_inputs(cfg: ModelConfig, p: dict, u: torch.Tensor) -> tuple:
    """u: (B, L, di) -> dt (B, L, di) f32, B_ssm / C_ssm (B, L, n) f32."""
    n = cfg.ssm.d_state
    dr = p["dt_proj"].shape[0]
    xdb = u @ p["x_proj"]                           # (B, L, dr + 2n)
    dt_in, b_in, c_in = torch.split(xdb, [dr, n, n], dim=-1)
    dt = softplus(dt_in @ p["dt_proj"] + p["dt_bias"]).to(torch.float32)
    return dt, b_in.to(torch.float32), c_in.to(torch.float32)


def _chunk_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> tuple:
    """Solve h_t = a_t * h_{t-1} + b_t within a chunk.

    a, b: (B, L, di, n); h0: (B, di, n).  Returns (h_all (B, L, di, n),
    h_last): ``h_all = A * h0 + Bc`` with A and Bc the running products and
    sums the reference's associative scan computes (here in time order)."""
    a_cum, b_cum = [a[:, 0]], [b[:, 0]]
    for t in range(1, a.shape[1]):
        a_cum.append(a_cum[-1] * a[:, t])
        b_cum.append(a[:, t] * b_cum[-1] + b[:, t])
    h_all = torch.stack(a_cum, dim=1) * h0[:, None] + torch.stack(b_cum, dim=1)
    return h_all, h_all[:, -1]


def mamba_fwd(cfg: ModelConfig, p: dict, x: torch.Tensor,
              state: Optional[MambaState] = None) -> tuple:
    """x: (B, S, d) -> (out, state).  With ``state`` the scan continues from
    it, and the advanced state is written into its tensors (the returned
    state is the same storage); without, it starts from zeros and returns
    None."""
    s_cfg = cfg.ssm
    b_sz, s_len, _ = x.shape
    di, n = d_inner(cfg), s_cfg.d_state

    ud = x @ p["in_proj"]                           # (B, S, 2di)
    u, z = torch.split(ud, di, dim=-1)
    u, new_conv = _causal_conv(cfg, p, u,
                               state.conv if state is not None else None)

    a_mat = -torch.exp(p["A_log"])                  # (di, n) f32
    h0 = (state.h if state is not None else
          torch.zeros((b_sz, di, n), dtype=torch.float32, device=x.device))

    chunk = min(s_cfg.chunk, s_len)
    if s_len % chunk:
        chunk = s_len  # one chunk for odd lengths, as the reference

    dt, b_in, c_in = _ssm_inputs(cfg, p, u)         # (B,S,di) (B,S,n)
    u32 = u.to(torch.float32)
    h, ys = h0, []
    for c0 in range(0, s_len, chunk):
        sl = slice(c0, c0 + chunk)
        dt_c, u_c = dt[:, sl], u32[:, sl]
        da = torch.exp(dt_c[..., None] * a_mat)                 # (B,L,di,n)
        db = (dt_c * u_c)[..., None] * b_in[:, sl, None, :]
        h_all, h = _chunk_scan(da, db, h)
        y = torch.einsum("blin,bln->bli", h_all, c_in[:, sl])
        ys.append((y + p["D"] * u_c).to(x.dtype))
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)

    out = (y * F.silu(z.to(torch.float32))).to(x.dtype) @ p["out_proj"]
    if state is None:
        return out, None
    copy_into(state.h, h)
    copy_into(state.conv, new_conv)
    return out, state
