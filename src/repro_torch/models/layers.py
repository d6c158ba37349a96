"""Shared building blocks of the attention families (RMSNorm, LayerNorm
and the non-parametric LayerNorm; SwiGLU and GeLU MLPs; embeddings;
interleaved rotary embeddings), and the balanced linears of the trunk
(Q4_0, int8 and fp32).

Parameters are plain nested dicts of tensors in the reference's layout
(``(d_in, d_out)`` matrices for ``x @ w``); every ``init_*`` draws from an
explicit :class:`torch.Generator` on its device.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.specs import is_dtensor, shard_offsets
from repro_torch.quant.int8 import (
    QuantizedWeightI8,
    quantize_s8_symmetric,
    quantize_u8_dynamic,
    u8s8_matmul_decompose,
)
from repro_torch.quant.q4 import QuantizedLinear, quantize_q4_0


def _norm_init(cfg: ModelConfig, device) -> dict:
    d = cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"w": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        return {"w": torch.ones((d,), dtype=torch.float32, device=device),
                "b": torch.zeros((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "nonparam_ln":  # olmo: no affine parameters
        return {}
    raise ValueError(cfg.norm)


def norm_fwd(cfg: ModelConfig, p: dict, x: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """``cfg.norm`` (RMSNorm, LayerNorm or the non-parametric LayerNorm)
    computed in float32, returned in x's dtype."""
    xf = x.to(torch.float32)
    if cfg.norm == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
        return (xf * p["w"]).to(x.dtype)
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, -1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    if cfg.norm == "layernorm":
        xf = xf * p["w"] + p["b"]
    return xf.to(x.dtype)


def _dense(gen: torch.Generator, shape: tuple, dtype: torch.dtype, device,
           scale: Optional[float] = None) -> torch.Tensor:
    """N(0, 1) * scale (default ``d_in ** -0.5``) in ``dtype``; a leading
    stack dimension is filled one matrix at a time (no full-stack float32
    temporary)."""
    d_in = shape[-2]
    scale = scale if scale is not None else d_in ** -0.5
    out = torch.empty(shape, dtype=dtype, device=device)
    for mat in out.view(-1, *shape[-2:]):
        mat.copy_(torch.randn(shape[-2:], generator=gen, device=device,
                              dtype=torch.float32) * scale)
    return out


def init_mlp(cfg: ModelConfig, gen: torch.Generator, device,
             n_rep: int = 1) -> dict:
    """MLP weights stacked over ``n_rep`` period repeats: SwiGLU (wi, wg,
    wo) or GeLU (wi, wo)."""
    dt = cfg.cdtype
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp == "swiglu":
        return {
            "wi": _dense(gen, (n_rep, d, f), dt, device),
            "wg": _dense(gen, (n_rep, d, f), dt, device),
            "wo": _dense(gen, (n_rep, f, d), dt, device),
        }
    if cfg.mlp == "gelu":
        return {"wi": _dense(gen, (n_rep, d, f), dt, device),
                "wo": _dense(gen, (n_rep, f, d), dt, device)}
    raise ValueError(cfg.mlp)


def mlp_fwd(cfg: ModelConfig, p: dict, x: torch.Tensor,
            proj: Optional[callable] = None) -> torch.Tensor:
    """SwiGLU or GeLU MLP.  ``proj(name, x, w)`` overrides each projection
    matmul (balanced dispatch of the trunk); default is the plain
    ``x @ w``.  The GeLU is the tanh approximation, ``jax.nn.gelu``'s
    default (``F.gelu``'s default is the exact erf form)."""
    mm = proj or (lambda name, x, w: x @ w)
    if cfg.mlp == "swiglu":
        h = F.silu(mm("wg", x, p["wg"])) * mm("wi", x, p["wi"])
    else:  # gelu
        h = F.gelu(mm("wi", x, p["wi"]), approximate="tanh")
    return mm("wo", h, p["wo"])


def init_embedding(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    p = {"tok": _dense(gen, (cfg.vocab_size, cfg.d_model), cfg.cdtype,
                       device, scale=0.02)}
    if not cfg.tie_embeddings:
        p["out"] = _dense(gen, (cfg.d_model, cfg.vocab_size), cfg.cdtype,
                          device)
    return p


def embed_fwd(cfg: ModelConfig, p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The token rows of the embedding table (on a DTensor table, see
    :func:`_embed_on_shards`)."""
    if is_dtensor(p["tok"]):
        return _embed_on_shards(p["tok"], tokens)
    return p["tok"][tokens.long()]


def _embed_on_shards(tok, tokens):
    """The rows of a DTensor table whose vocab (dim 0) may be split and
    whose d is whole, for tokens split over batch rows (or replicated):
    each rank looks up the tokens that fall in its vocab slice, zeros for
    the others, and the partial rows are summed over the vocab's mesh dims
    (an all-reduce; a reduce-scatter of the rows' gradient comes back).
    DTensor's own strategies for the lookup fail in backward: the
    indexing's ``index_put`` on batch-sharded tokens (torch 2.11), the
    embedding's vocab-parallel partial sum (torch 2.13)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = tok.device_mesh
    if is_dtensor(tokens):
        tok_pl = list(tokens.placements)
        idx = tokens.to_local()
    else:
        tok_pl = [Replicate()] * mesh.ndim
        idx = tokens
    out_pl, whole_pl, grad_pl = [], [], []
    for tp, ip in zip(tok.placements, tok_pl):
        if isinstance(tp, Shard) and tp.dim == 0 and \
                isinstance(ip, Replicate):
            out_pl.append(Partial())
            whole_pl.append(Replicate())
            grad_pl.append(tp)
        elif isinstance(tp, Replicate) and not isinstance(ip, Partial):
            out_pl.append(ip)
            whole_pl.append(ip)
            # the rows of this rank's tokens only: a partial gradient
            grad_pl.append(Partial() if isinstance(ip, Shard) else tp)
        else:
            return F.embedding(tokens.long(), tok)
    local = tok.to_local(grad_placements=grad_pl)
    v0, n = shard_offsets(tok)[0], local.shape[0]
    rel = idx.long() - v0
    inside = (rel >= 0) & (rel < n)
    rows = torch.where(inside[..., None],
                       F.embedding(torch.clamp(rel, 0, n - 1), local),
                       torch.zeros((), dtype=local.dtype,
                                   device=local.device))
    shape = (*tokens.shape, local.shape[1])
    out = DTensor.from_local(rows, mesh, out_pl, run_check=False,
                             shape=shape,
                             stride=torch.empty(shape, device="meta")
                             .stride())
    return out.redistribute(mesh, whole_pl)


def logits_fwd(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    w = p["tok"].T if cfg.tie_embeddings else p["out"]
    return (x @ w).to(torch.float32)


# ------------------------------------------------------- balanced linears --
def _rows(x: torch.Tensor) -> torch.Tensor:
    """(..., K) hidden states as one contiguous (M, K) float32 GEMM/GEMV
    operand."""
    return x.reshape(-1, x.shape[-1]).to(torch.float32).contiguous()


class BalancedQuantLinear:
    """Fp32-Int4-Fp32 linear ``y = x @ W.T`` bound to a balanced dispatcher
    (the paper's decode hot path), holding the Q4_0 weight; bf16 x runs as
    bf16-Int4-bf16 (the kernels' tensor-core body).  The compiled
    lowering (:mod:`repro_torch.kernels.compiled`) runs it as one kernel
    launch and replays the per-core split on the dispatcher; calling it
    runs one real kernel shard per core (eager dispatch), each at the
    dispatcher's tuned launch variant, or at ``variant`` when pinned
    (``("direct",)`` or ``("ring",)``; the reference pins block shapes).
    ``isa`` keys the table per phase: ``"membw"`` for memory-bound decode
    GEMV, ``"avx_vnni"`` when the same weight runs a compute-bound prefill
    GEMM.
    """

    def __init__(self, qw: QuantizedLinear, dispatcher, *,
                 variant: Optional[tuple] = None):
        self.qw = qw
        self.dispatcher = dispatcher
        self.variant = variant

    @classmethod
    def from_dense(cls, w: torch.Tensor, dispatcher, *,
                   variant: Optional[tuple] = None) -> "BalancedQuantLinear":
        """Quantize a dense (N, K) weight to Q4_0 (on w's device) and bind
        the dispatcher."""
        return cls(quantize_q4_0(w.to(torch.float32)), dispatcher,
                   variant=variant)

    @property
    def out_features(self) -> int:
        return self.qw.out_features

    def __call__(self, x: torch.Tensor, *, isa: str = "membw",
                 key: Optional[str] = None) -> torch.Tensor:
        """``x @ W.T`` as per-core shards; bf16 x stays bf16 (the Q4
        kernels' tensor-core body) and gives bf16, any other x runs in
        float32."""
        rows = (x.reshape(-1, x.shape[-1]) if x.dtype == torch.bfloat16
                else _rows(x))
        y = self.dispatcher.q4_matmul(rows, self.qw, isa=isa, key=key,
                                      variant=self.variant)
        return y.reshape(*x.shape[:-1], -1)


class BalancedLinear:
    """Dense linear executed as the paper's prefill path: dynamic u8
    activation quantization + s8 weights through balanced per-core INT8
    GEMM shards (``avx_vnni`` table key), dequantized back to f32."""

    def __init__(self, w_s8: QuantizedWeightI8, dispatcher):
        self.w = w_s8
        self.dispatcher = dispatcher

    @classmethod
    def from_dense(cls, w: torch.Tensor, dispatcher) -> "BalancedLinear":
        """Quantize a dense (N, K) weight to s8 (on w's device)."""
        return cls(quantize_s8_symmetric(w), dispatcher)

    @property
    def out_features(self) -> int:
        return self.w.out_features

    def __call__(self, x: torch.Tensor, *, isa: str = "avx_vnni",
                 key: Optional[str] = None) -> torch.Tensor:
        qa = quantize_u8_dynamic(_rows(x))
        acc = self.dispatcher.int8_gemm(qa.q, self.w.q, isa=isa, key=key)
        y = u8s8_matmul_decompose(qa, self.w, acc)
        return y.reshape(*x.shape[:-1], -1)


class BalancedFp32Linear:
    """Full-precision linear sharded per core through the dispatcher's
    plain ``torch.matmul`` — the trunk's precision-reference path: the
    same product as the monolithic ``x @ W.T`` (N-row shards change no
    output element's terms), yet every call still exercises the
    ratio-table loop and bytes accounting like the quantized paths.  The
    f32 (N, K) weight lives on the device."""

    def __init__(self, w: torch.Tensor, dispatcher):
        self.w = w.to(torch.float32).contiguous()
        self.dispatcher = dispatcher

    @classmethod
    def from_dense(cls, w: torch.Tensor,
                   dispatcher) -> "BalancedFp32Linear":
        return cls(w, dispatcher)

    @property
    def out_features(self) -> int:
        return self.w.shape[0]

    def __call__(self, x: torch.Tensor, *, isa: str = "membw",
                 key: Optional[str] = None) -> torch.Tensor:
        y = self.dispatcher.f32_matmul(_rows(x), self.w, isa=isa, key=key)
        return y.reshape(*x.shape[:-1], -1)


# ----------------------------------------------------------------- rotary --
def rope_angles(positions: torch.Tensor, dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin (..., dim//2)."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=positions.device) / dim))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x (B, H, S, hd); positions (B, S) or (S,).  Interleaved rotary: the
    pairs are dims (0::2, 1::2), as in the reference (not the half-split
    rotation of Hugging Face's Llama).  ``fraction < 1`` rotates only the
    first ``fraction * hd`` dims."""
    hd = x.shape[-1]
    rot = int(hd * fraction)
    rot -= rot % 2
    if positions.dim() == 1:
        positions = positions[None, :]
    cos, sin = rope_angles(positions, rot, theta)  # (B, S, rot/2)
    cos = cos[:, None, :, :]
    sin = sin[:, None, :, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    if rot < hd:
        return torch.cat([yr, xp.to(yr.dtype)], dim=-1).to(x.dtype)
    return yr.to(x.dtype)
