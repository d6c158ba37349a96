"""The plain reference of the configurations' decoder: a full causal forward
pass over whole sequences in float32, without a cache, batching, kernels
or anything of the program.

The model is the configuration as it is served: token embedding;
per layer RMSNorm (eps 1e-5), grouped-query attention with interleaved
rotary embeddings (pairs of dims (0, 1), (2, 3), ...) and softmax scaled
by head_dim ** -0.5, a residual add, RMSNorm, then a SwiGLU MLP
(silu(x W_gate) * (x W_up)) W_down or a mixture of SwiGLU experts
(softmax router, the top k by probability, their probabilities
renormalised, every routed token computed: no capacity), a residual add;
a final RMSNorm and the output head.  With ``trunk_quant: q4`` every
attention and MLP matrix and the head go through Q4_0 (:mod:`.q4`), as
the deployment stores them; the embedding, the router and the experts stay
as given.

The weights are the benchmark's, in the port's parameter layout (matrices
(d_in, d_out) stacked over the layers of each position of the period).

``precision="fp8"`` is the control: the same model with every activation
that the configuration holds in bfloat16 held in float8 e4m3 instead (the
inputs of every product, K and V, the residual stream), each row scaled
by its largest magnitude, as a float8 deployment would.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Sequence

import torch
import torch.nn.functional as F

from .q4 import q4_0

E4M3_MAX = 448.0
EPS = 1e-5


@dataclass(frozen=True)
class Spec:
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    vocab: int
    experts: int
    top_k: int
    rope_theta: float
    tied: bool
    q4: bool

    @classmethod
    def from_config(cls, config: dict) -> "Spec":
        m = config["model"]
        d, h = int(m["hidden_size"]), int(m["num_attention_heads"])
        return cls(layers=int(m["num_hidden_layers"]), d=d, heads=h,
                   kv_heads=int(m["num_key_value_heads"]),
                   head_dim=int(m.get("head_dim", d // h)),
                   ff=int(m["intermediate_size"]),
                   vocab=int(m["vocab_size"]),
                   experts=int(m.get("num_local_experts", 0)),
                   top_k=int(m.get("num_experts_per_tok", 0)),
                   rope_theta=float(m["rope_theta"]),
                   tied=bool(m.get("tie_word_embeddings", False)),
                   q4=config["deployment"]["trunk_quant"] == "q4")


def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.abs().amax(-1, keepdim=True).clamp(min=1e-30)
    s = amax / E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _rms(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + EPS) * w


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, hd) rotated at positions 0..S-1, interleaved pairs."""
    s, _, hd = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


@contextlib.contextmanager
def _full_f32():
    """float32 products in full float32 (no TF32) while the reference runs."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


class Decoder:
    """The reference over ``params`` (the benchmark's weights)."""

    def __init__(self, spec: Spec, params: dict, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.spec = spec
        self.params = params
        self.rnd = _fp8 if precision == "fp8" else (lambda t: t)

    # ------------------------------------------------------------ weights --
    def _mat(self, w: torch.Tensor) -> torch.Tensor:
        """A stored (d_in, d_out) matrix as the f32 (d_out, d_in) it acts
        as: through Q4_0 where the deployment stores it so."""
        wt = w.t().to(torch.float32)
        return q4_0(wt) if self.spec.q4 else wt

    def _layer(self, i: int) -> dict:
        period = self.params["period"]
        p = period[i % len(period)]
        r = i // len(period)
        out = {"norm1": p["norm1"]["w"][r].float(),
               "norm2": p["norm2"]["w"][r].float()}
        for name in ("wq", "wk", "wv", "wo"):
            out[name] = self._mat(p["mixer"][name][r])
        f = p["ffn"]
        if self.spec.experts:
            out["router"] = f["router"][r].float()
            for name in ("wi", "wg", "wo"):
                out["e" + name] = f[name][r]          # bf16, cast per expert
        else:
            for name in ("wi", "wg", "wo"):
                out["m" + name] = self._mat(f[name][r])
        return out

    def _head(self) -> torch.Tensor:
        emb = self.params["embed"]
        if self.spec.tied:
            w = emb["tok"].to(torch.float32)
            return q4_0(w) if self.spec.q4 else w
        return self._mat(emb["out"])

    # ------------------------------------------------------------ forward --
    def _attention(self, w: dict, h: torch.Tensor) -> torch.Tensor:
        sp, rnd = self.spec, self.rnd
        s = h.shape[0]
        g = sp.heads // sp.kv_heads
        q = _rope((h @ w["wq"].t()).view(s, sp.heads, sp.head_dim),
                  sp.rope_theta)
        k = rnd(_rope((h @ w["wk"].t()).view(s, sp.kv_heads, sp.head_dim),
                      sp.rope_theta))
        v = rnd((h @ w["wv"].t()).view(s, sp.kv_heads, sp.head_dim))
        qg = q.view(s, sp.kv_heads, g, sp.head_dim).permute(1, 2, 0, 3)
        scores = torch.einsum("hgsd,thd->hgst", qg, k) * sp.head_dim ** -0.5
        causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
        scores = scores.masked_fill(~causal, float("-inf"))
        out = torch.einsum("hgst,thd->hgsd", torch.softmax(scores, -1), v)
        out = out.permute(2, 0, 1, 3).reshape(s, sp.heads * sp.head_dim)
        return rnd(out) @ w["wo"].t()

    def _moe(self, w: dict, h: torch.Tensor) -> torch.Tensor:
        sp, rnd = self.spec, self.rnd
        probs = torch.softmax(h @ w["router"], dim=-1)
        top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_p, top_e = top_p[:, :sp.top_k], top_e[:, :sp.top_k]
        top_p = top_p / top_p.sum(-1, keepdim=True)
        y = torch.zeros_like(h)
        for e in range(sp.experts):
            rows, slot = (top_e == e).nonzero(as_tuple=True)
            if rows.numel() == 0:
                continue
            x = h[rows]
            a = F.silu(x @ w["ewg"][e].float()) * (x @ w["ewi"][e].float())
            y.index_add_(0, rows,
                         (rnd(a) @ w["ewo"][e].float()) * top_p[rows, slot, None])
        return y

    def _block(self, w: dict, x: torch.Tensor) -> torch.Tensor:
        rnd = self.rnd
        x = rnd(x + self._attention(w, rnd(_rms(x, w["norm1"]))))
        h = rnd(_rms(x, w["norm2"]))
        if self.spec.experts:
            y = self._moe(w, h)
        else:
            a = F.silu(h @ w["mwg"].t()) * (h @ w["mwi"].t())
            y = rnd(a) @ w["mwo"].t()
        return rnd(x + y)

    def logits(self, seqs: Sequence[torch.Tensor],
               firsts: Sequence[int]) -> List[torch.Tensor]:
        """For each sequence of token ids and the index ``first`` of its
        first served token: the logits (n, vocab) at the positions that
        predict tokens ``first .. len - 1``.  Layer by layer over all the
        sequences, so one layer's weights are held at a time."""
        rnd = self.rnd
        with torch.no_grad(), _full_f32():
            tok = self.params["embed"]["tok"]
            xs = [rnd(tok[s.long()].to(torch.float32)) for s in seqs]
            for i in range(self.spec.layers):
                w = self._layer(i)
                xs = [self._block(w, x) for x in xs]
                del w
            head = self._head()
            fn = self.params["final_norm"]["w"].float()
            return [rnd(_rms(x[f - 1:-1], fn)) @ head.t()
                    for x, f in zip(xs, firsts)]
