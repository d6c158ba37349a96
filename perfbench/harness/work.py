"""The yardstick's work counts and the card's peaks.

They count the work the configuration needs, whatever implements it, from
the configuration file's sizes alone:

* a Q4_0 product of (M, N, K): the weight's Q4_0 bytes once (18 bytes per
  32 weights: 16 of codes, a 2-byte scale), x (M, K) once and y (M, N)
  once in the activations' type (bfloat16), and 2·M·N·K operations;
* an iteration (a prefill chunk and/or a decode step): every weight once
  in its stored format (the trunk's and the head's Q4_0, the norms, the
  router and, of the experts, those that tokens were routed to, in
  bfloat16), the embedding rows it looks up, the KV of the live contexts
  read once and the new K/V written once; operations 2 per weight per
  token, plus attention's 4·heads·head_dim per query and key.  The cache
  buffer past a live context is not counted.

A bound is the larger of bytes over the HBM bandwidth and operations over
the bfloat16 dense peak: a lower bound on the card's time, so a share of it
cannot pass 1 unless a count is too high or a time leaves work out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
Q4_BYTES_PER_WEIGHT = 18 / 32
ACT_BYTES = 2           # bfloat16 activations and KV cache
F32_BYTES = 4


@dataclass(frozen=True)
class Model:
    """The sizes a work count needs (a configuration file's ``model``)."""

    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    vocab: int
    experts: int = 0
    top_k: int = 0
    tied: bool = False

    @classmethod
    def from_config(cls, model: dict) -> "Model":
        d, h = int(model["hidden_size"]), int(model["num_attention_heads"])
        return cls(layers=int(model["num_hidden_layers"]), d=d, heads=h,
                   kv_heads=int(model["num_key_value_heads"]),
                   head_dim=int(model.get("head_dim", d // h)),
                   ff=int(model["intermediate_size"]),
                   vocab=int(model["vocab_size"]),
                   experts=int(model.get("num_local_experts", 0)),
                   top_k=int(model.get("num_experts_per_tok", 0)),
                   tied=bool(model.get("tie_word_embeddings", False)))

    @property
    def moe(self) -> bool:
        return self.experts > 0

    def q4_layer(self) -> List[Tuple[int, int]]:
        """(N, K) of one layer's Q4_0 products: q, k, v, o, and the dense
        MLP's up, gate and down (an MoE's experts stay bfloat16)."""
        d, qd, kvd = self.d, self.heads * self.head_dim, \
            self.kv_heads * self.head_dim
        out = [(qd, d), (kvd, d), (kvd, d), (d, qd)]
        if not self.moe:
            out += [(self.ff, d), (self.ff, d), (d, self.ff)]
        return out

    def kv_bytes_per_token(self) -> int:
        """K and V of one token in every layer."""
        return 2 * self.layers * self.kv_heads * self.head_dim * ACT_BYTES


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)


def q4_launch(m: int, n: int, k: int) -> Tuple[float, float]:
    """(bytes, operations) of one Q4_0 product."""
    nbytes = n * k * Q4_BYTES_PER_WEIGHT + (m * k + m * n) * ACT_BYTES
    return nbytes, 2.0 * m * n * k


def q4_launches(model: Model, prefill_len: Optional[int],
                decode_rows: int) -> List[Tuple[int, int, int]]:
    """(M, N, K) of every Q4_0 launch of an iteration, in launch order: a
    prefill chunk's layers at M = its length and its head at M = 1 (the
    last position's logits), then the decode step's layers and head at M =
    the rows it runs."""
    out: List[Tuple[int, int, int]] = []
    for m, head_m in ((prefill_len, 1), (decode_rows, decode_rows)):
        if not m:
            continue
        for _ in range(model.layers):
            out += [(m, n, k) for n, k in model.q4_layer()]
        out.append((head_m, model.vocab, model.d))
    return out


def q4_bound_s(launches: Iterable[Tuple[int, int, int]]) -> float:
    return sum(bound_s(*q4_launch(m, n, k)) for m, n, k in launches)


def experts_touched(model: Model, tokens: int) -> float:
    """Experts per layer that at least one of ``tokens`` routes to, as
    expected under uniform routing: E · (1 − (1 − k/E)^tokens)."""
    if not model.moe or tokens <= 0:
        return 0.0
    e, k = model.experts, model.top_k
    return e * (1.0 - (1.0 - k / e) ** tokens)


def weight_bytes(model: Model, tokens: int) -> float:
    """Every weight an iteration over ``tokens`` tokens reads once: the
    Q4_0 trunk and head, the norms (f32), the embedding rows, and for an
    MoE the router (f32) and the touched experts (bfloat16)."""
    d = model.d
    q4 = model.layers * sum(n * k for n, k in model.q4_layer())
    q4 += model.vocab * d
    total = q4 * Q4_BYTES_PER_WEIGHT
    total += (2 * model.layers + 1) * d * F32_BYTES
    total += tokens * d * ACT_BYTES
    if model.moe:
        total += model.layers * d * model.experts * F32_BYTES
        total += (model.layers * experts_touched(model, tokens)
                  * 3 * d * model.ff * ACT_BYTES)
    return total


def token_flops(model: Model) -> float:
    """Operations of one token through the trunk's products (without the
    head and attention's scores)."""
    per = 2.0 * sum(n * k for n, k in model.q4_layer())
    if model.moe:
        per += 2.0 * model.d * model.experts
        per += 2.0 * model.top_k * 3 * model.d * model.ff
    return model.layers * per


def attn_flops(model: Model, queries_keys: float) -> float:
    """QK^T and PV over ``queries_keys`` (query, key) pairs per layer."""
    return 4.0 * model.layers * model.heads * model.head_dim * queries_keys


def iteration_work(model: Model, prefill: Optional[Sequence[int]],
                   decode_ctx: Sequence[int]) -> Tuple[float, float]:
    """(bytes, operations) of an iteration: ``prefill`` is (start, length,
    last) of its chunk or None; ``decode_ctx`` the cache rows of each live
    decoded row after its step (its new token's included)."""
    tokens = len(decode_ctx)
    kv_tok = model.kv_bytes_per_token()
    nbytes, flops = 0.0, 0.0
    if prefill is not None:
        s0, n, last = prefill
        tokens += n
        nbytes += (s0 + n) * kv_tok            # s0 read, n written
        flops += token_flops(model) * n
        flops += attn_flops(model, n * s0 + n * (n + 1) / 2)
        if last:
            flops += 2.0 * model.d * model.vocab
    for c in decode_ctx:
        nbytes += c * kv_tok                   # c - 1 read, 1 written
        flops += token_flops(model) + 2.0 * model.d * model.vocab
        flops += attn_flops(model, c)
    nbytes += weight_bytes(model, tokens)
    return nbytes, flops


def iteration_bound_s(model: Model, prefill, decode_ctx) -> float:
    return bound_s(*iteration_work(model, prefill, decode_ctx))
