"""Model configuration schema (copy of ``repro.configs.base``; ``cdtype`` is a
:class:`torch.dtype`)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    every: int = 1            # MoE ffn on layers where (idx % every) == every-1
    capacity_factor: float = 1.25
    shared_expert: bool = False  # llama4-style always-on shared expert
    d_ff: Optional[int] = None   # per-expert hidden dim (defaults to cfg.d_ff)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    chunk: int = 64           # selective-scan chunk length (memory control)


@dataclass(frozen=True)
class XLSTMConfig:
    conv_kernel: int = 4
    qk_dim_factor: float = 0.5
    proj_factor: float = 2.0  # mLSTM up-projection factor
    chunk: int = 64           # mLSTM chunkwise-parallel length
    slstm_every: int = 8      # one sLSTM block per this many blocks (7:1)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None
    norm: str = "rmsnorm"     # rmsnorm | layernorm | nonparam_ln
    mlp: str = "swiglu"       # swiglu | gelu | none
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0   # chatglm applies rotary to half the dims
    qkv_bias: bool = False
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None

    # mixer kind per layer within one period; tiled to n_layers.
    # kinds: "attn", "mamba", "mlstm", "slstm"
    mixer_pattern: Tuple[str, ...] = ("attn",)

    # Modality stubs (backbone-only archs): number of precomputed prefix
    # embeddings (vlm) or whether token input is replaced by frame
    # embeddings entirely (audio).
    n_prefix: int = 0
    embed_input: bool = False   # True: forward consumes (B, T, d) embeddings

    dtype: str = "bfloat16"
    attn_chunk: int = 512       # query-chunk size for memory-bounded attention
    sub_quadratic: bool = False # eligible for long_500k cells

    # ------------------------------------------------------------------ #
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def cdtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def mixer_at(self, idx: int) -> str:
        return self.mixer_pattern[idx % len(self.mixer_pattern)]

    def ffn_at(self, idx: int) -> str:
        """'moe' | 'dense' | 'none' for layer idx."""
        if self.moe is not None and (idx % self.moe.every) == self.moe.every - 1:
            return "moe"
        return "none" if self.mlp == "none" else "dense"

    def layer_plan(self) -> Tuple[Tuple[str, str], ...]:
        """Full per-layer (mixer, ffn) plan of length n_layers."""
        return tuple(
            (self.mixer_at(i), self.ffn_at(i)) for i in range(self.n_layers)
        )

    def period(self) -> Tuple[Tuple[str, str], ...]:
        """Smallest repeating (mixer, ffn) unit — the scan body."""
        plan = self.layer_plan()
        for plen in range(1, self.n_layers + 1):
            if self.n_layers % plen:
                continue
            if all(plan[i] == plan[i % plen] for i in range(self.n_layers)):
                return plan[:plen]
        return plan

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.period())

    def param_count(self) -> int:
        """Approximate parameter count N (for 6ND model-flops)."""
        d, hd = self.d_model, self.hd
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for mixer, ffn in self.layer_plan():
            if mixer == "attn":
                total += d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            elif mixer == "mamba":
                di = self.ssm.expand * d
                total += 2 * d * di + di * (self.ssm.d_conv + 2 * self.ssm.d_state + 2) + di * d
            elif mixer == "mlstm":
                x = self.xlstm
                di = int(x.proj_factor * d)
                dv = di // self.n_heads
                dq = max(8, int(x.qk_dim_factor * dv))
                # up+gate, block-diag q/k/v, down
                total += 2 * d * di + di * (2 * dq + dv) + di * d
            elif mixer == "slstm":
                dh = d // self.n_heads
                total += 4 * d * d + self.n_heads * dh * 4 * dh + d * d
            if ffn == "dense":
                mult = 3 if self.mlp == "swiglu" else 2
                total += mult * d * self.d_ff
            elif ffn == "moe":
                m = self.moe
                dff = m.d_ff or self.d_ff
                total += m.n_experts * 3 * d * dff + d * m.n_experts
                if m.shared_expert:
                    total += 3 * d * dff
            total += 2 * d  # norms
        return total

    def active_param_count(self) -> int:
        """Active N per token (MoE: only routed-to experts count)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        dff = m.d_ff or self.d_ff
        total = self.param_count()
        n_moe_layers = sum(1 for _, f in self.layer_plan() if f == "moe")
        total -= n_moe_layers * (m.n_experts - m.top_k) * 3 * self.d_model * dff
        return total
