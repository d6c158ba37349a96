"""Config registry of the port (a copy of ``repro.configs``): assigned
architectures x input shapes.

``get_config(arch)`` returns the exact published configuration;
``reduced_config(arch)`` returns a family-preserving shrunken version for
CPU smoke tests; ``SHAPES``/``cells()`` enumerate the assigned
(architecture x input-shape) grid with the long_500k sub-quadratic rule.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from importlib import import_module
from typing import Iterator

from .base import ModelConfig, MoEConfig, SSMConfig, XLSTMConfig

ARCHS = (
    "granite-moe-1b-a400m",
    "llama4-maverick-400b-a17b",
    "granite-8b",
    "chatglm3-6b",
    "starcoder2-15b",
    "olmo-1b",
    "xlstm-1.3b",
    "jamba-1.5-large-398b",
    "internvl2-26b",
    "musicgen-medium",
)
EXTRA_ARCHS = ("llama2-7b",)  # the paper's own model

_MODULES = {
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "granite-8b": "granite_8b",
    "chatglm3-6b": "chatglm3_6b",
    "starcoder2-15b": "starcoder2_15b",
    "olmo-1b": "olmo_1b",
    "xlstm-1.3b": "xlstm_1_3b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "internvl2-26b": "internvl2_26b",
    "musicgen-medium": "musicgen_medium",
    "llama2-7b": "llama2_7b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return import_module(f".{_MODULES[arch]}", __package__).CONFIG


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str   # "train" | "prefill" | "decode"
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def shape_supported(cfg: ModelConfig, shape: str) -> bool:
    """long_500k runs only for sub-quadratic archs (SSM/hybrid); pure
    full-attention archs skip it (recorded per cell in EXPERIMENTS.md)."""
    if shape == "long_500k":
        return cfg.sub_quadratic
    return True


def cells(include_skipped: bool = False) -> Iterator[tuple[str, str, bool]]:
    """All 40 assigned (arch, shape) cells; yields (arch, shape, supported)."""
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES:
            ok = shape_supported(cfg, shape)
            if ok or include_skipped:
                yield arch, shape, ok


def reduced_config(arch: str) -> ModelConfig:
    """Family-preserving shrink for CPU smoke tests: same mixer pattern,
    norm, MLP kind, GQA structure and MoE-ness — tiny dims."""
    cfg = get_config(arch)
    period_len = len(cfg.period())
    n_layers = period_len * min(2, cfg.n_periods)
    n_heads = 4
    n_kv = max(1, round(n_heads * cfg.n_kv_heads / cfg.n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    changes: dict = dict(
        n_layers=n_layers,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=512,
        head_dim=None,
        attn_chunk=16,
        n_prefix=8 if cfg.n_prefix else 0,
        dtype="float32",
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=min(8, cfg.moe.n_experts),
            top_k=min(cfg.moe.top_k, min(8, cfg.moe.n_experts)),
            d_ff=64,
        )
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(cfg.ssm, chunk=8)
    if cfg.xlstm is not None:
        changes["xlstm"] = dataclasses.replace(cfg.xlstm, chunk=8)
    return dataclasses.replace(cfg, **changes)


__all__ = [
    "ARCHS",
    "EXTRA_ARCHS",
    "SHAPES",
    "ShapeSpec",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "XLSTMConfig",
    "get_config",
    "reduced_config",
    "cells",
    "shape_supported",
]
