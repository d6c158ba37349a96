"""Config registry of the port.

``get_config(arch)`` returns the exact published configuration;
``reduced_config(arch)`` returns the same family-preserving shrink as
``repro.configs.reduced_config`` (tiny dims, f32) for CPU tests.  The port
carries the paper's own model, llama2-7b; the rest of the zoo follows the
models that serve it.
"""

from __future__ import annotations

import dataclasses
from importlib import import_module

from .base import ModelConfig, MoEConfig, SSMConfig, XLSTMConfig

ARCHS = ("llama2-7b",)

_MODULES = {
    "llama2-7b": "llama2_7b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port carries "
                       f"{sorted(_MODULES)} (the rest is not ported yet)")
    return import_module(f".{_MODULES[arch]}", __package__).CONFIG


def reduced_config(arch: str) -> ModelConfig:
    """Family-preserving shrink for CPU tests: same mixer pattern, norm,
    MLP kind and GQA structure — tiny dims (identical to the reference's
    shrink for the dense family)."""
    cfg = get_config(arch)
    if cfg.moe is not None or cfg.ssm is not None or cfg.xlstm is not None:
        raise NotImplementedError(
            f"{arch}: only the dense family is ported yet")
    period_len = len(cfg.period())
    n_layers = period_len * min(2, cfg.n_periods)
    n_heads = 4
    n_kv = max(1, round(n_heads * cfg.n_kv_heads / cfg.n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    return dataclasses.replace(
        cfg,
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


__all__ = [
    "ARCHS",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "XLSTMConfig",
    "get_config",
    "reduced_config",
]
