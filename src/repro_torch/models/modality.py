"""Modality-frontend STUBS for the backbone-only architectures.

The [vlm] and [audio] entries of the zoo specify the transformer backbone
only; the frontend (InternViT vision tower, EnCodec audio codec) is a stub.
The ``*_spec`` helpers describe the precomputed patch or frame embeddings
the backbone takes (shape and dtype), and the ``*_stub`` helpers draw
concrete stand-ins from an explicit :class:`torch.Generator` (the
reference's draw from ``jax.random``, which torch cannot reproduce, so
parity tests feed both packages the same numpy embeddings instead).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

__all__ = ["EmbedSpec", "vlm_prefix_spec", "vlm_prefix_stub",
           "audio_frame_spec", "audio_frame_stub"]


class EmbedSpec(NamedTuple):
    """Shape and dtype of a precomputed embedding input."""

    shape: tuple
    dtype: torch.dtype


def vlm_prefix_spec(cfg: ModelConfig, batch: int) -> EmbedSpec:
    """Precomputed vision-patch embeddings (InternViT output, projected)."""
    return EmbedSpec((batch, cfg.n_prefix, cfg.d_model), cfg.cdtype)


def _stub(spec: EmbedSpec, gen: Optional[torch.Generator], seed: int,
          device) -> torch.Tensor:
    device = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(spec.shape, generator=gen, device=device,
                        dtype=torch.float32) * 0.02).to(spec.dtype)


def vlm_prefix_stub(cfg: ModelConfig, batch: int,
                    gen: Optional[torch.Generator] = None, *,
                    device="cuda") -> torch.Tensor:
    """N(0, 0.02) patch embeddings of :func:`vlm_prefix_spec`'s shape, from
    ``gen`` (a generator on ``device``; seed 0 when None)."""
    return _stub(vlm_prefix_spec(cfg, batch), gen, 0, device)


def audio_frame_spec(cfg: ModelConfig, batch: int, seq: int) -> EmbedSpec:
    """Precomputed EnCodec frame embeddings (sum of codebook embeddings)."""
    return EmbedSpec((batch, seq, cfg.d_model), cfg.cdtype)


def audio_frame_stub(cfg: ModelConfig, batch: int, seq: int,
                     gen: Optional[torch.Generator] = None, *,
                     device="cuda") -> torch.Tensor:
    """N(0, 0.02) frame embeddings of :func:`audio_frame_spec`'s shape,
    from ``gen`` (a generator on ``device``; seed 1 when None)."""
    return _stub(audio_frame_spec(cfg, batch, seq), gen, 1, device)
