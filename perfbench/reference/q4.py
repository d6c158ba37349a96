"""Q4_0 (the llama.cpp layout the configuration states), worked out by the
reference itself from the dense weights.

Per group of 32 consecutive input elements of a row: the scale is the
group's largest-magnitude element (the first such, with its sign) over
-8, computed in float32 and stored as float16; the code of an element is
round-half-to-even(x / scale) + 8, clamped to [0, 15].  An element is
(code - 8) times the stored scale.
"""

from __future__ import annotations

import torch

GROUP = 32


def q4_0(w: torch.Tensor) -> torch.Tensor:
    """W (N, K) through Q4_0 and back: float32 (N, K)."""
    n, k = w.shape
    if k % GROUP:
        raise ValueError(f"K={k} is not a multiple of {GROUP}")
    g = w.reshape(n, k // GROUP, GROUP).to(torch.float32)
    first_max = torch.argmax(g.abs(), dim=-1, keepdim=True)
    scale = torch.gather(g, -1, first_max) / -8.0
    inv = torch.where(scale == 0, torch.zeros_like(scale), 1.0 / scale)
    code = torch.clamp(torch.round(g * inv) + 8.0, 0.0, 15.0)
    stored = scale.to(torch.float16).to(torch.float32)
    return ((code - 8.0) * stored).reshape(n, k)
