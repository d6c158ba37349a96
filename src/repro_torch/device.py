"""Device resolution for the port's entry points and constructors."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; raises when CUDA is asked for
    and this process has no CUDA device (the port never falls back to the
    CPU on its own).  ``"meta"`` (shapes and dtypes, no storage: the dry
    run's abstract trees) is accepted, and no entry point defaults to it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda, cpu or "
                         f"meta)")
    return dev
