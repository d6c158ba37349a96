"""Carry weights across from the reference: ``repro``'s parameter pytree,
converted leaf by leaf to numpy by the caller (``jax.tree.map(np.asarray,
params)``), becomes the port's parameter dict.

The layout is kept as it is — the same nesting, the same stacked-per-period
leading axis, the same ``(d_in, d_out)`` orientation — so both packages
compute the same function of the same weights.  bfloat16 leaves (numpy's
``ml_dtypes.bfloat16``) are carried bit for bit.  The optimizer state
crosses the same way (:func:`opt_state_from_numpy`), so both packages can
take an optimizer step from one state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["params_from_numpy", "opt_state_from_numpy", "to_torch"]


def to_torch(leaf, device) -> torch.Tensor:
    """One numpy leaf as a tensor on ``device`` (a copy)."""
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_numpy(tree, *, device="cuda"):
    """Map a nested dict / list / tuple of numpy arrays to the same
    structure of tensors on ``device``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return to_torch(node, dev)

    return conv(tree)


def opt_state_from_numpy(state, *, device="cuda"):
    """The reference's ``OptState(step, mu, nu)``, converted leaf by leaf to
    numpy by the caller (plain or factored: a bf16 ``mu`` and ``{"row",
    "col"}`` second-moment statistics), as the port's
    :class:`~repro_torch.training.optimizer.OptState` on ``device``."""
    from repro_torch.training.optimizer import OptState

    return OptState(step=to_torch(state.step, resolve_device(device)),
                    mu=params_from_numpy(state.mu, device=device),
                    nu=params_from_numpy(state.nu, device=device))
