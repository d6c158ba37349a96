"""Sharding rules of the port (FSDP+TP/EP layouts as DTensor placements)."""

from .specs import (
    MeshLayout,
    Sharding,
    layout_of,
    is_dtensor,
    param_shardings,
    state_shardings,
    batch_shardings,
    opt_shardings,
    distribute,
    fsdp_axes,
    data_axes,
    activation_sharding,
    constrain,
    constrain_tree,
    current_mesh,
)

__all__ = [
    "MeshLayout", "Sharding", "layout_of", "is_dtensor",
    "param_shardings", "state_shardings", "batch_shardings",
    "opt_shardings", "distribute", "fsdp_axes", "data_axes",
    "activation_sharding", "constrain", "constrain_tree", "current_mesh",
]
