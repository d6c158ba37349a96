"""Models of the port: the zoo's attention families (dense, MoE, and the
backbones behind stub frontends), its balanced trunk, and the weight
converter from the reference's pytrees."""

from .transformer import (
    balanced_lm_head,
    init_params,
    init_state,
    init_slot_state,
    forward,
    ForwardOut,
)
from .layers import BalancedFp32Linear, BalancedLinear, BalancedQuantLinear
from .balanced import BalancedTrunk
from .convert import params_from_numpy

__all__ = [
    "BalancedTrunk",
    "BalancedQuantLinear",
    "BalancedLinear",
    "BalancedFp32Linear",
    "balanced_lm_head",
    "init_params",
    "init_state",
    "init_slot_state",
    "forward",
    "ForwardOut",
    "params_from_numpy",
]
