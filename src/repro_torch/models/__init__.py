"""Models of the port: the whole zoo (attention families — dense, MoE and
the backbones behind stub frontends — and the recurrent mixers of the
hybrid and xLSTM families in :mod:`.ssm` and :mod:`.xlstm`), its balanced
trunk, and the weight converter from the reference's pytrees."""

from .transformer import (
    balanced_lm_head,
    init_params,
    init_state,
    init_slot_state,
    forward,
    ForwardOut,
    loss_fn,
)
from .layers import BalancedFp32Linear, BalancedLinear, BalancedQuantLinear
from .balanced import BalancedTrunk
from .convert import opt_state_from_numpy, params_from_numpy
from . import ssm, xlstm

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
    "loss_fn",
    "params_from_numpy",
    "opt_state_from_numpy",
]
