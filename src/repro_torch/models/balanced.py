"""Balanced trunk: every projection of the decode step through the paper's
per-core split.

:class:`BalancedTrunk` turns every trunk projection (q/k/v/o, MLP
up/gate/down) and the LM head into a dispatcher-bound balanced linear —
:class:`~repro_torch.models.layers.BalancedQuantLinear` (Q4_0 decode
GEMV), :class:`~repro_torch.models.layers.BalancedLinear` (dynamic-u8 x s8
INT8 GEMM) or :class:`~repro_torch.models.layers.BalancedFp32Linear`
(precision reference) — and hands the trunk forward a per-layer
projection hook.  Two execution modes:

* ``mode="compiled"``: each projection is one CUDA kernel launch (one
  ``torch.matmul`` for fp32) whose per-core boundaries are device offset
  tensors planned *between* engine steps, with a cost tape feeding the
  Eq. 2 EMA updates after the step (:mod:`repro_torch.kernels.compiled`);
* ``mode="eager"``: each projection plans its per-core split when it is
  called and runs one kernel launch per core on that core's weight rows,
  feeding the shard times back at once — the paper's own execution model
  and the port's counterpart of the reference's eager and bridge modes
  (the reference's io_callback bridge has no meaning in torch).

Table keys are per (ISA x layer kind): ``kernel_key("membw",
"attn_proj")``, ... (see :data:`~repro_torch.kernels.dispatch.TRUNK_KINDS`).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.dispatch import kernel_key

from .layers import BalancedFp32Linear, BalancedLinear, BalancedQuantLinear

__all__ = ["BalancedTrunk", "QUANT_MODES"]

QUANT_MODES = ("q4", "int8", "fp32")

_LAYER_CLS = {
    "q4": BalancedQuantLinear,
    "int8": BalancedLinear,
    "fp32": BalancedFp32Linear,
}

# (group, param name) -> ratio-table layer kind
_KIND = {
    ("attn", "wq"): "attn_proj",
    ("attn", "wk"): "attn_proj",
    ("attn", "wv"): "attn_proj",
    ("attn", "wo"): "attn_proj",
    ("ffn", "wi"): "mlp_up",
    ("ffn", "wg"): "mlp_up",
    ("ffn", "wo"): "mlp_down",
}


class BalancedTrunk:
    """Balanced projection bank for a model's whole trunk.

    ``bank[(j, group, name)]`` holds one balanced linear per period repeat
    for period position ``j`` and parameter ``name`` of ``group`` ("attn"
    mixer or dense "ffn").  MoE FFNs are not banked: their experts run
    plain inside the forward, as in the reference.  ``head`` is the
    optional balanced LM head (kind ``"head"``).  The weights live on
    ``device``.
    """

    MODES = ("compiled", "eager")

    def __init__(self, cfg: ModelConfig, dispatcher, *,
                 bank: Dict[Tuple[int, str, str], List],
                 head=None, quant: str = "q4", mode: str = "compiled",
                 double_buffer: bool = True, device="cuda"):
        if mode not in self.MODES:
            raise ValueError(f"mode must be one of {self.MODES} (the "
                             f"reference's 'bridge' has no counterpart)")
        self.cfg = cfg
        self.dispatcher = dispatcher
        self.bank = bank
        self.head = head
        self.quant = quant
        self.mode = mode
        self.double_buffer = double_buffer
        self.device = resolve_device(device)
        self._ctx = None  # lazy CompiledDispatcher

    # -------------------------------------------------------- construction --
    @classmethod
    def from_params(cls, cfg: ModelConfig, params: dict, dispatcher, *,
                    quant: str = "q4", include_head: bool = True,
                    mode: str = "compiled", double_buffer: bool = True,
                    pin_q4_blocks: bool = False,
                    device="cuda") -> "BalancedTrunk":
        """Quantize (or copy, for fp32) every trunk projection of
        ``params`` into dispatcher-bound balanced linears on ``device``.

        Weights are stored transposed relative to the forward's ``x @ w``
        convention: a (d_in, d_out) parameter becomes an (N, K) = (d_out,
        d_in) balanced linear computing ``x @ W.T``.

        ``pin_q4_blocks`` pins every eager Q4 shard to the launch variant
        the compiled lowering launches (``("ring",)`` while
        ``double_buffer``, else ``("direct",)``), so the kernel tuner is
        skipped for them.  Unlike the reference's, where ``bk`` sets the
        order of the sums, the port's bits are the same either way: every
        Q4 launch sums in an order set by K alone, at the same blocks
        (:func:`~repro_torch.kernels.ops.q4_blocks`).  An fp32 trunk
        switches TF32 off for the process's CUDA matmuls (PyTorch's
        default), so its products are full float32.
        """
        if quant not in QUANT_MODES:
            raise ValueError(f"quant must be one of {QUANT_MODES}")
        layer_cls = _LAYER_CLS[quant]
        dev = resolve_device(device)
        if quant == "fp32":
            torch.backends.cuda.matmul.fp32_precision = "ieee"

        def make_layer(w):  # w is dense (N, K)
            if quant == "q4" and pin_q4_blocks:
                return layer_cls.from_dense(
                    w.to(dev), dispatcher,
                    variant=("ring",) if double_buffer else ("direct",))
            return layer_cls.from_dense(w.to(dev), dispatcher)

        bank: Dict[Tuple[int, str, str], List] = {}
        for j, (mixer, ffn) in enumerate(cfg.period()):
            groups = []
            if mixer == "attn":
                groups.append(("attn", ("wq", "wk", "wv", "wo")))
            if ffn == "dense":
                names = (("wi", "wg", "wo") if cfg.mlp == "swiglu"
                         else ("wi", "wo"))
                groups.append(("ffn", names))
            for group, names in groups:
                stack = params["period"][j]["mixer" if group == "attn" else "ffn"]
                for name in names:
                    w_stack = stack[name]  # (n_rep, d_in, d_out)
                    bank[(j, group, name)] = [
                        make_layer(w_stack[r].T)
                        for r in range(cfg.n_periods)
                    ]
        head = None
        if include_head:
            w = (params["embed"]["tok"] if cfg.tie_embeddings
                 else params["embed"]["out"].T)  # (vocab, d_model)
            head = make_layer(w)
        return cls(cfg, dispatcher, bank=bank, head=head, quant=quant,
                   mode=mode, double_buffer=double_buffer, device=dev)

    # ------------------------------------------------------------ compiled --
    def _compiled(self):
        """The lazily-built :class:`~repro_torch.kernels.compiled.
        CompiledDispatcher` for this trunk, with every banked call site
        (both phase ISAs, plus the head) pre-registered in the reference's
        order, so the offset snapshot's keyset is complete before the
        first step."""
        if self.mode != "compiled":
            raise ValueError(f"trunk mode is {self.mode!r}, not 'compiled'")
        if self._ctx is None:
            from repro_torch.kernels.compiled import CompiledDispatcher

            ctx = CompiledDispatcher(self.dispatcher,
                                     double_buffer=self.double_buffer,
                                     device=self.device)
            for (j, group, name), layers in self.bank.items():
                for isa in ("membw", "avx_vnni"):
                    ctx.spec_for(layers[0], isa, _KIND[(group, name)])
            if self.head is not None:
                for isa in ("membw", "avx_vnni"):
                    ctx.spec_for(self.head, isa, "head")
            self._ctx = ctx
        return self._ctx

    def compiled_refresh(self):
        """Re-plan all call sites from the current ratio tables; returns
        the device offset snapshot to pass into the next step."""
        return self._compiled().refresh()

    def compiled_tape_begin(self):
        return self._compiled().tape_begin()

    def compiled_tape_end(self, tape):
        return self._compiled().tape_end(tape)

    def compiled_feedback(self, records, update: bool = True):
        """Replay one step's cost-tape records through the dispatcher
        (Eq. 2 EMA updates + bandwidth accounting) and return the
        refreshed offset snapshot."""
        return self._compiled().feedback(records, update=update)

    # ----------------------------------------------------------- dispatch --
    def supports(self, j: int, group: str) -> bool:
        return any(k[0] == j and k[1] == group for k in self.bank)

    def projector(self, j: int, rep: int, group: str, isa: str,
                  offsets=None, plain: bool = False) -> Optional[Callable]:
        """The ``proj(name, x, w)`` hook for one (period position, repeat,
        group): balanced layers where banked, plain matmul otherwise.
        Returns ``None`` when nothing at this position is banked.
        ``offsets`` (compiled mode) is the device offset snapshot the step
        was called with; ``plain`` (compiled mode) picks the kernels'
        plain torch version.  In eager mode each call dispatches the
        layer's per-core shards and casts the f32 result to x's dtype."""
        if not self.supports(j, group):
            return None
        if self.mode == "eager":
            if plain:
                raise ValueError("plain=True picks the compiled lowering's "
                                 "comparison path; eager shards take the "
                                 "plain version only for CPU tensors")

            def proj(name: str, x: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
                layers = self.bank.get((j, group, name))
                if layers is None:
                    return x @ w
                key = kernel_key(isa, _KIND[(group, name)])
                return layers[rep](x, isa=isa, key=key).to(x.dtype)

            return proj
        ctx = self._compiled()

        def proj(name: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
            layers = self.bank.get((j, group, name))
            if layers is None:
                return x @ w
            return ctx.apply(layers[rep], x, isa=isa,
                             kind=_KIND[(group, name)], offsets=offsets,
                             plain=plain)

        return proj

    def apply_head(self, x: torch.Tensor, *, isa: str, offsets=None,
                   plain: bool = False) -> torch.Tensor:
        """Balanced LM head with the per-phase ``kernel_key(isa, "head")``
        table key, run like every other projection of the trunk's mode."""
        if self.head is None:
            raise ValueError("trunk was built with include_head=False")
        if self.mode == "eager":
            if plain:
                raise ValueError("plain=True is a compiled-mode option")
            return self.head(x, isa=isa,
                             key=kernel_key(isa, "head")).to(x.dtype)
        return self._compiled().apply(self.head, x, isa=isa, kind="head",
                                      offsets=offsets, plain=plain)
