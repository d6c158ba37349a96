"""Q4_0 weight-only inference through the CUDA Q4 kernel — the paper's
compute path (fused dequant-matmul), validated against the float model,
with the kernel tuner picking a launch variant online.  The port of
``examples/q4_inference.py``.

  python -m repro_torch.examples.q4_inference [--device cuda|cpu]

Two lines differ from the reference's by design:

* the kernel line compares the product of
  :func:`repro_torch.kernels.ops.q4_matmul` — on the card the CUDA kernel
  ``q4_matmul``, on the CPU its plain version — with the oracle
  :func:`repro_torch.kernels.ref.q4_matmul_ref`, and names which of the
  two ran (``cuda`` or ``plain``) where the reference names its Pallas
  kernel;
* the tuner line names a launch variant (``('direct',)``, the entry
  ``q4_matmul``, or ``('ring',)``, ``q4_matmul_db``), not the reference's
  MXU block tuple: the CUDA kernels read no block shape.

Period-stacked weights are quantized slice by slice where the reference
maps ``quantize_q4_0`` over the stack.
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from repro_torch.configs import reduced_config
from repro_torch.core import KernelTuner, shape_class
from repro_torch.device import resolve_device
from repro_torch.examples import seeded_params
from repro_torch.kernels import ref
from repro_torch.kernels.ops import TunedMatmul, q4_matmul
from repro_torch.models import forward
from repro_torch.quant import (BYTES_PER_ELEM, QuantizedLinear,
                               dequantize_q4_0, quantize_q4_0)
from repro_torch.tree import tree_map

__all__ = ["quantize_params", "dequantize_params", "run", "main"]

TUNER_CALLS = 4


def quantize_params(params):
    """Quantize every >=2D matmul weight of the trunk to Q4_0 (stored as
    (out, in) for ``y = x @ W``); returns (tree, number quantized)."""
    count = [0]

    def q(leaf):
        if leaf.dim() == 2 and min(leaf.shape) >= 32 \
                and leaf.shape[0] % 32 == 0:
            count[0] += 1
            return quantize_q4_0(leaf.T)
        if leaf.dim() == 3 and min(leaf.shape[1:]) >= 32 \
                and leaf.shape[1] % 32 == 0:
            count[0] += 1  # period-stacked (P, in, out)
            per = [quantize_q4_0(w.T) for w in leaf]
            return QuantizedLinear(
                packed=torch.stack([p.packed for p in per]),
                scales=torch.stack([p.scales for p in per]))
        return leaf

    return tree_map(q, params), count[0]


def dequantize_params(cfg, qparams):
    """The float tree of ``qparams``: every Q4_0 leaf back to (in, out) in
    the model's dtype, a stacked one slice by slice."""
    def dq(leaf):
        if not isinstance(leaf, QuantizedLinear):
            return leaf
        if leaf.packed.dim() == 3:  # period-stacked
            return torch.stack([
                dequantize_q4_0(QuantizedLinear(p, s))
                for p, s in zip(leaf.packed, leaf.scales)
            ]).transpose(1, 2).to(cfg.cdtype)
        return dequantize_q4_0(leaf).T.to(cfg.cdtype)

    return tree_map(dq, qparams,
                    is_leaf=lambda l: isinstance(l, QuantizedLinear))


def run(device, params: Optional[dict] = None,
        x: Optional[torch.Tensor] = None,
        tokens: Optional[torch.Tensor] = None) -> dict:
    """The example's three sections on ``device``.  ``params``, ``x`` (8, d)
    and ``tokens`` (2, 16) replace the seeded weights and inputs (the
    reference's, carried across, in the tests).  Returns every line and
    number it prints."""
    device = resolve_device(device)
    cfg = reduced_config("granite-8b")
    params = seeded_params(cfg, device, params)
    if x is None:
        x = torch.randn((8, cfg.d_model), dtype=torch.float32,
                        generator=torch.Generator().manual_seed(1))
    if tokens is None:
        tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                               generator=torch.Generator().manual_seed(2))
    x, tokens = x.to(device), tokens.to(device)
    out = {"lines": []}
    qparams, out["n_quantized"] = quantize_params(params)
    out["lines"].append(f"[q4] quantized {out['n_quantized']} weight "
                        f"matrices to Q4_0 ({BYTES_PER_ELEM} bytes/element "
                        f"vs 4)")

    # 1) kernel-level: the fused Q4 matmul against the oracle and the
    #    float matmul
    w = params["period"][0]["mixer"]["wq"][0]          # (d, H*hd)
    qw = quantize_q4_0(w.T)
    route = "cuda" if x.is_cuda else "plain"
    y_kernel = q4_matmul(x, qw)
    y_ref = ref.q4_matmul_ref(x, qw)
    y_float = x @ w
    out.update(y_kernel=y_kernel, route=route, qw=qw, x=x,
               kernel_err=float((y_kernel - y_ref).abs().max()),
               quant_rel=float((y_kernel - y_float).abs().max()
                               / y_float.abs().max()))
    out["lines"].append(f"[q4] {route}-vs-oracle max err "
                        f"{out['kernel_err']:.2e}; quantization rel err "
                        f"{out['quant_rel']:.3f}")

    # 2) model-level: dequantized-weights forward against the float
    #    forward (random-init logits are near-tied)
    deq = dequantize_params(cfg, qparams)
    lg_f = forward(cfg, params, tokens).logits
    lg_q = forward(cfg, deq, tokens).logits
    out["agree"] = float((lg_f.argmax(-1) == lg_q.argmax(-1)).float().mean())
    out["logits_rel"] = float(torch.linalg.norm(lg_f - lg_q)
                              / torch.linalg.norm(lg_f))
    out["lines"].append(
        f"[q4] greedy-token agreement float-vs-Q4: {out['agree']:.1%} "
        f"(logits rel err {out['logits_rel']:.3f}; random-init logits are "
        f"near-tied, trained models agree far more)")

    # 3) online variant tuning (the per-ISA table analogue)
    tm = TunedMatmul(KernelTuner(alpha=0.3, min_trials=1))
    for _ in range(TUNER_CALLS):
        tm.q4(x, qw)
    shape = shape_class(8, qw.out_features, x.shape[1])
    out["variant"] = tm.tuner.best(("q4_matmul", shape))
    out["lines"].append(f"[q4] tuner selected variant {out['variant']} for "
                        f"shape {shape}")
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Q4_0 inference through the "
                                             "Q4 kernel.")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, the plain PyTorch path")
    return ap


def main(argv: Optional[list] = None, *, params: Optional[dict] = None,
         x: Optional[torch.Tensor] = None,
         tokens: Optional[torch.Tensor] = None) -> dict:
    """Print the example's lines; returns :func:`run`'s result."""
    args = build_parser().parse_args(argv)
    out = run(args.device, params=params, x=x, tokens=tokens)
    for line in out["lines"]:
        print(line)
    return out


if __name__ == "__main__":
    main()
