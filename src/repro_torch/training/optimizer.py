"""AdamW + schedules, built from scratch (no ``torch.optim``): the
reference's optimizer, operation for operation.

Master weights and moments are float32 regardless of param dtype (bf16
params are cast on apply) — standard mixed-precision discipline.  Every
step of the arithmetic is the reference's, in its order and in float32:
the schedule and the bias corrections ``b ** step`` are float32 tensor
operations on the step counter's device (Python doubles would give other
bits), a Python float enters an operation as a float32 scalar, as a
weakly typed scalar does in JAX, and the divisors of ``lr_at`` are float32
tensors, so that no division by a Python number becomes a multiplication
by its reciprocal on the card.  The functions are pure, as the
reference's: they return new trees and leave their arguments as they are.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from repro_torch.tree import leaves, tree_map

__all__ = ["AdamWConfig", "OptState", "lr_at", "init_opt_state",
           "global_norm", "adamw_update"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    # Memory regime for >=100B models: factored second moment
    # (Adafactor-style row/col stats for ndim>=2 tensors) + bf16 first
    # moment.
    factored: bool = False


class OptState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: dict
    nu: dict


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac."""
    step = step.to(torch.float32)
    warm = cfg.lr * step / _f32(max(cfg.warmup_steps, 1), step)
    prog = torch.clamp(
        (step - cfg.warmup_steps)
        / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), step),
        0.0, 1.0,
    )
    cos = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 *
                    (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _factorable(p: torch.Tensor) -> bool:
    return p.dim() >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1


def init_opt_state(params, cfg: Optional[AdamWConfig] = None) -> OptState:
    """Zero moments on each parameter's device: mu float32 (bf16 when
    factored), nu float32, or its row/col statistics when factored."""
    factored = bool(cfg and cfg.factored)

    def mu_init(p):
        return torch.zeros(p.shape, device=p.device, dtype=torch.bfloat16
                           if factored else torch.float32)

    def nu_init(p):
        if factored and _factorable(p):
            # row/col second-moment statistics (Adafactor)
            return {
                "row": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                   device=p.device),
                "col": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                   dtype=torch.float32, device=p.device),
            }
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu=tree_map(mu_init, params),
                    nu=tree_map(nu_init, params))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the float32 sums of squares, added leaf by leaf in the
    reference's order (from Python's 0, as its ``sum``)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in leaves(grads)))


def adamw_update(
    cfg: AdamWConfig, params, grads, state: OptState
) -> tuple[dict, OptState, dict]:
    """One AdamW step; returns (new_params, new_state, metrics)."""
    gnorm = global_norm(grads)
    # a true division (``float / tensor`` would multiply by a reciprocal)
    scale = torch.clamp(torch.div(_f32(cfg.grad_clip, gnorm), gnorm + 1e-9),
                        max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, mu, nu):
        g = g.to(torch.float32) * scale
        mu2 = (cfg.b1 * mu.to(torch.float32) + (1 - cfg.b1) * g).to(mu.dtype)
        if isinstance(nu, dict):  # factored second moment
            g2 = g * g + 1e-30
            row = cfg.b2 * nu["row"] + (1 - cfg.b2) * g2.mean(-1)
            col = cfg.b2 * nu["col"] + (1 - cfg.b2) * g2.mean(-2)
            nu2 = {"row": row, "col": col}
            vhat = (row[..., None] * col[..., None, :]
                    / torch.clamp(row.mean(-1)[..., None, None], min=1e-30)
                    ) / b2c
        else:
            nu2 = cfg.b2 * nu + (1 - cfg.b2) * g * g
            vhat = nu2 / b2c
        mhat = mu2.to(torch.float32) / b1c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.dim() >= 2:  # decay matrices only (norms/biases exempt)
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), mu2, nu2

    # each parameter's (new_p, mu2, nu2), split into three trees by
    # walking the parameters' structure down to those triples
    out = tree_map(upd, params, grads, state.mu, state.nu)
    new_p, new_mu, new_nu = (tree_map(lambda _, o, i=i: o[i], params, out)
                             for i in range(3))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, OptState(step=step, mu=new_mu, nu=new_nu), metrics
