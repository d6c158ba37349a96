"""Training steps: microbatch gradient accumulation, even and uneven — the
reference's steps, run eagerly.

The *uneven* path is the paper's method at pod scale: each data-parallel
slice runs ``k_i`` local accumulation steps (k_i from
:class:`repro_torch.runtime.UnevenBatchPlanner`, proportional to measured
throughput).  Local accumulation contains **no collectives**, so unequal
trip counts cannot deadlock; a single weighted combine (sum_i w_i g_i,
w_i = k_i/sum k) equals the plain average over all microbatches.  Here the
pods' microbatches run in turn on one device.

Each microbatch's gradient is taken with ``torch.autograd.grad`` (in the
parameters' dtype, as ``jax.grad`` gives it) and added into an
``acc_dtype`` (float32) accumulator, divided by the number of microbatches
once at the end, as the reference's scan does; ``loss.backward()`` over
several microbatches would sum them in the parameters' dtype instead.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import loss_fn
from repro_torch.tree import leaves, tree_map, unflatten
from .optimizer import AdamWConfig, OptState, adamw_update

__all__ = ["microbatch_grads", "make_train_step", "local_accum",
           "weighted_combine", "uneven_data_parallel_step"]


def microbatch_grads(cfg: ModelConfig, params, batch: dict, *,
                     capacity: Optional[int] = None, remat: bool = False,
                     acc_dtype=torch.float32):
    """Average loss+grads over the leading microbatch axis of ``batch``
    (one microbatch's activations live at a time).  Returns (loss, grads,
    the last microbatch's metrics); loss and metrics are detached."""
    n_micro = leaves(batch)[0].shape[0]
    flat = leaves(params)
    g_acc = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
             for p in flat]
    l_acc = torch.zeros((), dtype=torch.float32, device=flat[0].device)
    metrics = {}
    for i in range(n_micro):
        mb = {k: v[i] for k, v in batch.items()}
        with torch.enable_grad():
            leaf_params = [p.detach().requires_grad_() for p in flat]
            loss, metrics = loss_fn(cfg, unflatten(params, leaf_params), mb,
                                    capacity=capacity, remat=remat)
            grads = torch.autograd.grad(loss, leaf_params, allow_unused=True)
        for acc, g in zip(g_acc, grads):
            if g is not None:
                acc.add_(g.to(acc_dtype))
        l_acc = l_acc + loss.detach()
        metrics = {k: v.detach() for k, v in metrics.items()}
    grads = unflatten(params, [acc.div_(n_micro) for acc in g_acc])
    return l_acc / n_micro, grads, metrics


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    capacity: Optional[int] = None,
                    remat: bool = False,
                    acc_dtype=torch.float32) -> Callable:
    """Train step: (params, opt_state, batch) -> (params, opt_state,
    metrics).  ``batch`` leaves have shape (n_micro, mb, ...)."""

    def step(params, opt_state: OptState, batch: dict):
        loss, grads, metrics = microbatch_grads(cfg, params, batch,
                                                capacity=capacity, remat=remat,
                                                acc_dtype=acc_dtype)
        params, opt_state, opt_metrics = adamw_update(
            opt_cfg, params, grads, opt_state)
        metrics = dict(metrics, **opt_metrics, loss=loss)
        return params, opt_state, metrics

    return step


# ------------------------------------------------------ uneven DP (paper) --
def local_accum(cfg: ModelConfig, params, microbatches: dict, *,
                capacity: Optional[int] = None):
    """One pod's local pass: average grads over its own k_i microbatches.
    Contains no cross-pod collectives (safe for unequal k_i)."""
    loss, grads, _ = microbatch_grads(cfg, params, microbatches,
                                      capacity=capacity)
    return loss, grads


def weighted_combine(grads_list: Sequence, counts: np.ndarray):
    """sum_i (k_i / sum k) * g_i — equals the global microbatch average.

    On hardware this is the single cross-pod all-reduce (optionally through
    :mod:`repro_torch.training.grad_compress` for the pod axis).
    """
    counts = np.asarray(counts, dtype=np.float64)
    w = counts / counts.sum()
    out = tree_map(lambda g: g * float(w[0]), grads_list[0])
    for wi, gi in zip(w[1:], grads_list[1:]):
        out = tree_map(lambda a, b: a + b * float(wi), out, gi)
    return out


def uneven_data_parallel_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    params,
    opt_state: OptState,
    pod_batches: Sequence[dict],
    counts: np.ndarray,
    *,
    local_fn: Optional[Callable] = None,
):
    """Reference driver for the paper's uneven-DP step (one step).

    ``pod_batches[i]`` has leading dim ``counts[i]`` (that pod's
    microbatches).  In deployment each pod runs ``local_fn`` concurrently;
    here they run sequentially (single process) — numerics are identical.
    Returns (params, opt_state, mean_loss).
    """
    local_fn = local_fn or (lambda p, b: local_accum(cfg, p, b))
    losses, grads_list = [], []
    for b in pod_batches:
        l, g = local_fn(params, b)
        losses.append(l)
        grads_list.append(g)
    grads = weighted_combine(grads_list, counts)
    params, opt_state, _ = adamw_update(opt_cfg, params, grads, opt_state)
    w = np.asarray(counts) / np.asarray(counts).sum()
    mean_loss = sum(float(l) * wi for l, wi in zip(losses, w))
    return params, opt_state, mean_loss
