"""Continuous batching with phase-aware replica routing: open-loop Poisson
traffic over two heterogeneous replicas.  The port of
``examples/continuous_serving.py``.

Replica 0 decodes 3x slower (co-tenant / older memory) but prefills at the
same speed — exactly the situation where a single blended ratio misroutes:
the dispatcher learns *separate* "prefill" and "decode" ratio entries and
shifts decode-heavy traffic to replica 1 while still using replica 0's
prefill capacity.

  python -m repro_torch.examples.continuous_serving [--device cuda|cpu]

Routing, ratios, TTFT and TPOT are on the virtual clock (each replica's
:class:`~repro_torch.serving.LinearPhaseCost`); the replicas' model runs
on ``--device`` (on the card each engine's decode step is one captured
CUDA graph), its weights from a seeded generator on the CPU.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from repro_torch.configs import reduced_config
from repro_torch.device import resolve_device
from repro_torch.examples import seeded_params
from repro_torch.serving import (
    DECODE,
    PREFILL,
    ContinuousBatchingEngine,
    InflightDispatcher,
    LatencyReport,
    LinearPhaseCost,
    poisson_requests,
)

__all__ = ["run", "main"]


def run(device, params: Optional[dict] = None) -> dict:
    """32 Poisson requests over the two replicas on ``device`` (``params``
    replaces the seeded weights).  Returns ``{"lines", "requests",
    "routed"}``: the lines to print, the finished requests (their
    ``generated`` tokens) and the count routed to each replica."""
    device = resolve_device(device)
    cfg = reduced_config("granite-8b")
    params = seeded_params(cfg, device, params)
    costs = [
        LinearPhaseCost(prefill_per_token=1e-3, decode_per_step=3e-3),  # slow
        LinearPhaseCost(prefill_per_token=1e-3, decode_per_step=1e-3),  # fast
    ]
    engines = [
        ContinuousBatchingEngine(cfg, params, max_slots=4, max_seq=48,
                                 prefill_chunk=8, cost_model=c,
                                 device=device)
        for c in costs
    ]
    disp = InflightDispatcher(engines)

    requests = poisson_requests(32, rate=60.0, vocab_size=cfg.vocab_size,
                                prompt_len=(6, 12), max_new_tokens=(4, 10),
                                seed=0)
    routed = np.zeros(2, dtype=np.int64)
    for r in requests:
        i, _ = disp.submit(r)
        routed[i] += 1
        disp.run_until_idle(max_steps=2)  # replicas keep decoding in-flight
    disp.run_until_idle()

    lines = [
        f"[continuous] routed: replica0={routed[0]} replica1={routed[1]}",
        f"[continuous] prefill ratios: "
        f"{np.round(disp.table.ratios(PREFILL), 2).tolist()} (same speed)",
        f"[continuous] decode  ratios: "
        f"{np.round(disp.table.ratios(DECODE), 2).tolist()} (3x gap)",
        *LatencyReport.from_requests(requests).lines("[continuous]"),
    ]
    # decode-bound traffic prefers the fast replica
    assert routed[1] > routed[0]
    return {"lines": lines, "requests": requests, "routed": routed}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Continuous batching over two "
                                             "heterogeneous replicas.")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, the plain PyTorch path")
    return ap


def main(argv: Optional[list] = None, *,
         params: Optional[dict] = None) -> dict:
    """Print the example's lines; returns :func:`run`'s result."""
    args = build_parser().parse_args(argv)
    out = run(args.device, params=params)
    for line in out["lines"]:
        print(line)
    return out


if __name__ == "__main__":
    main()
