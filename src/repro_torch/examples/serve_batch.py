"""Batched serving with heterogeneous replicas: the paper's Eq. 3 routes
requests proportionally to measured replica throughput.  The port of
``examples/serve_batch.py``.

This is the seed-era *whole-batch* API; ``serve_batch`` executes through
the continuous-batching engine under the hood.  For request-level serving
(no batch barrier, per-phase ratios) see
:mod:`repro_torch.examples.continuous_serving`.

  python -m repro_torch.examples.serve_batch [--device cuda|cpu]

The split and the ratios are on the virtual clock (each replica's time is
injected from its simulated speed); the two replicas' model runs on
``--device``, its weights from a seeded generator on the CPU.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from repro_torch.configs import reduced_config
from repro_torch.device import resolve_device
from repro_torch.examples import seeded_params
from repro_torch.serving import RoutedServer, ServeEngine

__all__ = ["run", "main"]


def run(device, params: Optional[dict] = None) -> dict:
    """Five routed rounds over two replicas on ``device`` (``params``
    replaces the seeded weights).  Returns ``{"lines", "tokens"}``: the
    lines to print and the last round's (8, 12) tokens."""
    device = resolve_device(device)
    cfg = reduced_config("granite-8b")
    params = seeded_params(cfg, device, params)
    engines = [ServeEngine(cfg, params, batch_size=8, max_seq=48,
                           device=device)
               for _ in range(2)]
    srv = RoutedServer(engines)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, size=(8, 8), dtype=np.int32)

    # Replica 1 simulated 3x slower (co-tenant / old hardware): watch the
    # router shift the batch split from 4:4 toward ~6:2.
    speeds = np.array([3.0, 1.0])
    lines = []
    for round_ in range(5):
        planned = srv.router.split(len(prompts))
        out, counts, _ = srv.serve_batch(
            prompts, n_steps=4,
            times_override=np.maximum(planned, 1e-3) / speeds)
        ratios = srv.runtime.ratios("serve_step").round(2).tolist()
        lines.append(f"[serve] round {round_}: split={counts.tolist()} "
                     f"ratios={ratios}")
    assert out.shape[0] == len(prompts)
    lines.append(f"[serve] done; generated shape: {out.shape}")
    return {"lines": lines, "tokens": out}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Whole-batch routing over two "
                                             "replicas.")
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
