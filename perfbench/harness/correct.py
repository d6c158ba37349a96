"""The comparison that decides ``correct``.

Once the window has closed, the peak memory has been read and the program's
state is freed: a sample, drawn from the seed, of ``requests`` requests the
program finished (the one with the most served tokens in it; a run that
finished too few adds requests still running, with the tokens they were
served) goes through the plain reference once, prompt and served tokens
together.  Several requests, so that a fault in some rows of the decode
batch shows.  The number compared is ``logit_gap``: the widest gap by
which a served token's reference logit lies below the reference's best at
its position.  The program decodes greedily, so a sound program serves the
best token or one within rounding of it.

The control reads, at the same positions of the same sequences, the gap
of the token that the reference in float8 puts first (``perfbench/
calibrate.py`` and the card's test of the control; the benchmark's own
runs do not run it).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from perfbench.harness.traffic import Req


def sample(reqs: Sequence[Req], seed: int, n: int) -> List[Req]:
    """``n`` requests that were served tokens: the finished ones first (the
    one with the most served tokens, then the others in a seeded order),
    then, where too few finished, the running ones in the same way."""
    rng = np.random.default_rng(seed)
    served = [r for r in reqs if r.request is not None
              and r.request.n_generated > 0]
    order: List[Req] = []
    for group in ([r for r in served if r.done is not None],
                  [r for r in served if r.done is None]):
        if not group:
            continue
        longest = max(group, key=lambda r: r.request.n_generated)
        rest = [r for r in group if r is not longest]
        order += [longest] + [rest[i] for i in rng.permutation(len(rest))]
    return order[:n]


def sequences(picked: Sequence[Req], device) -> tuple:
    seqs, firsts, served = [], [], []
    for r in picked:
        toks = r.request.tokens
        seqs.append(torch.as_tensor(toks, device=device))
        firsts.append(r.request.prompt_len)
        served.append(torch.as_tensor(np.asarray(r.request.generated),
                                      device=device).long())
    return seqs, firsts, served


def gaps(ref: Sequence[torch.Tensor],
         chosen: Sequence[torch.Tensor]) -> torch.Tensor:
    """best − logit of the chosen token, at every position."""
    return torch.cat([lg.max(-1).values - lg.gather(-1, tok[:, None])[:, 0]
                      for lg, tok in zip(ref, chosen)])


def summary(g: torch.Tensor, prefix: str) -> dict:
    """The widest gap, and two readings beside it: the mean gap and the
    share of positions whose token is not the reference's best."""
    return {f"{prefix}_gap": float(g.max()),
            f"{prefix}_gap_mean": float(g.mean()),
            f"{prefix}_mismatch": float((g > 0).float().mean())}


def check(spec, params: dict, picked: Sequence[Req], device,
          control: bool = False) -> dict:
    """The readings of the comparison: ``logit_gap`` of the served tokens
    and, with ``control``, ``control_gap`` of the float8 reference's."""
    from perfbench.reference.decoder import Decoder

    seqs, firsts, served = sequences(picked, device)
    out = {"requests": len(picked),
           "tokens": int(sum(len(s) for s in served))}
    low: Optional[list] = None
    if control:
        low = [lg.argmax(-1) for lg in
               Decoder(spec, params, "fp8").logits(seqs, firsts)]
    ref = Decoder(spec, params, "f32").logits(seqs, firsts)
    out.update(summary(gaps(ref, served), "logit"))
    if low is not None:
        out.update(summary(gaps(ref, low), "control"))
    return out
