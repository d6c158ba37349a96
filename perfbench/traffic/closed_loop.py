"""Closed loop: ``clients`` callers, each sending its next request the
moment its last one finishes (no think time).

Parameters: ``clients``; ``prompt`` and ``output`` length distributions;
``first_output``, the distribution of each client's first request (the
residual life of a request in steady state, so completions spread from
the start); ``sequence_seed``; the engine's ``slots``, ``prefill_chunk``
and ``prefill_lanes``.  The first requests, sent during set-up to fill the
slots, are one block of ``clients`` (prompt, first output) pairs at
stratified quantiles; the later ones come from a cycle of ``blocks``
such blocks of (prompt, output).  Both are in one order drawn from
``sequence_seed``; a run rotates the first block among the clients and
starts the cycle where its seed says.
"""

from __future__ import annotations

from typing import List

import numpy as np

from perfbench.harness.traffic import Req, lengths, prompt_ids, rotation


class Traffic:
    open_loop = False

    def __init__(self, params: dict, seed: int, vocab_size: int,
                 seconds: float):
        n = int(params["clients"])
        seq = np.random.default_rng(int(params["sequence_seed"]))
        first = np.stack([lengths(params["prompt"], n, seq),
                          lengths(params["first_output"], n, seq)], axis=1)
        later = np.concatenate([
            np.stack([lengths(params["prompt"], n, seq),
                      lengths(params["output"], n, seq)], axis=1)
            for _ in range(int(params["blocks"]))])
        self.first = np.roll(first, -rotation(seed, n), axis=0)
        self.later = later
        self.cursor = rotation(seed + 1, len(later))
        self.clients = n
        self.vocab = vocab_size
        self.ids = np.random.default_rng(seed)

    def _make(self, client: int, due, sizes) -> Req:
        s0, out = (int(x) for x in sizes)
        return Req(prompt=prompt_ids(self.ids, s0, self.vocab), max_new=out,
                   due=due, client=client)

    def initial(self) -> List[Req]:
        """Every client's first request, sent during set-up."""
        return [self._make(c, None, self.first[c])
                for c in range(self.clients)]

    def due(self, t: float) -> List[Req]:
        return []

    def next_due(self):
        return None

    def finished(self, req: Req, t) -> List[Req]:
        """The client of ``req`` sends its next request now."""
        sizes = self.later[self.cursor % len(self.later)]
        self.cursor += 1
        return [self._make(req.client, t, sizes)]
