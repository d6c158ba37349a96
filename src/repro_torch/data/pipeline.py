"""Synthetic tokenized data pipeline with per-host sharding and prefetch.

Production shape: each host builds the *same* deterministic stream and takes
its own slice of the global batch (``host_id``/``n_hosts``), so no data
service is needed for the dry-run scale; a real corpus would replace
``SyntheticLM`` behind the same iterator contract.

``SyntheticLM`` emits sequences with a learnable 2-gram structure
(``x_{t+1} = (a * x_t + c) mod V`` on a per-sequence (a, c)), so example
drivers show real loss decrease rather than noise-floor churn.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    microbatch: int
    host_id: int = 0
    n_hosts: int = 1
    seed: int = 0
    structured: bool = True  # learnable 2-gram stream vs uniform noise


class SyntheticLM:
    """Deterministic, restartable synthetic LM stream."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.cfg = cfg
        self.host_batch = cfg.global_batch // cfg.n_hosts
        if self.host_batch % cfg.microbatch:
            raise ValueError("host batch must be a multiple of microbatch")
        self.step = 0

    def seek(self, step: int) -> None:
        """Restart-from-checkpoint support: position the stream."""
        self.step = step

    def _gen(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_id])
        )
        b, s, v = self.host_batch, cfg.seq_len, cfg.vocab_size
        if cfg.structured:
            # stream-global (a, c): a deterministic 2-gram the model can learn
            g = np.random.default_rng(cfg.seed)
            a = int(g.integers(2, 8))
            c = int(g.integers(1, v))
            x0 = rng.integers(0, v, size=(b, 1))
            toks = np.empty((b, s), dtype=np.int32)
            toks[:, :1] = x0
            for t in range(1, s):
                toks[:, t: t + 1] = (a * toks[:, t - 1: t] + c) % v
        else:
            toks = rng.integers(0, v, size=(b, s), dtype=np.int32)
        labels = np.concatenate(
            [toks[:, 1:], np.full((b, 1), -100, np.int32)], axis=1
        )
        n_micro = b // cfg.microbatch
        return {
            "tokens": toks.reshape(n_micro, cfg.microbatch, s),
            "labels": labels.reshape(n_micro, cfg.microbatch, s),
        }

    def __iter__(self) -> Iterator[dict]:
        while True:
            out = self._gen(self.step)
            self.step += 1
            yield out


class Prefetcher:
    """Background-thread prefetch (depth-bounded) around any iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        for item in self._it:
            if self._stop:
                return
            self._q.put(item)

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop = True
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
