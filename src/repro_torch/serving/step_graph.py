"""The compiled decode step captured as one CUDA graph: the port's
counterpart of the reference's ``jax.jit`` of the engine's ``_decode``.

:class:`StepGraph` captures a step function once and replays it:

* **Inputs** are static tensors on the card.  Each call writes the step's
  values into them with ``copy_`` (the decode batch's last tokens and
  positions) before it runs.
* **The first call** runs the step uncaptured on a side stream (the
  warm-up; its result is the result of that call), then captures the same
  step with ``torch.cuda.graph``.  Every lazy first-launch action of the
  kernels (building and loading a library, raising a kernel's shared
  memory limit) therefore happens in the warm-up, never inside the capture.
* **Every later call** replays the graph and returns the outputs the
  capture produced, rewritten by the replay: the same tensors, at the same
  addresses, every step.  Whatever the step reads from other tensors (the
  slot caches and cache indices, the offset snapshot) it reads at replay
  time, so their owners write them in place and never rebind them.
* **Launch counts.**  The kernel wrappers count launches in Python
  (:data:`repro_torch.kernels.COUNTED`), and a replay runs no Python: each
  replay credits every wrapper with the launches its capture recorded,
  while the capture itself, which launches nothing, counts none.

A capture or a replay that fails raises; nothing falls back to the eager
step.  A step that syncs with the host (``.item()``, ``.cpu()``, a copy
from pageable memory) cannot be captured: the capture raises.
"""

from __future__ import annotations

import gc
from typing import Callable, Sequence

import torch

from repro_torch.kernels import COUNTED

__all__ = ["StepGraph"]


class StepGraph:
    """``body(*inputs)`` captured once as a CUDA graph and replayed.

    ``inputs`` are the graph's static input tensors, all on one CUDA
    device.  ``launches`` holds, per wrapper of
    :data:`~repro_torch.kernels.COUNTED`, the launches one replay makes;
    ``replays`` counts the replays.
    """

    def __init__(self, body: Callable, inputs: Sequence[torch.Tensor]):
        if not inputs or any(t.device.type != "cuda" for t in inputs):
            raise ValueError("a CUDA graph takes static inputs on a CUDA "
                             "device")
        self.body = body
        self.inputs = tuple(inputs)
        self.graph = None
        self.outputs = None
        self.launches = (0,) * len(COUNTED)
        self.replays = 0

    def __call__(self, *values):
        """Write ``values`` into the static inputs and run the step: the
        warm-up and the capture on the first call, a replay after."""
        if len(values) != len(self.inputs):
            raise ValueError(f"expected {len(self.inputs)} inputs, got "
                             f"{len(values)}")
        for static, value in zip(self.inputs, values):
            static.copy_(torch.as_tensor(value))
        if self.graph is None:
            return self._warm_up_and_capture()
        self.graph.replay()
        for wrapper, n in zip(COUNTED, self.launches):
            wrapper.launches += n
        self.replays += 1
        return self.outputs

    def _warm_up_and_capture(self):
        dev = self.inputs[0].device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self.body(*self.inputs)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = [w.launches for w in COUNTED]
        # No garbage collection while capturing: an unreachable engine's
        # graph freed mid-capture releases its memory pool, a call the
        # capture does not allow, and the capture fails.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                outputs = self.body(*self.inputs)
        finally:
            if collecting:
                gc.enable()
            recorded = tuple(w.launches - b for w, b in zip(COUNTED, before))
            for w, b in zip(COUNTED, before):
                w.launches = b          # capturing launches nothing
        self.graph, self.outputs, self.launches = graph, outputs, recorded
        return out
