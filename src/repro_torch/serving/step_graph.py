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
  (:data:`repro_torch.kernels.COUNTED` and ``decode_attention``), and a
  replay runs no Python: each replay credits every wrapper with the
  launches its capture recorded (and a Q4 wrapper with its tensor-core
  launches, ``tc_launches``), while the capture itself, which launches
  nothing, counts none.

* **Wall spans.**  With a tracer in :data:`repro_torch.core.events.WALL`,
  a call records ``decode.inputs`` (the input copies) and
  ``decode.launch`` (the replay, with its device time by CUDA events,
  resolved when the spans are read), or ``decode.capture`` on the first.

A capture or a replay that fails raises; nothing falls back to the eager
step.  A step that syncs with the host (``.item()``, ``.cpu()``, a copy
from pageable memory) cannot be captured: the capture raises.
"""

from __future__ import annotations

import gc
from typing import Callable, Sequence

import torch

from repro_torch.core import events as _ev
from repro_torch.kernels import COUNTED
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.q4_matmul import q4_matmul, q4_matmul_db

__all__ = ["CAPTURE", "INPUTS", "LAUNCH", "StepGraph", "timed_launch"]

Q4 = (q4_matmul, q4_matmul_db)   # the wrappers that count tensor-core launches

# the decode step's wall spans (the engine's uncaptured step records the
# first two too)
INPUTS, LAUNCH, CAPTURE = "decode.inputs", "decode.launch", "decode.capture"


def _elapsed_ms(e0, e1) -> float:
    e1.synchronize()
    return e0.elapsed_time(e1)


def timed_launch(tracer, name: str, device, run: Callable):
    """``run()`` inside wall span ``name`` of ``tracer``; on a CUDA device
    the span's ``device_ms`` is the device time between two events
    recorded around it, read when the tracer's spans are read."""
    if device.type != "cuda":
        sp = tracer.begin(name)
        out = run()
        tracer.end(sp)
        return out
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    sp = tracer.begin(name)
    e0.record()
    out = run()
    e1.record()
    tracer.end(sp, device_ms=lambda: _elapsed_ms(e0, e1))
    return out


class StepGraph:
    """``body(*inputs)`` captured once as a CUDA graph and replayed.

    ``inputs`` are the graph's static input tensors, all on one CUDA
    device.  ``launches`` holds, per wrapper of
    :data:`~repro_torch.kernels.COUNTED`, the launches one replay makes,
    ``tc_launches``, per wrapper of :data:`Q4`, those on the Q4
    tensor-core body,
    ``attn_launches`` those of ``decode_attention``; ``replays`` counts the
    replays.
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
        self.tc_launches = (0,) * len(Q4)
        self.attn_launches = 0
        self.replays = 0

    def __call__(self, *values):
        """Write ``values`` into the static inputs and run the step: the
        warm-up and the capture on the first call, a replay after."""
        if len(values) != len(self.inputs):
            raise ValueError(f"expected {len(self.inputs)} inputs, got "
                             f"{len(values)}")
        w = _ev.WALL
        sp = w and w.begin(INPUTS)
        for static, value in zip(self.inputs, values):
            static.copy_(torch.as_tensor(value))
        if sp:
            w.end(sp)
        if self.graph is None:
            sp = w and w.begin(CAPTURE)
            out = self._warm_up_and_capture()
            if sp:
                w.end(sp)
            return out
        if w is None:
            self.graph.replay()
        else:
            timed_launch(w, LAUNCH, self.inputs[0].device,
                         self.graph.replay)
        for wrapper, n in zip(COUNTED, self.launches):
            wrapper.launches += n
        for wrapper, n in zip(Q4, self.tc_launches):
            wrapper.tc_launches += n
        decode_attention.launches += self.attn_launches
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
        tc_before = [w.tc_launches for w in Q4]
        attn_before = decode_attention.launches
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
            tc = tuple(w.tc_launches - b for w, b in zip(Q4, tc_before))
            for w, b in zip(COUNTED, before):
                w.launches = b          # capturing launches nothing
            for w, b in zip(Q4, tc_before):
                w.tc_launches = b
            self.attn_launches = decode_attention.launches - attn_before
            decode_attention.launches = attn_before
        self.graph, self.outputs, self.launches = graph, outputs, recorded
        self.tc_launches = tc
        return out
