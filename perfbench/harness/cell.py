"""One run of one cell: set-up, the measured window, the check.

Set-up: the weights from the seed on the device, the program built as its
serve entry builds it, every shape of the cell's traffic warmed up once
(every prefill chunk length, the decode step's capture), and the
traffic's own set-up (a closed loop's first requests fill the slots).
The window then measures for ``seconds``; an open loop's requests due in
it are followed to their end.  With ``trace`` the engine's parts are
timed and a profiler slice of the window's middle is read; the
per-layer metrics come from that run, the end-to-end ones from a run
without it.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Callable, Optional

import torch

from perfbench.harness import correct, endtoend, spec, system, trace, work
from perfbench.harness.driver import Driver
from perfbench.harness.probe import Probe
from perfbench.harness.traffic import load_kind
from perfbench.harness.view import View, kernel_names

# top-level module names that no process of the benchmark may hold: JAX
# and the JAX package the port was made from (names compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PROFILE_SLICE_S = 3.0


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: the
    modules this process holds)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _load_reader(path):
    import importlib.util

    mod_spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


class Profiler:
    """The profiler slice: the window's last ``length`` seconds, each
    iteration inside marked by the probe.  It stops once the window has
    closed: stopping flushes the trace for seconds, which inside the window
    would stall the traffic."""

    def __init__(self, probe: Probe, seconds: float, cuda: bool):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        self.make = lambda: profile(activities=acts)
        self.probe = probe
        self.length = min(PROFILE_SLICE_S, seconds / 3.0)
        self.lead = seconds - self.length
        self.prof = None
        self.first = self.last = None

    def warm_up(self) -> None:
        """The profiler's first start initialises its tracer: in set-up."""
        with self.make():
            torch.zeros(1).add_(1)

    def on_iter(self, d: Driver) -> None:
        if self.prof is None and d.clock() >= d.origin + self.lead:
            self.prof = self.make()
            self.prof.start()
            self.probe.profiling = True
            self.first = len(d.iters)

    def stop(self, d: Driver) -> None:
        if self.prof is not None and self.last is None:
            self.probe.profiling = False
            self.prof.stop()
            self.last = len(d.iters)

    def reduce(self, d: Driver):
        if self.prof is None:
            return None, []
        self.stop(d)
        return trace.reduce(self.prof), d.iters[self.first:self.last]


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
        t0: float, control: bool = False, log: Callable = print,
        tamper: Optional[Callable] = None, clock=None) -> dict:
    """One run; returns the result line's object.  ``tamper(system)`` runs
    on the built system before its warm-up (the tests break the timed path
    with it); ``clock`` replaces the driver's wall clock (the tests step a
    fixed window)."""
    from repro_torch.kernels import q4_matmul as q4mod
    from repro_torch.kernels import int8_gemm as i8mod

    cuda = device.type == "cuda"
    traffic = cell.traffic
    marks = [("start", time.perf_counter())]

    def mark(name):
        if cuda:
            torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    cfg = system.port_config(cell.config)
    torch.zeros(1, device=device)
    mark("device")
    params = system.weights_for(cfg, seed, device)
    mark("weights")
    sut = system.build(cell, cfg, params, device, seed)
    mark("build")
    if tamper is not None:
        tamper(sut)
    system.warm_up(sut, int(traffic["prefill_chunk"]),
                   int(traffic["prefill_lanes"]), seed)
    mark("warm-up")
    gen = load_kind(traffic["kind"])(traffic, seed, cfg.vocab_size, seconds)
    probe = Probe(sut.engine) if traced else None
    prof = Profiler(probe, seconds, cuda) if traced else None
    if prof is not None:
        prof.warm_up()
    d = Driver(sut, gen, probe) if clock is None else \
        Driver(sut, gen, probe, clock=clock, sleep=lambda s: None)
    d.fill()
    mark("fill")
    setup_s = time.perf_counter() - t0
    log(f"[perfbench] set-up {setup_s:.3f} s: before the cell "
        f"{marks[0][1] - t0:.3f} s, "
        + ", ".join(f"{b[0]} {b[1] - a[1]:.3f} s"
                    for a, b in zip(marks, marks[1:])))
    d.window(seconds, on_iter=prof.on_iter if prof is not None else None)
    if prof is not None:
        prof.stop(d)
    d.follow_through()
    if cuda:
        torch.cuda.synchronize()
    leaked = forbidden_modules()
    if leaked:
        raise RuntimeError(f"modules of JAX or the JAX package loaded: "
                           f"{leaked}")
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    window = d.window_iters()
    model = work.Model.from_config(cell.config["model"])
    out_metrics, device_info, breakdown = {}, {}, None
    units = spec.units(cell)
    if not traced:
        vals = endtoend.compute([m["name"] for m in cell.end_to_end],
                                d.requests, d.origin, d.close, setup_s)
    else:
        probe.resolve(d.iters)
        sl, traced_iters = prof.reduce(d)
        view = View(cell=cell, model=model, slots=int(traffic["slots"]),
                    seconds=seconds, origin=d.origin, close=d.close,
                    iters=window, requests=d.requests, trace=sl,
                    traced_iters=traced_iters,
                    q4_kernels=kernel_names([q4mod.SOURCE]),
                    port_kernels=kernel_names([q4mod.SOURCE, i8mod.SOURCE]))
        vals = {}
        for m in cell.per_layer:
            v = _load_reader(spec.metric_reader_path(cell, m["name"]))(view)
            if v is not None:
                vals[m["name"]] = v
        if sl is not None and sl.window_s > 0:
            device_info = {"busy_s": sl.busy_s, "window_s": sl.window_s}
            breakdown = {"device_ops": sl.device_ops(10),
                         "idle_gaps": sl.idle_gaps(10)}
        probe.remove()
    for name, v in vals.items():
        out_metrics[name] = {"value": float(v), "unit": units[name]}

    late = d.late
    log(f"[perfbench] window: "
        f"{endtoend.summary(d.requests, d.origin, d.close)}")
    log(f"[perfbench] {cell.name}: {len(d.requests)} requests sent, "
        f"{len(window)} iterations in the window, setup {setup_s:.3f} s"
        + (f"; generator late by mean {1e3 * sum(late) / len(late):.3f} ms, "
           f"max {1e3 * max(late):.3f} ms over {len(late)} arrivals"
           if late else ""))
    attempted = [r for r in d.requests if r.due is not None
                 and 0.0 <= r.due < seconds] if gen.open_loop else \
        [r for r in d.requests if any(d.origin < t <= d.close
                                      for t, _ in r.stamps)]
    failed = [r for r in attempted if r.request.n_generated == 0
              or (gen.open_loop and r.done is None)]

    # the check, with the program's state freed
    chk = cell.check
    picked = correct.sample(d.requests, seed, int(chk["requests"]))
    del d, sut, gen, probe, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    from perfbench.reference.decoder import Spec

    readings = correct.check(Spec.from_config(cell.config), params, picked,
                             device, control=control)
    log(f"[perfbench] check: {readings['requests']} requests, "
        f"{readings['tokens']} served tokens through the reference in "
        f"{time.perf_counter() - t_check:.1f} s")
    limit, number = float(chk["limit"]), chk["number"]
    ok = (readings[number] <= limit and not failed
          and readings["tokens"] > 0)
    res = {"correct": bool(ok), "attempted": len(attempted),
           "failed": len(failed), "metrics": out_metrics,
           "device": {"platform": "gpu" if cuda else device.type,
                      "kind": (torch.cuda.get_device_name(device) if cuda
                               else "cpu"),
                      "count": 1, "memory_peak_bytes": peak, **device_info}}
    if breakdown is not None:
        res["breakdown"] = breakdown
    checks = {number: {"value": readings[number], "limit": limit},
              "served_tokens_checked": {"value": readings["tokens"],
                                        "limit": "> 0"},
              "failed_requests": {"value": len(failed), "limit": 0}}
    res["readings"] = readings
    res["checks"] = checks
    return res
