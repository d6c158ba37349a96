"""Serving engines: request-level continuous batching over the balanced
trunk, plus the legacy static-batch engine.

``ContinuousBatchingEngine`` is the serving core: a persistent decode
batch of ``max_slots`` rows (slot-based KV and recurrent state, per-row
cache indices), an iteration-level scheduler that interleaves (optionally
chunked and multi-lane) prefill with running decode steps, and request
admission/eviction with no full-batch barrier.  Time comes either from
the wall clock or from a per-phase hybrid-CPU cost model
(:class:`~repro_torch.serving.phases.HybridPhaseCost`), which also drives
the paper's control loop with separate "prefill" / "decode" ratio keys.

``ServeEngine`` (static shapes, whole-batch generate) remains for
benchmarks and as the building block of ``RoutedServer.serve_batch``, the
seed-era batch API, now a thin wrapper over per-replica
continuous-batching engines.  New callers should use
:class:`~repro_torch.serving.dispatch.InflightDispatcher`.

Where the reference jits its step functions, the port captures the decode
step as one CUDA graph (:mod:`.step_graph`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import events as _ev
from repro_torch.device import resolve_device
from repro_torch.kernels import COUNTED
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.models import forward, init_state
from repro_torch.models.attention import KVCache
from repro_torch.runtime import (
    Balancer,
    DeviceRuntime,
    Plan,
    ReplicaRouter,
    StatsSink,
    clamp_to_capacity,
)

from .phases import DECODE, PHASE_ISA, PREFILL
from .request import FinishReason, Request, RequestState
from .scheduler import IterationScheduler, IterationStats
from .slots import SlotCacheManager
from .step_graph import INPUTS, LAUNCH, StepGraph, timed_launch

__all__ = ["ContinuousBatchingEngine", "GenerationResult", "RoutedServer",
           "ServeEngine"]


def _stack_lane_states(states) -> list:
    """Stack per-lane batch-1 states into one B-row state.

    Every leaf carries the period-repeat axis first and the batch axis
    second, so K/V and the recurrent states' leaves concatenate along
    axis 1 (a copy); a KV cache's ``idx`` goes from (n_rep,) per lane to
    (n_rep, B), the per-row form ``attn_fwd`` already takes (each lane
    appends at its own offset)."""
    out = []
    for leaves in zip(*states):
        first = leaves[0]
        if isinstance(first, KVCache):
            out.append(KVCache(k=torch.cat([c.k for c in leaves], dim=1),
                               v=torch.cat([c.v for c in leaves], dim=1),
                               idx=torch.stack([c.idx for c in leaves],
                                               dim=1)))
        else:
            out.append(type(first)(*(torch.cat(ts, dim=1)
                                     for ts in zip(*leaves))))
    return out


def _slice_lane_state(stacked, i: int) -> list:
    """Row ``i`` of a lane-stacked state, back in batch-1 form (views of
    the stacked tensors; a KV ``idx`` back to (n_rep,)), so the row is
    adopt- and restack-compatible with states from :func:`init_state`."""
    return [KVCache(k=c.k[:, i:i + 1], v=c.v[:, i:i + 1], idx=c.idx[:, i])
            if isinstance(c, KVCache) else
            type(c)(*(t[:, i:i + 1] for t in c))
            for c in stacked]


@dataclass
class GenerationResult:
    tokens: np.ndarray        # (B, prompt+new) — B may include padding rows
    prefill_seconds: float
    decode_seconds: float
    steps: int
    n_requests: Optional[int] = None   # real (unpadded) request count

    @property
    def tokens_per_second(self) -> float:
        b = self.n_requests if self.n_requests is not None else self.tokens.shape[0]
        new = b * self.steps
        return new / max(self.decode_seconds, 1e-9)


class ServeEngine:
    """One replica: static-shape batched greedy decoding.  Its steps run
    uncaptured; the caches are written in place (the reference donates
    its state instead)."""

    def __init__(self, cfg: ModelConfig, params, *, batch_size: int,
                 max_seq: int, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.batch_size = batch_size
        self.max_seq = max_seq
        self.device = resolve_device(device)

    def fresh_state(self):
        return init_state(self.cfg, self.batch_size, self.max_seq,
                          device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, prompts, n_steps: int,
                 sampler: Optional[Callable] = None,
                 n_requests: Optional[int] = None) -> GenerationResult:
        """prompts: (B, S0) int32.  Greedy unless ``sampler(logits)->tok``.
        ``n_requests`` is the real request count when rows are padding."""
        prompts = torch.as_tensor(prompts, device=self.device)
        b, s0 = prompts.shape
        assert b == self.batch_size
        state = self.fresh_state()

        t0 = time.perf_counter()
        out = forward(self.cfg, self.params, prompts, state=state,
                      pos_offset=0, logits_mode="last")
        logits, state = out.logits[:, -1, :], out.state
        self._sync()
        t_prefill = time.perf_counter() - t0

        pick = sampler or (lambda lg: torch.argmax(lg, -1)[:, None])
        toks = [prompts.cpu().numpy()]
        tok = pick(logits)
        t1 = time.perf_counter()
        for i in range(n_steps):
            toks.append(tok.cpu().numpy())
            out = forward(self.cfg, self.params, tok, state=state,
                          pos_offset=torch.tensor(s0 + i, dtype=torch.int32,
                                                  device=self.device))
            logits, state = out.logits[:, -1, :], out.state
            tok = pick(logits)
        self._sync()
        t_decode = time.perf_counter() - t1
        return GenerationResult(
            tokens=np.concatenate(toks, axis=1),
            prefill_seconds=t_prefill,
            decode_seconds=t_decode,
            steps=n_steps,
            n_requests=n_requests,
        )


class ContinuousBatchingEngine:
    """Request-level engine: persistent decode batch + interleaved prefill.

    One :meth:`step` is one scheduler iteration:

    1. *(idle fast-forward)* with nothing admitted and nothing running, the
       clock jumps to the next arrival (open-loop traffic replay).
    2. *Prefill lane(s)*: with one lane, at most one prompt chunk
       (``prefill_chunk`` tokens, or the whole prompt) runs on a detached
       batch-1 state; with ``prefill_lanes > 1`` every active lane
       advances by one shared-length chunk through a single batched trunk
       call (:meth:`_step_prefill_lanes`).  On a request's last chunk its
       first token is sampled and its state is adopted into its decode
       slot.
    3. *Decode lane*: one greedy step for the whole persistent batch;
       finished requests release their slots immediately.

    With a compiled ``balanced_trunk`` (a
    :class:`~repro_torch.models.BalancedTrunk`) every projection of both
    lanes, and the LM head, runs as one kernel launch; the step takes the
    device offset snapshot as an argument and returns its cost tape, which
    is replayed into the ratio tables between steps.  An eager trunk has
    neither: each projection plans, runs one kernel shard per core and
    feeds back when it is called, and its head runs only where a token is
    sampled, as in the reference's ``jit_bridge=False`` engine.
    ``balanced_head`` (:func:`~repro_torch.models.balanced_lm_head`) runs
    the LM head alone that way, outside the step, over a trunk without a
    head (or none).

    **The captured decode step.**  Where the reference jits its steps — a
    compiled trunk, or no trunk at all — the port captures the decode step
    as one CUDA graph (``cuda_graph=True``, the default; it applies only
    to a CUDA ``device``).  Decode always runs all ``max_slots`` rows, so
    one capture serves every decode step of the engine.  Inside the graph:
    the trunk, the compiled head and the cost tape's shard sizes.  Outside
    it: the greedy pick and its copy to the host, the balanced head, the
    cost-tape replay and offset refresh, the virtual clock and every trace
    event.  The reference's step is functional; the port updates the slot
    state in place: K/V rows by the attention's writes, the recurrent
    states by the mixers' in-place updates, and the advanced cache indices
    by a copy inside the step into the slot manager's own ``idx`` tensors,
    so the graph always reads and writes the live state.  Prefill
    stays uncaptured: chunk lengths and lane counts vary.
    ``cuda_graph=False`` runs the same step uncaptured (the comparison
    path); an eager trunk is never captured.

    ``cost_model`` (see :class:`~repro_torch.serving.phases.
    PhaseCostModel`) replaces wall timing with deterministic virtual
    seconds; the model on ``device`` still produces the real tokens.

    **Wall spans.**  With a tracer in
    :data:`repro_torch.core.events.WALL`, each iteration records where the
    host spends its time, on the wall clock and whatever the clock of the
    engine: ``iteration`` > ``admit``, ``prefill`` (> ``prefill.trunk``
    with the model's layer spans, ``pick``, ``prefill.sync``,
    ``feedback``) and ``decode`` (> ``decode.inputs``, ``decode.launch``,
    ``pick``, ``feedback``, ``finish``); the feedback's parts are
    ``feedback.fetch``, ``.replay``, ``.plan`` and ``.upload``.  Each
    request's ``queued``, ``prefilling`` and ``decoding`` phases are spans
    of its own, and ``queue`` and ``slots`` are sampled once an iteration.
    ``iteration`` ends with the step's ``launches`` of the projection
    kernels (:data:`~repro_torch.kernels.COUNTED`) and ``attn_launches`` of
    the decode attention kernel (one per attention layer of a decode step
    on the card, 0 on the plain path).
    """

    def __init__(self, cfg: ModelConfig, params, *, max_slots: int,
                 max_seq: int, prefill_chunk: Optional[int] = None,
                 prefill_lanes: int = 1,
                 sampler: Optional[Callable] = None, cost_model=None,
                 balanced_head=None, balanced_trunk=None, topology=None,
                 device="cuda", cuda_graph: bool = True):
        if prefill_lanes < 1:
            raise ValueError("prefill_lanes must be >= 1")
        if balanced_head is not None and balanced_trunk is not None \
                and balanced_trunk.head is not None:
            raise ValueError(
                "pass either balanced_head or a balanced_trunk with a head, "
                "not both")
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.cost_model = cost_model
        self.prefill_lanes = prefill_lanes
        self.balanced_trunk = balanced_trunk
        self.balanced_head = balanced_head
        # NUMA wiring: a balanced trunk bound to a repro_torch.topology.
        # TopologyDispatcher is adopted automatically — its weights are
        # placed (column ranges pinned to the socket that streams them, in
        # the machine model) and the topology is exposed for telemetry.
        # Passing ``topology=`` asserts which machine the trunk must be
        # balanced over.
        self.topology, self.placement = self._adopt_topology(
            balanced_trunk, topology)
        self._apply_head = (balanced_head is None
                            and (balanced_trunk is None
                                 or balanced_trunk.head is None))
        self.manager = SlotCacheManager(cfg, max_slots, max_seq,
                                        device=self.device)
        self.scheduler = IterationScheduler(prefill_chunk,
                                            prefill_lanes=prefill_lanes)
        # soft concurrency cap (<= max_slots): admission headroom only
        self.slot_budget = max_slots
        self.now = 0.0
        self.finished: List[Request] = []
        self._running: List[Request] = []
        self._partial = None           # in-flight batch-1 prefill state
        self._partials = {}            # request_id -> state (multi-lane)
        self._next_id = 0
        # (B,) greedy rows by default; a sampler sees (B, V) logits.
        self._pick = sampler or (lambda lg: torch.argmax(lg, -1))
        self._compiled_trunk = (balanced_trunk is not None
                                and balanced_trunk.mode == "compiled")
        # the reference jits exactly these steps (use_jit): a compiled
        # trunk's, or the dense model's
        self.captured = (cuda_graph and self.device.type == "cuda"
                         and (balanced_trunk is None or self._compiled_trunk))
        self._graph: Optional[StepGraph] = None   # captured at first decode
        # Initial offset snapshot (compiled trunk): planned from whatever
        # the ratio tables currently hold, rewritten after every step.
        self._offsets = (balanced_trunk.compiled_refresh()
                         if self._compiled_trunk else None)

    @staticmethod
    def _adopt_topology(trunk, topology):
        """Resolve the engine's machine topology from the balanced trunk's
        dispatcher (placing the trunk's weights NUMA-aware when the
        dispatcher is socket-local) and validate an explicit ``topology=``
        against it.  Returns (topology, TrunkPlacement) — (None, None)
        for flat dispatch."""
        from repro_torch.topology import TopologyDispatcher, place_trunk

        disp = getattr(trunk, "dispatcher", None)
        if not isinstance(disp, TopologyDispatcher):
            if topology is not None:
                raise ValueError(
                    "topology= requires a balanced_trunk bound to a "
                    "repro_torch.topology.TopologyDispatcher (the trunk "
                    "decides where its weights execute)")
            return None, None
        adopted = disp.topology
        if topology is not None:
            name = topology if isinstance(topology, str) else topology.name
            if (topology is not adopted and name != adopted.name):
                raise ValueError(
                    f"topology= names {name!r} but the balanced trunk is "
                    f"balanced over {adopted.name!r}")
        placement = place_trunk(trunk) if disp.socket_local else None
        return adopted, placement

    # ------------------------------------------------------------ the step --
    def _run(self, tokens: torch.Tensor, state, pos, phase: str,
             lanes: bool = False):
        """One trunk call (prefill chunk or decode step).  Returns (B, V)
        logits — (B, d) hidden states when a head is still to run
        (:meth:`_head`) — the updated state, and the step's cost-tape
        records (None without a compiled trunk).  ``lanes=True`` (a
        multi-lane prefill chunk) runs the attention and the norms one lane
        at a time, so each lane computes what its one-lane prefill would."""
        trunk = self.balanced_trunk
        isa = PHASE_ISA[phase]
        tape = trunk.compiled_tape_begin() if self._compiled_trunk else None
        out = forward(self.cfg, self.params, tokens, state=state,
                      pos_offset=pos,
                      logits_mode="last" if phase == PREFILL else "all",
                      apply_head=self._apply_head, trunk=trunk,
                      trunk_isa=isa, trunk_offsets=self._offsets,
                      rowwise=lanes)
        logits = out.logits[:, -1, :]
        if tape is None:
            return logits, out.state, None
        if trunk.head is not None:
            logits = trunk.apply_head(logits, isa=isa, offsets=self._offsets)
        return logits, out.state, trunk.compiled_tape_end(tape)

    def _decode_body(self, tok: torch.Tensor, pos: torch.Tensor):
        """The decode step over the persistent batch: the trunk call, then
        the advanced cache indices copied into the slot state's own
        tensors (the mixers advance the K/V rows and the recurrent states
        in those tensors themselves).  Returns the logits (or hidden
        states) and the cost-tape records.  This is what the CUDA graph
        captures."""
        man = self.manager
        logits, state, recs = self._run(tok, man.state, pos, DECODE)
        for big, new in zip(man.state, state):
            if isinstance(big, KVCache):
                big.idx.copy_(new.idx)
        return logits, recs

    def _decode(self):
        """Run the decode step on the slots' last tokens and positions:
        replayed from the engine's graph when captured."""
        man = self.manager
        if not self.captured:
            dev = self.device
            w = _ev.WALL
            sp = w and w.begin(INPUTS)
            tok = torch.as_tensor(man.last_token[:, None], device=dev)
            pos = torch.as_tensor(man.pos, device=dev)
            if sp:
                w.end(sp)
                return timed_launch(w, LAUNCH, dev,
                                    lambda: self._decode_body(tok, pos))
            return self._decode_body(tok, pos)
        if self._graph is None:
            self._graph = StepGraph(self._decode_body, [
                torch.zeros((self.max_slots, 1), dtype=torch.int32,
                            device=self.device),
                torch.zeros((self.max_slots,), dtype=torch.int32,
                            device=self.device)])
        return self._graph(man.last_token[:, None], man.pos)

    def _head(self, hidden: torch.Tensor, phase: str) -> torch.Tensor:
        """The LM head where it runs outside the step — a balanced head, or
        an eager trunk's head — over (B, d) hidden states; the logits of
        every other engine pass through."""
        if self.balanced_head is not None:
            # the Fp32-Int4-Fp32 head: float32 logits whatever the model's
            # dtype (bf16 x would take the kernels' bf16 body)
            return self.balanced_head(hidden.to(torch.float32),
                                      isa=PHASE_ISA[phase])
        trunk = self.balanced_trunk
        if (not self._compiled_trunk and trunk is not None
                and trunk.head is not None):
            return trunk.apply_head(hidden, isa=PHASE_ISA[phase])
        return hidden

    def _sample(self, logits: torch.Tensor, phase: str) -> np.ndarray:
        """Head (where it runs outside the step) and pick, on the host."""
        w = _ev.WALL
        sp = w and w.begin("pick")
        out = self._pick(self._head(logits, phase)).reshape(-1).cpu().numpy()
        if sp:
            w.end(sp)
        return out

    def _feedback(self, recs) -> None:
        """Between-step feedback: replay the step's cost tape into the ratio
        tables and rewrite the offset snapshot."""
        if recs is not None:
            w = _ev.WALL
            sp = w and w.begin("feedback", records=len(recs))
            self._offsets = self.balanced_trunk.compiled_feedback(recs)
            if sp:
                w.end(sp)

    # ------------------------------------------------------------- intake --
    def submit(self, request: Request) -> int:
        """Queue a request; returns its engine-assigned id."""
        if request.prompt_len + 1 > self.max_seq:
            raise ValueError(
                f"prompt of {request.prompt_len} tokens cannot decode within "
                f"max_seq={self.max_seq}")
        request.request_id = self._next_id
        self._next_id += 1
        self.scheduler.submit(request)
        if _ev.WALL is not None:
            _ev.WALL.request_phase(request.request_id, "queued")
        return request.request_id

    def set_slot_budget(self, budget: int) -> int:
        """Re-plan the soft concurrency cap: admission stops above the
        budget while admitted requests run to completion.  Clamped to
        ``[1, max_slots]``.  Returns the applied budget."""
        self.slot_budget = int(np.clip(budget, 1, self.max_slots))
        return self.slot_budget

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work or bool(self._running)

    @property
    def n_running(self) -> int:
        return len(self._running)

    @property
    def n_waiting(self) -> int:
        return self.scheduler.n_waiting()

    @property
    def n_prefilling(self) -> int:
        return len(self.scheduler.lanes)

    @property
    def pending_prefill_tokens(self) -> int:
        """Prompt tokens queued ahead of a newly routed request (the
        dispatcher's prefill-pressure signal)."""
        pending = sum(r.prompt_len for r in self.scheduler.waiting)
        pending += sum(r.prompt_len - r.prefill_done
                       for r in self.scheduler.lanes)
        return pending

    @property
    def queue_depth(self) -> int:
        """Outstanding requests at every pre-finish stage."""
        return self.n_running + self.n_prefilling + self.n_waiting

    def outstanding(self) -> List[Request]:
        """Every request currently owned by the engine."""
        out = list(self.scheduler.waiting)
        out.extend(self.scheduler.lanes)
        out.extend(self._running)
        return out

    def steal_waiting(self) -> List[Request]:
        """Remove and return all still-WAITING requests."""
        out = list(self.scheduler.waiting)
        self.scheduler.waiting.clear()
        return out

    def poll_finished(self) -> List[Request]:
        """Drain and return requests finished since the last poll."""
        out, self.finished = self.finished, []
        return out

    def abort(self, request: Request) -> bool:
        """Cancel a request at any pre-finish stage, releasing whatever it
        holds.  Returns False when it already finished."""
        if request.state is RequestState.FINISHED:
            return False
        man, sched = self.manager, self.scheduler
        if request.state is RequestState.WAITING:
            try:
                sched.waiting.remove(request)
            except ValueError:
                raise ValueError("request is not queued in this engine")
        elif request.state is RequestState.PREFILL:
            sched.remove_lane(request)  # raises when not prefilling here
            self._partial = None
            self._partials.pop(request.request_id, None)
            man.release(request.slot)
            request.slot = None
        elif request.state is RequestState.RUNNING:
            if request not in self._running:
                raise ValueError("request is not running in this engine")
            self._running.remove(request)
            man.release(request.slot)
            request.slot = None
        request.state = RequestState.FINISHED
        request.finish_reason = FinishReason.ABORTED
        request.finish_time = self.now
        self.finished.append(request)
        if _ev.WALL is not None:
            _ev.WALL.request_phase(request.request_id, None)
        return True

    # -------------------------------------------------------------- step ---
    def _admit(self, req: Request):
        """Reserve a slot for a newly admitted request and return its fresh
        prefill state, or None for a request already prefilling."""
        if req.slot is not None:
            return None
        w = _ev.WALL
        sp = w and w.begin("admit", request=req.request_id)
        req.slot = self.manager.allocate()
        req.state = RequestState.PREFILL
        req.admit_time = self.now
        if sp:
            w.request_phase(req.request_id, "prefilling")
        state = self._fresh_state()
        if sp:
            w.end(sp)
        return state

    def _fresh_state(self):
        """A zeroed batch-1 prefill state: one per admission, since the
        caches are written in place (the reference shares one immutable
        template)."""
        return init_state(self.cfg, 1, self.max_seq, device=self.device)

    def step(self) -> IterationStats:
        """Run one scheduler iteration; returns what it did (the per-phase
        feedback record)."""
        st = IterationStats()
        man, sched = self.manager, self.scheduler
        dev = self.device
        w = _ev.WALL
        sp_it = w and w.begin("iteration")
        if sp_it:
            launched = sum(k.launches for k in COUNTED)
            attn_launched = decode_attention.launches

        # Idle fast-forward: nothing to run until the next arrival.
        if (not self._running and not sched.lanes
                and sched.waiting and not sched.n_waiting(self.now)):
            self.now = max(self.now, sched.waiting[0].arrival_time)

        budget_free = max(0, min(man.n_free,
                                 self.slot_budget - man.n_active))
        chunks = sched.next_prefill(self.now, budget_free)
        if chunks and self.prefill_lanes == 1:
            chunk = chunks[0]
            req = chunk.request
            fresh = self._admit(req)
            if fresh is not None:
                self._partial = fresh
            sp_pf = w and w.begin("prefill", request=req.request_id,
                                  start=chunk.start, length=chunk.length,
                                  lanes=1)
            tokens = torch.as_tensor(
                req.prompt[chunk.start:chunk.start + chunk.length][None, :],
                device=dev)
            t0 = time.perf_counter()
            sp = sp_pf and w.begin("prefill.trunk")
            logits, small, recs = self._run(
                tokens, self._partial,
                torch.tensor(chunk.start, dtype=torch.int32, device=dev),
                PREFILL)
            if sp:
                w.end(sp)
            tok = None
            if chunk.is_last:
                # sampling inside the timed window, matching the decode
                # lane (TTFT includes the head)
                tok = int(self._sample(logits, PREFILL)[0])
            if self.cost_model is None:
                if dev.type == "cuda":
                    sp = sp_pf and w.begin("prefill.sync")
                    torch.cuda.synchronize(dev)
                    if sp:
                        w.end(sp)
                dt = time.perf_counter() - t0
            else:
                dt = self.cost_model.prefill_seconds(
                    chunk.length, ctx=chunk.start + chunk.length)
            self._feedback(recs)
            req.prefill_done += chunk.length
            sched.prefill_advanced(chunk)
            if self.cost_model is not None:
                _ev.emit_span("engine", PREFILL, self.now, dt, cat="engine",
                              args=lambda: {"tokens": int(chunk.length)})
            self.now += dt
            st.prefill_tokens = chunk.length
            st.prefill_seconds = dt
            if chunk.is_last:
                self._partial = None
                self._start_decoding(req, small, tok, st)
            else:
                self._partial = small
            if sp_pf:
                w.end(sp_pf)
        elif chunks:
            self._step_prefill_lanes(chunks, st)

        if self._running:
            sp_dec = w and w.begin("decode", rows=len(self._running))
            t0 = time.perf_counter()
            logits, recs = self._decode()
            next_tok = self._sample(logits, DECODE)
            if self.cost_model is None:
                dt = time.perf_counter() - t0
            else:
                dt = self.cost_model.decode_seconds(
                    len(self._running), ctx=int(man.pos.max()))
            self._feedback(recs)
            if self.cost_model is not None:
                _ev.emit_span(
                    "engine", DECODE, self.now, dt, cat="engine",
                    args=lambda: {"batch": len(self._running)})
            self.now += dt
            st.decode_tokens = len(self._running)
            st.decode_seconds = dt
            sp = sp_dec and w.begin("finish")
            for req in list(self._running):
                t = int(next_tok[req.slot])
                req.generated.append(t)
                man.last_token[req.slot] = t
                man.pos[req.slot] += 1
                self._maybe_finish(req, t, st)
            if sp_dec:
                w.end(sp, finished=len(st.finished))
                w.end(sp_dec)

        st.n_running = len(self._running)
        st.n_waiting = self.scheduler.n_waiting()
        st.now = self.now
        if self.cost_model is not None:
            _ev.emit_counter("queue", self.now,
                             lambda: {"depth": float(self.queue_depth)})
        if sp_it:
            w.sample("queue", waiting=st.n_waiting,
                     prefilling=self.n_prefilling, running=st.n_running)
            w.sample("slots", live=man.n_active, free=man.n_free)
            w.end(sp_it, prefill_tokens=st.prefill_tokens,
                  decode_rows=st.decode_tokens,
                  launches=sum(k.launches for k in COUNTED) - launched,
                  attn_launches=decode_attention.launches - attn_launched)
        return st

    def _step_prefill_lanes(self, chunks, st: IterationStats) -> None:
        """Multi-lane prefill: all active lanes advance by one shared-length
        chunk through a *single* batched trunk call (per-row cache offsets),
        instead of one batch-1 call per prompt — the GEMM over B*L rows is
        what the balanced per-core split wants to see.  Token-identical to
        the batch-1 path: the projections give each row the same sums
        whatever the batch, each lane's cache rows are its own, and the
        attention and the norms run one lane at a time (on the card a
        batched GEMM or a reduction sums in an order set by its shape)."""
        man, sched, dev = self.manager, self.scheduler, self.device
        for c in chunks:
            fresh = self._admit(c.request)
            if fresh is not None:
                self._partials[c.request.request_id] = fresh
        length = chunks[0].length
        w = _ev.WALL
        sp_pf = w and w.begin("prefill", start=min(c.start for c in chunks),
                              length=length, lanes=len(chunks),
                              requests=[c.request.request_id for c in chunks])
        tokens = torch.as_tensor(np.stack(
            [np.asarray(c.request.prompt[c.start:c.start + length])
             for c in chunks]), device=dev)
        offsets = torch.as_tensor(
            np.array([c.start for c in chunks], dtype=np.int32), device=dev)
        stacked = _stack_lane_states(
            [self._partials[c.request.request_id] for c in chunks])
        t0 = time.perf_counter()
        sp = sp_pf and w.begin("prefill.trunk")
        logits, out_state, recs = self._run(tokens, stacked, offsets,
                                            PREFILL, lanes=True)
        if sp:
            w.end(sp)
        finishing = [i for i, c in enumerate(chunks) if c.is_last]
        picked = None
        if finishing:  # head + sampling inside the timed window (TTFT)
            picked = self._sample(logits, PREFILL)
        if self.cost_model is None:
            if dev.type == "cuda":
                sp = sp_pf and w.begin("prefill.sync")
                torch.cuda.synchronize(dev)
                if sp:
                    w.end(sp)
            dt = time.perf_counter() - t0
        else:
            # one parallel region over all lanes' tokens: the batched call
            # is what splits across cores, so it is timed as one chunk
            dt = self.cost_model.prefill_seconds(
                length * len(chunks),
                ctx=max(c.start + length for c in chunks))
        self._feedback(recs)
        if self.cost_model is not None:
            _ev.emit_span(
                "engine", PREFILL, self.now, dt, cat="engine",
                args=lambda: {"tokens": int(length * len(chunks)),
                              "lanes": len(chunks)})
        self.now += dt
        st.prefill_tokens = length * len(chunks)
        st.prefill_seconds = dt
        for i, c in enumerate(chunks):
            req = c.request
            req.prefill_done += length
            sched.prefill_advanced(c)
            row = _slice_lane_state(out_state, i)
            if c.is_last:
                self._partials.pop(req.request_id, None)
                self._start_decoding(req, row, int(picked[i]), st)
            else:
                self._partials[req.request_id] = row
        if sp_pf:
            w.end(sp_pf)

    def _start_decoding(self, req: Request, state, tok: int,
                        st: IterationStats) -> None:
        """A request's prefill is done: its first token is out and its
        batch-1 state moves into its decode slot."""
        req.generated.append(tok)
        req.first_token_time = self.now
        self.manager.adopt(req.slot, state, req.prompt_len, tok)
        req.state = RequestState.RUNNING
        self._running.append(req)
        st.admitted.append(req.request_id)
        if _ev.WALL is not None:
            _ev.WALL.request_phase(req.request_id, "decoding")
        self._maybe_finish(req, tok, st)

    def _maybe_finish(self, req: Request, tok: int, st: IterationStats) -> None:
        stopped = req.stop_token is not None and tok == req.stop_token
        out_of_room = req.prompt_len + req.n_generated + 1 > self.max_seq
        if not (stopped or out_of_room
                or req.n_generated >= req.max_new_tokens):
            return
        req.finish_reason = (FinishReason.STOP if stopped
                             else FinishReason.LENGTH)
        req.finish_time = self.now
        req.state = RequestState.FINISHED
        self.manager.release(req.slot)
        req.slot = None
        self._running.remove(req)
        self.finished.append(req)
        st.finished.append(req.request_id)
        if _ev.WALL is not None:
            _ev.WALL.request_phase(req.request_id, None)

    def run_until_idle(self, max_steps: Optional[int] = None) -> List[IterationStats]:
        """Step until every submitted request has finished."""
        stats = []
        while self.has_work:
            if max_steps is not None and len(stats) >= max_steps:
                break
            stats.append(self.step())
        return stats


class RoutedServer:
    """Seed-era batch API (paper Eq. 3 at the serving layer), a thin
    compatibility wrapper over per-replica continuous-batching engines.

    The whole-batch contract is preserved — proportional split across
    replicas by the "serve_step" ratio entry, capacity clamp with overflow
    redistribution, per-replica measured (or injected) times fed back —
    but each replica's share executes through a
    :class:`ContinuousBatchingEngine` (on the replica's device) rather
    than a padded static batch; its prompts prefill as batch-1 calls
    through a single prefill lane.  Request-level callers should use
    :class:`~repro_torch.serving.dispatch.InflightDispatcher` directly.
    """

    def __init__(self, engines: Sequence[ServeEngine],
                 sink: Optional[StatsSink] = None):
        self.engines = list(engines)
        self.runtime = DeviceRuntime(n_slices=len(engines), alpha=0.3)
        self.router = ReplicaRouter(self.runtime)
        # keep_stats=False: a serving process is long-lived; per-batch
        # telemetry goes to the sink, not an unbounded list.
        self.balancer = Balancer(self.router, sink=sink, keep_stats=False)
        self._cb_engines = None

    @property
    def _cb(self):
        """Per-replica continuous-batching engines, built on first use so a
        router-only RoutedServer does not allocate slot state up front."""
        if self._cb_engines is None:
            self._cb_engines = [
                ContinuousBatchingEngine(e.cfg, e.params,
                                         max_slots=e.batch_size,
                                         max_seq=e.max_seq, device=e.device)
                for e in self.engines
            ]
        return self._cb_engines

    @property
    def capacities(self) -> np.ndarray:
        return np.array([e.batch_size for e in self.engines], dtype=np.int64)

    def serve_batch(self, prompts: np.ndarray, n_steps: int,
                    times_override: Optional[np.ndarray] = None):
        """Split ``prompts`` across replicas ∝ current ratios; run; feed
        times back.  ``times_override`` lets tests/benchmarks inject
        simulated heterogeneous replica speeds."""
        if len(prompts) == 0:
            return (np.zeros((0, prompts.shape[1] + n_steps),
                             dtype=prompts.dtype),
                    np.zeros(len(self.engines), dtype=np.int64),
                    np.zeros(len(self.engines)))
        if n_steps == 0:
            # Seed contract: a 0-step round returns the prompts unchanged.
            # Nothing is decoded, so nothing is measured or fed back.
            counts = clamp_to_capacity(self.balancer.plan(len(prompts)).counts,
                                       self.capacities)
            return (np.array(prompts, copy=True), counts,
                    np.zeros(len(self.engines)))
        # The (B, s0 + n_steps) output contract needs cache room for every
        # step on whichever replica a request lands on.
        s0 = prompts.shape[1]
        short = min(e.max_seq for e in self.engines)
        if s0 + n_steps > short:
            raise ValueError(
                f"prompt_len {s0} + n_steps {n_steps} exceeds replica "
                f"max_seq {short}; build engines with max_seq >= "
                f"prompt_len + n_steps")
        # The proportional split can exceed a fast replica's slot count;
        # clamp to capacity and hand the overflow to other replicas.
        planned = self.balancer.plan(len(prompts))
        counts = clamp_to_capacity(planned.counts, self.capacities)
        plan = Plan(counts=counts, key=planned.key)
        with self.balancer.balanced_region(plan=plan) as region:
            results, start = [], 0
            for i, (cb, c) in enumerate(zip(self._cb, counts)):
                if c == 0:
                    continue
                chunk = prompts[start:start + c]
                start += c
                reqs = [Request(prompt=p, max_new_tokens=n_steps)
                        for p in chunk]
                with region.timed(i):
                    for r in reqs:
                        r.arrival_time = cb.now
                        cb.submit(r)
                    cb.run_until_idle()
                cb.poll_finished()  # keep the long-lived engine bounded
                results.append(np.stack([r.tokens for r in reqs]))
            if times_override is not None:
                # Replicas that served nothing have no measurement this
                # round; keep their time at 0 so EMA updates and telemetry
                # skip them instead of learning from a phantom sample.
                override = np.asarray(times_override, dtype=np.float64)
                region.times[:] = np.where(counts > 0, override, 0.0)
        return np.concatenate(results, axis=0), counts, region.times
