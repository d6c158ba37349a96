"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs an NVIDIA GPU and is marked ``gpu``; on a machine
without one each skips with its reason.  The file imports neither JAX nor
the reference package, so it runs where only the port is installed:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import contextlib
import dataclasses
import functools

import pytest
import torch

from repro_torch.kernels import int8_gemm as I8
from repro_torch.kernels import q4_matmul as K
from repro_torch.kernels.compiled import q4_blocks
from repro_torch.kernels.dispatch import HybridKernelDispatcher
from repro_torch.quant.q4 import quantize_q4_0


# ------------------------------------------------------------- on a card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", [(1, 4096, 4096), (4, 11008, 4096),
                                   (8, 4096, 11008), (3, 32000, 4096),
                                   (5, 300, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_kernels_match_plain(cuda, m, n, k, dtype):
    """Both CUDA kernels within the reference's tolerances of the plain
    version, and bitwise equal to each other, at the main path's shapes."""
    gen = torch.Generator(device=cuda).manual_seed(m + n + k)
    tdt = getattr(torch, dtype)
    x = torch.randn((m, k), generator=gen, device=cuda).to(tdt)
    qw = quantize_q4_0(torch.randn((n, k), generator=gen, device=cuda))
    bk = q4_blocks(k)[2]
    before = (K.q4_matmul.launches, K.q4_matmul_db.launches)
    a = K.q4_matmul(x, qw, bk)
    b = K.q4_matmul_db(x, qw, bk)
    torch.cuda.synchronize()
    assert (K.q4_matmul.launches, K.q4_matmul_db.launches) == \
        (before[0] + 1, before[1] + 1)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(a.float(), K.q4_matmul_plain(x, qw, bk).float(),
                               rtol=tol, atol=tol * k)
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("bk", [32, 64, 128, 256, 512, 1024])
def test_gpu_db_bitwise_equal_at_every_bk(cuda, bk):
    """Every K tile the kernels take, bk = 32 included; both kernels sum in
    an order set by K alone."""
    gen = torch.Generator(device=cuda).manual_seed(bk)
    x = torch.randn((6, 2048), generator=gen, device=cuda)
    qw = quantize_q4_0(torch.randn((200, 2048), generator=gen, device=cuda))
    a = K.q4_matmul(x, qw, bk)
    b = K.q4_matmul_db(x, qw, bk)
    assert torch.equal(a, b)
    torch.testing.assert_close(a, K.q4_matmul_plain(x, qw, bk),
                               rtol=2e-5, atol=2e-5 * 2048)


# (M, N, K, bk, dtype) across the Q4 kernels' geometry: N not a multiple
# of a block's 32 rows, every M from 1 to 9 (one and two tiles of 8 x rows),
# the partial last K chunk of K = 11008 (344 groups, chunks of 64), every bk
# at K = 2048, bf16 x
_GEOMETRY = (
    [(m, 1000, 4096, 512, dt) for m in range(1, 10)
     for dt in ("float32", "bfloat16")]
    + [(4, 1000, 11008, 256, dt) for dt in ("float32", "bfloat16")]
    + [(9, 1000, 2048, bk, "float32") for bk in (32, 64, 128, 256, 512, 1024)])


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k,bk,dtype", _GEOMETRY)
def test_gpu_q4_geometry(cuda, m, n, k, bk, dtype):
    """Both Q4 kernels within the reference's tolerances of the plain
    version and bitwise equal to each other, into a new output and into a
    column slice of a wider one."""
    gen = torch.Generator(device=cuda).manual_seed(m * 7 + k + bk)
    tdt = getattr(torch, dtype)
    x = torch.randn((m, k), generator=gen, device=cuda).to(tdt)
    qw = quantize_q4_0(torch.randn((n, k), generator=gen, device=cuda))
    a = K.q4_matmul(x, qw, bk)
    b = K.q4_matmul_db(x, qw, bk)
    full = torch.full((m, n + 40), -7, dtype=tdt, device=cuda)
    K.q4_matmul_db(x, qw, bk, out=full[:, 24:24 + n])
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(a.float(), K.q4_matmul_plain(x, qw, bk).float(),
                               rtol=tol, atol=tol * k)
    assert torch.equal(a, b)
    assert torch.equal(full[:, 24:24 + n], a)
    assert bool((full[:, :24] == -7).all()) and \
        bool((full[:, 24 + n:] == -7).all())


def _ints(m, n, k, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randint(0, 256, (m, k), generator=gen, device=device,
                      dtype=torch.int32).to(torch.uint8)
    w = torch.randint(-127, 128, (n, k), generator=gen, device=device,
                      dtype=torch.int32).to(torch.int8)
    return a, w


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", [
    (1, 4096, 4096), (4, 4096, 4096), (8, 4096, 4096),      # q/k/v/o
    (4, 11008, 4096), (4, 4096, 11008), (4, 32000, 4096),   # up, down, head
    (100, 120, 200),    # the reference's ragged shape (the bytes kernel)
    (3, 1000, 4112),    # ragged N and a 16-byte last K tile (vector kernel)
    (32, 4096, 4096),   # several M tiles
])
def test_gpu_int8_gemm_bitwise_equal_to_plain(cuda, m, n, k):
    a, w = _ints(m, n, k, cuda, seed=m + n + k)
    before = I8.int8_gemm.launches
    got = I8.int8_gemm(a, w)
    torch.cuda.synchronize()
    assert I8.int8_gemm.launches == before + 1
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    assert torch.equal(got, I8.int8_gemm_plain(a, w))


@pytest.mark.gpu
def test_gpu_int8_gemm_extremes_and_empty(cuda):
    """The largest sums the main path can form, exact; an empty product
    launches nothing."""
    k = 11008
    a = torch.full((2, k), 255, dtype=torch.uint8, device=cuda)
    w = torch.stack([torch.full((k,), 127, dtype=torch.int8, device=cuda),
                     torch.full((k,), -127, dtype=torch.int8, device=cuda)])
    assert I8.int8_gemm(a, w).tolist() == [[255 * 127 * k,
                                            -255 * 127 * k]] * 2
    before = I8.int8_gemm.launches
    empty = I8.int8_gemm(a, w[:0])
    assert tuple(empty.shape) == (2, 0)
    assert I8.int8_gemm.launches == before


@pytest.mark.gpu
def test_gpu_eager_shards_equal_monolithic(cuda):
    """Per-core row shards (one launch each, written into one output on
    the card) against one launch over the whole output: bitwise for the
    Q4 kernels at equal bk and for the int8 kernel; parked cores get
    zero-width shards and launch nothing."""
    disp = HybridKernelDispatcher.virtual("ultra-125h", execute=True)
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((4, 4096), generator=gen, device=cuda)
    qw = quantize_q4_0(torch.randn((11008, 4096), generator=gen,
                                   device=cuda))
    a, w = _ints(4, 11008, 4096, cuda, seed=8)
    bk = q4_blocks(4096)[2]
    for parked in (0, disp.n_workers // 2):
        for c in range(disp.n_workers):
            disp.set_active(c, c < disp.n_workers - parked)
        n_live = disp.n_workers - parked
        before = (K.q4_matmul.launches + K.q4_matmul_db.launches,
                  I8.int8_gemm.launches)
        y = disp.q4_matmul(x, qw)
        acc = disp.int8_gemm(a, w)
        torch.cuda.synchronize()
        assert K.q4_matmul.launches + K.q4_matmul_db.launches - \
            before[0] <= n_live
        assert I8.int8_gemm.launches - before[1] <= n_live
        assert torch.equal(y, K.q4_matmul_db(x, qw, bk))
        assert torch.equal(acc, I8.int8_gemm(a, w))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["q4_matmul", "q4_matmul_db", "int8_gemm",
                                    "int8_gemm_bytes"])
def test_gpu_kernels_write_into_a_column_slice(cuda, kernel):
    """``out=`` a column slice of a wider output (rows further apart than
    N): the same bits as a launch into its own tensor, and nothing outside
    the slice is written.  ``int8_gemm_bytes`` takes K = 200, the bytes
    kernel."""
    m, n = 5, 300
    gen = torch.Generator(device=cuda).manual_seed(11)
    if kernel.startswith("q4"):
        x = torch.randn((m, 2048), generator=gen, device=cuda)
        qw = quantize_q4_0(torch.randn((n, 2048), generator=gen, device=cuda))
        fn = functools.partial(getattr(K, kernel), x, qw, 512)
        dtype = torch.float32
    else:
        a, w = _ints(m, n, 200 if kernel.endswith("bytes") else 4096, cuda,
                     seed=12)
        fn = functools.partial(I8.int8_gemm, a, w)
        dtype = torch.int32
    want = fn()
    full = torch.full((m, n + 40), -7, dtype=dtype, device=cuda)
    fn(out=full[:, 24:24 + n])
    torch.cuda.synchronize()
    assert torch.equal(full[:, 24:24 + n], want)
    assert bool((full[:, :24] == -7).all()) and \
        bool((full[:, 24 + n:] == -7).all())


# Both regimes of the int8 kernel (one x tile of 8 rows for M <= 8; 2, 4
# or 8 tiles above, so W streams once per 64 rows) and the bytes kernel
# (K = 200): M on both sides of each tile boundary, N below and above a
# block's rows, K of one partial step, whole steps, a 16-byte last step and
# the main path's depths.
_I8_M = [*range(1, 10), 15, 16, 17, 31, 32, 33, 64, 65, 100]
_I8_K = (16, 32, 48, 4096, 4112, 11008, 200)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 7, 1000, 4096])
@pytest.mark.parametrize("m", _I8_M)
def test_gpu_int8_gemm_regimes_bitwise(cuda, m, n):
    for k in _I8_K:
        a, w = _ints(m, n, k, cuda, seed=m * 131 + n + k)
        before = I8.int8_gemm.launches
        got = I8.int8_gemm(a, w)
        torch.cuda.synchronize()
        assert I8.int8_gemm.launches == before + 1, (m, n, k)
        assert torch.equal(got, I8.int8_gemm_plain(a, w)), (m, n, k)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [4096, 200], ids=["vector", "bytes"])
@pytest.mark.parametrize("m", [4, 32])
def test_gpu_int8_gemm_column_slice_both_regimes(cuda, m, k):
    """Into a column slice of a wider output (ldc > N) at M = 4 and 32:
    the plain version's bits, and nothing outside the slice written."""
    n = 1000
    a, w = _ints(m, n, k, cuda, seed=m + k)
    full = torch.full((m, n + 40), -7, dtype=torch.int32, device=cuda)
    I8.int8_gemm(a, w, out=full[:, 24:24 + n])
    torch.cuda.synchronize()
    assert torch.equal(full[:, 24:24 + n], I8.int8_gemm_plain(a, w))
    assert bool((full[:, :24] == -7).all()) and \
        bool((full[:, 24 + n:] == -7).all())


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 32])
def test_gpu_int8_gemm_extremes_both_regimes(cuda, m):
    """255 x +-127 over K = 11008, the largest sums of the main path, in
    both regimes: exact, every row and column."""
    k, n = 11008, 48
    a = torch.full((m, k), 255, dtype=torch.uint8, device=cuda)
    sign = torch.tensor([1 if i % 3 else -1 for i in range(n)],
                        dtype=torch.int32, device=cuda)
    w = (127 * sign[:, None]).expand(n, k).to(torch.int8).contiguous()
    got = I8.int8_gemm(a, w)
    torch.cuda.synchronize()
    want = (255 * 127 * k * sign).expand(m, n)
    assert torch.equal(got, want)
    assert torch.equal(got, I8.int8_gemm_plain(a, w))


@pytest.mark.gpu
def test_gpu_int8_eager_shards_equal_one_launch_at_m32(cuda):
    """Per-core row shards of the int8 kernel at M = 32 (the tile regime)
    against one launch over the whole output: bitwise."""
    disp = HybridKernelDispatcher.virtual("ultra-125h", execute=True)
    a, w = _ints(32, 11008, 4096, cuda, seed=9)
    before = I8.int8_gemm.launches
    acc = disp.int8_gemm(a, w)
    torch.cuda.synchronize()
    assert 0 < I8.int8_gemm.launches - before <= disp.n_workers
    assert torch.equal(acc, I8.int8_gemm(a, w))
    assert torch.equal(acc, I8.int8_gemm_plain(a, w))


# ------------------------------------------------ the captured decode step --
# compiled trunks (quant, double_buffer[, topology]) and the dense model,
# whose decode steps the engine captures as one CUDA graph; under a
# socket-local topology each boundary tensor holds one entry per core of
# both sockets (28 on dual-125h, 32 on 2s-12900k)
_CAPTURED = {"q4-db": ("q4", True), "q4-direct": ("q4", False),
             "int8": ("int8", True), "fp32": ("fp32", True), "dense": None,
             "q4-db-dual-125h": ("q4", True, "dual-125h"),
             "int8-2s-12900k": ("int8", True, "2s-12900k")}


def _graph_engine(device, which, cuda_graph=True, arch="llama2-7b"):
    """A reduced ``arch`` engine (seeded weights on the card) with three
    queued requests; ``which`` names a key of _CAPTURED."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import BalancedTrunk, init_params
    from repro_torch.serving import (ContinuousBatchingEngine,
                                     HybridPhaseCost, poisson_requests)
    from repro_torch.topology import TopologyDispatcher

    cfg = reduced_config(arch)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    trunk, clock = None, "ultra-125h"
    if _CAPTURED[which] is not None:
        quant, db, *topology = _CAPTURED[which]
        if topology:
            clock = topology[0]
            disp = TopologyDispatcher(clock)
        else:
            disp = HybridKernelDispatcher.virtual(clock)
        trunk = BalancedTrunk.from_params(cfg, params, disp, quant=quant,
                                          double_buffer=db, device=device)
    engine = ContinuousBatchingEngine(
        cfg, params, max_slots=3, max_seq=32, prefill_chunk=4,
        cost_model=HybridPhaseCost(clock), balanced_trunk=trunk,
        device=device, cuda_graph=cuda_graph)
    for r in poisson_requests(3, rate=0, vocab_size=cfg.vocab_size,
                              prompt_len=6, max_new_tokens=10, seed=0):
        engine.submit(r)
    return engine


def _until_all_decoding(engine):
    while engine.n_running < engine.max_slots or engine.n_prefilling:
        engine.step()


def _state(engine):
    """A copy of every leaf of the slot state (KV caches and recurrent
    states alike)."""
    return [tuple(t.clone() for t in c) for c in engine.manager.state]


def _set_state(engine, saved):
    for c, leaves in zip(engine.manager.state, saved):
        for t, value in zip(c, leaves):
            t.copy_(value)


@pytest.mark.gpu
@pytest.mark.parametrize("which", list(_CAPTURED))
def test_gpu_replayed_step_equals_uncaptured_step(cuda, which):
    """From the same slot state, a replay of the captured decode step and
    the step run uncaptured give the same logits and the same state (K/V
    rows and cache indices), bit for bit; the state keeps its tensors."""
    engine = _graph_engine(cuda, which)
    assert engine.captured
    _until_all_decoding(engine)
    assert engine._graph is not None and engine._graph.graph is not None
    tensors = [(c.k, c.v, c.idx) for c in engine.manager.state]
    saved = _state(engine)
    replays = engine._graph.replays
    logits, _ = engine._decode()
    replayed = (logits.clone(), _state(engine))
    assert engine._graph.replays == replays + 1
    _set_state(engine, saved)
    man = engine.manager
    logits, _ = engine._decode_body(
        torch.as_tensor(man.last_token[:, None], device=cuda),
        torch.as_tensor(man.pos, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(replayed[0], logits)
    for got, want in zip(replayed[1], _state(engine)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert [(c.k, c.v, c.idx) for c in man.state] == tensors
    assert int((replayed[1][0][2] - saved[0][2]).min()) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("which", [w for w in _CAPTURED if w != "dense"])
def test_gpu_replay_reads_refreshed_offsets(cuda, which):
    """Offsets refreshed between replays reach the graph: the tape's size
    tensors, recomputed by each replay, follow the new plan."""
    import numpy as np

    engine = _graph_engine(cuda, which)
    _until_all_decoding(engine)
    trunk = engine.balanced_trunk
    ctx = trunk._compiled()
    _, recs = engine._decode()
    before = torch.stack([r["sizes"] for r in recs]).cpu().numpy()
    table = trunk.dispatcher.table
    n = table.n_workers
    for key in table.keys():
        table.set(key, np.linspace(1.0, 8.0, n)[::-1])
    engine._offsets = trunk.compiled_refresh()
    _, again = engine._decode()
    assert again is recs
    after = torch.stack([r["sizes"] for r in recs]).cpu().numpy()
    for rec, got in zip(recs, after):
        want = ctx.snapshot.counts(ctx._specs[rec["spec"]].name)
        assert got.tolist() == want.tolist()
    assert (after != before).any()


@pytest.mark.gpu
@pytest.mark.parametrize("which", list(_CAPTURED))
def test_gpu_launch_counts_include_replays(cuda, which):
    """A captured run counts the launches of an uncaptured run of the same
    traffic, replays included, and gives the same tokens and timelines."""
    from repro_torch.kernels import COUNTED

    runs = {}
    for graph in (True, False):
        engine = _graph_engine(cuda, which, cuda_graph=graph)
        before = [w.launches for w in COUNTED]
        reqs = engine.outstanding()
        engine.run_until_idle()
        torch.cuda.synchronize()
        runs[graph] = ([w.launches - b for w, b in zip(COUNTED, before)],
                       [(r.generated, r.finish_time) for r in reqs], engine)
    assert runs[True][0] == runs[False][0]
    assert runs[True][1] == runs[False][1]
    graph = runs[True][2]._graph
    assert graph.replays > 0 and runs[False][2]._graph is None
    assert (sum(runs[True][0]) > 0) == (_CAPTURED[which] is not None
                                        and which != "fp32")
    assert sum(graph.launches) * graph.replays <= sum(runs[True][0])


@pytest.mark.gpu
def test_gpu_capture_survives_garbage_collection(cuda):
    """An engine and its graph refer to each other, so a dropped engine's
    graph is freed by the garbage collector; that must not happen inside
    another engine's capture (freeing a graph's memory there invalidates
    the capture).  With the collector run at almost every allocation, the
    capture still succeeds."""
    import gc

    dead = _graph_engine(cuda, "q4-db")
    _until_all_decoding(dead)
    assert dead._graph.graph is not None
    del dead
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        engine = _graph_engine(cuda, "int8")
        _until_all_decoding(engine)
    finally:
        gc.set_threshold(*threshold)
    assert engine._graph.graph is not None
    engine.run_until_idle()


@pytest.mark.gpu
def test_gpu_eager_trunk_is_not_captured(cuda):
    """The reference does not jit an eager trunk's step, and the port does
    not capture it: its decode runs uncaptured, shard by shard."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import BalancedTrunk, init_params
    from repro_torch.serving import ContinuousBatchingEngine

    cfg = reduced_config("llama2-7b")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    trunk = BalancedTrunk.from_params(
        cfg, params, HybridKernelDispatcher.virtual("ultra-125h",
                                                    execute=True),
        mode="eager", device=cuda)
    engine = ContinuousBatchingEngine(cfg, params, max_slots=2, max_seq=16,
                                      balanced_trunk=trunk, device=cuda)
    assert engine.captured is False
    dense = ContinuousBatchingEngine(cfg, params, max_slots=2, max_seq=16,
                                     device=cuda)
    assert dense.captured is True


@pytest.mark.gpu
def test_gpu_balanced_head_shards_equal_one_launch(cuda):
    """The balanced head's eager per-core shards (one launch per non-empty
    shard, of the entry the tuner picks) equal one q4_matmul over the
    whole head, bitwise."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import balanced_lm_head, init_params

    cfg = reduced_config("llama2-7b")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    disp = HybridKernelDispatcher.virtual("ultra-125h", execute=True)
    head = balanced_lm_head(cfg, params, disp, device=cuda)
    x = torch.randn((3, cfg.d_model), device=cuda)
    before = K.q4_matmul.launches + K.q4_matmul_db.launches
    y = head(x, isa="membw")
    torch.cuda.synchronize()
    shards = int((disp.last_stats.counts > 0).sum())
    assert K.q4_matmul.launches + K.q4_matmul_db.launches - before == \
        shards > 0
    assert torch.equal(y, K.q4_matmul(x, head.qw, q4_blocks(cfg.d_model)[2]))


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["q4-db", "int8"])
def test_gpu_lanes_prefill_rows_equal_one_lane(cuda, which):
    """A multi-lane prefill chunk gives each lane the logits and caches of
    its one-lane chunk, bitwise: the kernels sum each row in an order set
    by K alone and each lane attends on its own."""
    from repro_torch.models import init_slot_state, init_state
    from repro_torch.serving import PREFILL

    engine = _graph_engine(cuda, which)
    cfg, lanes = engine.cfg, 3
    gen = torch.Generator(device=cuda).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (lanes, 4), generator=gen,
                           device=cuda, dtype=torch.int32)
    starts = torch.tensor([0, 4, 8], dtype=torch.int32, device=cuda)
    stacked = init_slot_state(cfg, lanes, 32, device=cuda)
    for c in stacked:
        c.idx.copy_(starts.expand_as(c.idx))
    many, state, _ = engine._run(tokens, stacked, starts, PREFILL,
                                 lanes=True)
    for i in range(lanes):
        one = init_state(cfg, 1, 32, device=cuda)
        for c in one:
            c.idx.fill_(int(starts[i]))
        logits, st, _ = engine._run(tokens[i:i + 1], one, starts[i], PREFILL)
        assert torch.equal(logits[0], many[i])
        for a, b in zip(st, state):
            assert torch.equal(a.k[:, 0], b.k[:, i])


# kept last: a failed capture is the one test here that leaves a CUDA
# error behind it for torch to clear
@pytest.mark.gpu
@pytest.mark.parametrize("which", list(_CAPTURED))
def test_gpu_sync_inside_capture_raises(cuda, which):
    """A decode step that syncs with the host cannot be captured: the
    engine raises, at the first decode step and again at the next, and
    never falls back to the uncaptured step."""
    engine = _graph_engine(cuda, which)
    body = engine._decode_body

    def syncing(tok, pos):
        logits, recs = body(tok, pos)
        float(logits.sum())            # a host sync
        return logits, recs

    engine._decode_body = syncing
    for _ in range(2):
        with pytest.raises(RuntimeError):
            while True:
                engine.step()
        assert engine._graph is not None and engine._graph.graph is None
    torch.cuda.synchronize()


# ----------------------------------------------------------- the topology --
@pytest.mark.gpu
@pytest.mark.parametrize("which", ["q4-db-dual-125h", "int8-2s-12900k"])
def test_gpu_topology_snapshot_written_in_place(cuda, which):
    """Under a socket-local topology each projection's boundary tensor
    (one entry per core of both sockets, plus one) keeps its address when
    a new socket split and new per-socket core splits are refreshed, and
    the next replay's tape follows them."""
    import numpy as np

    engine = _graph_engine(cuda, which)
    _until_all_decoding(engine)
    trunk = engine.balanced_trunk
    ctx = trunk._compiled()
    topo = trunk.dispatcher
    cores = sum(d.n_workers for d in topo.socket_dispatchers)
    snap = ctx.snapshot.device()
    ptrs = {name: t.data_ptr() for name, t in snap.items()}
    assert {t.numel() for t in snap.values()} == {cores + 1}
    _, recs = engine._decode()
    before = torch.stack([r["sizes"] for r in recs]).cpu().numpy()
    for table in [topo.table] + [d.table for d in topo.socket_dispatchers]:
        for key in table.keys():
            table.set(key, np.linspace(1.0, 6.0, table.n_workers))
    engine._offsets = trunk.compiled_refresh()
    assert {n: t.data_ptr() for n, t in engine._offsets.items()} == ptrs
    _, again = engine._decode()
    assert again is recs
    after = torch.stack([r["sizes"] for r in recs]).cpu().numpy()
    for rec, got in zip(recs, after):
        want = ctx.snapshot.counts(ctx._specs[rec["spec"]].name)
        assert len(got) == cores and got.tolist() == want.tolist()
    assert (after != before).any()
    engine.run_until_idle()


@pytest.mark.gpu
@pytest.mark.parametrize("topology", ["dual-125h", "2s-12900k"])
@pytest.mark.parametrize("kernel", ["q4", "int8"])
def test_gpu_topology_eager_shards_equal_one_launch(cuda, topology, kernel):
    """Eager topology shards — a socket split, then one launch per
    non-empty core shard of each socket, the outputs concatenated along N
    — equal one launch over the whole weight, bitwise."""
    import numpy as np

    from repro_torch.topology import TopologyDispatcher

    gen = torch.Generator(device=cuda).manual_seed(7)
    disp = TopologyDispatcher(topology, execute=True)
    disp.table.set("membw", np.array([1.0, 3.0]))
    disp.table.set("avx_vnni", np.array([3.0, 1.0]))
    def q4_launches():   # a shard launches the tuner's pick of the two
        return K.q4_matmul.launches + K.q4_matmul_db.launches

    before = (q4_launches(), I8.int8_gemm.launches)
    if kernel == "q4":
        x = torch.randn((4, 4096), generator=gen, device=cuda)
        qw = quantize_q4_0(torch.randn((11008, 4096), generator=gen,
                                       device=cuda))
        y = disp.q4_matmul(x, qw)
    else:
        a = torch.randint(0, 256, (4, 4096), generator=gen, device=cuda,
                          dtype=torch.int32).to(torch.uint8)
        w = torch.randint(-127, 128, (11008, 4096), generator=gen,
                          device=cuda, dtype=torch.int32).to(torch.int8)
        y = disp.int8_gemm(a, w)
    launched = (q4_launches() - before[0],
                I8.int8_gemm.launches - before[1])
    want = (K.q4_matmul_db(x, qw, q4_blocks(4096)[2]) if kernel == "q4"
            else I8.int8_gemm(a, w))
    torch.cuda.synchronize()
    shards = sum(int((d.last_stats.counts > 0).sum())
                 for d in disp.socket_dispatchers)
    assert launched == ((shards, 0) if kernel == "q4" else (0, shards))
    assert shards > 16 and torch.equal(y, want)


@pytest.mark.gpu
def test_gpu_fleet_engines_live_on_the_card(cuda):
    """Every engine of a fleet node runs on the card: its slot caches are
    there, its decode step is captured, and a seeded run finishes every
    request."""
    from repro_torch.configs import reduced_config
    from repro_torch.fleet import (Cluster, FleetRouter, NodeSpec,
                                   failure_window, fleet_requests)
    from repro_torch.models import init_params

    cfg = reduced_config("llama2-7b")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    cluster = Cluster.build(
        (NodeSpec("big", "dual-125h", max_slots=2, prefill_lanes=2),
         NodeSpec("flat", "ultra-125h", max_slots=2)),
        cfg, params, max_seq=32, device=cuda)
    router = FleetRouter(cluster)
    done = router.run(fleet_requests(8, base_rate=20.0,
                                     vocab_size=cfg.vocab_size,
                                     prompt_len=(4, 12), max_new_tokens=4,
                                     seed=0),
                      failure_window("flat", fail_at=0.1, recover_at=0.2))
    torch.cuda.synchronize()
    engines = [e for n in cluster.nodes for e in n.engines]
    assert len(engines) == 3 and len(done) == 8
    assert all(r.finish_time is not None for r in done)
    assert all(c.k.device.type == "cuda" and c.idx.device.type == "cuda"
               for e in engines for c in e.manager.state)
    assert all(e.captured for e in engines)
    assert any(e._graph is not None and e._graph.replays for e in engines)


# ------------------------------------------------------------- the zoo --
# (N, K) of the zoo's projections at shapes the llama2-7b path never
# launches: the granite-moe head (N % 8 = 3) and attention (K = 1024),
# chatglm3's wk/wv (N = 256), and the down projections of chatglm3,
# granite-8b and starcoder2 (K = 13696, 14336, 24576)
_ZOO_SHAPES = [(49155, 1024), (1024, 1024), (512, 1024), (256, 4096),
               (4096, 13696), (4096, 14336), (6144, 24576)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", _ZOO_SHAPES)
@pytest.mark.parametrize("m", [1, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_q4_kernels_at_zoo_shapes(cuda, m, n, k, dtype):
    gen = torch.Generator(device=cuda).manual_seed(n + k + m)
    x = torch.randn((m, k), generator=gen, device=cuda).to(
        getattr(torch, dtype))
    qw = quantize_q4_0(torch.randn((n, k), generator=gen, device=cuda))
    bk = q4_blocks(k)[2]
    a = K.q4_matmul(x, qw, bk)
    b = K.q4_matmul_db(x, qw, bk)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(a.float(), K.q4_matmul_plain(x, qw, bk).float(),
                               rtol=tol, atol=tol * k)
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", _ZOO_SHAPES)
@pytest.mark.parametrize("m", [1, 4, 8, 32])
def test_gpu_int8_gemm_at_zoo_shapes(cuda, m, n, k):
    a, w = _ints(m, n, k, cuda, seed=m + n + k)
    got = I8.int8_gemm(a, w)
    torch.cuda.synchronize()
    assert torch.equal(got, I8.int8_gemm_plain(a, w))


_MOE = ("granite-moe-1b-a400m", "llama4-maverick-400b-a17b")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", _MOE)
@pytest.mark.parametrize("which", ["q4-db", "int8", "dense"])
def test_gpu_moe_replayed_step_equals_uncaptured_step(cuda, arch, which):
    """An MoE model's decode step captures (its routing syncs nothing with
    the host), and its replay gives the uncaptured step's logits and
    state bit for bit (the combine sums each token's experts in a fixed
    order, with no atomics)."""
    engine = _graph_engine(cuda, which, arch=arch)
    _until_all_decoding(engine)
    assert engine._graph is not None and engine._graph.graph is not None
    saved = _state(engine)
    logits, _ = engine._decode()
    replayed = (logits.clone(), _state(engine))
    _set_state(engine, saved)
    man = engine.manager
    logits, _ = engine._decode_body(
        torch.as_tensor(man.last_token[:, None], device=cuda),
        torch.as_tensor(man.pos, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(replayed[0], logits)
    for got, want in zip(replayed[1], _state(engine)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", _MOE)
def test_gpu_moe_fwd_deterministic_and_equal_to_the_cpu(cuda, arch):
    """The MoE layer on the card: the same bits on every call, the CPU's
    routing (chosen experts, loads, drops) at a capacity that drops, and
    its output within f32 tolerance of the CPU's."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import moe

    cfg = reduced_config(arch)
    p = moe.init_moe(cfg, torch.Generator().manual_seed(0), "cpu")
    p = {k: v[0] for k, v in p.items()}
    x = torch.randn((2, 40, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    y_cpu, aux_cpu = moe.moe_fwd(cfg, p, x, capacity=8)
    pc = {k: v.to(cuda) for k, v in p.items()}
    y1, aux1 = moe.moe_fwd(cfg, pc, x.to(cuda), capacity=8)
    y2, _ = moe.moe_fwd(cfg, pc, x.to(cuda), capacity=8)
    assert torch.equal(y1, y2)
    assert torch.equal(aux1["top_e"].cpu(), aux_cpu["top_e"])
    assert torch.equal(aux1["load"].cpu(), aux_cpu["load"])
    assert float(aux1["dropped"]) == float(aux_cpu["dropped"]) > 0
    torch.testing.assert_close(y1.cpu(), y_cpu, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------- recurrent mixers --
_RECURRENT = ("jamba-1.5-large-398b", "xlstm-1.3b")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mamba", "mlstm", "slstm"])
def test_gpu_recurrent_mixers_equal_the_cpu(cuda, name):
    """Each recurrent mixer on the card against the CPU, from a carried
    state (a prefill of 8 then a decode step), in f32 within 2e-5 of
    scale (TF32 off), its state advanced in place in both; the same bits
    on a second run."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import ssm, xlstm

    arch = "jamba-1.5-large-398b" if name == "mamba" else "xlstm-1.3b"
    cfg = reduced_config(arch)
    mod = ssm if name == "mamba" else xlstm
    init = getattr(mod, f"init_{name}")
    fwd = getattr(mod, f"{name}_fwd")
    init_state = getattr(mod, f"init_{name}_state")
    p = {k: v[0] for k, v in
         init(cfg, torch.Generator().manual_seed(0), "cpu").items()}
    x = torch.randn((3, 9, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    outs = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev, run in (("cpu", 0), ("cuda", 0), ("cuda", 1)):
            pd = {k: v.to(dev) for k, v in p.items()}
            st = init_state(cfg, 3, device=dev)
            y0, _ = fwd(cfg, pd, x[:, :8].to(dev), st)
            y1, st2 = fwd(cfg, pd, x[:, 8:].to(dev), st)
            assert all(a is b for a, b in zip(st, st2))
            outs[(dev, run)] = [t.cpu() for t in (y0, y1, *st)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for a, b in zip(outs[("cuda", 0)], outs[("cuda", 1)]):
        assert torch.equal(a, b)
    for got, want in zip(outs[("cuda", 0)], outs[("cpu", 0)]):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 2e-5 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("arch", _RECURRENT)
@pytest.mark.parametrize("which", ["q4-db", "int8"])
def test_gpu_recurrent_replayed_step_equals_uncaptured_step(cuda, arch,
                                                            which):
    """The recurrent archs' decode step captures (no mixer syncs with the
    host), and its replay gives the uncaptured step's logits and every
    state leaf (KV caches, mamba, mLSTM and sLSTM states) bit for bit,
    written into the slot state's own tensors."""
    engine = _graph_engine(cuda, which, arch=arch)
    _until_all_decoding(engine)
    assert engine._graph is not None and engine._graph.graph is not None
    ptrs = [t.data_ptr() for c in engine.manager.state for t in c]
    saved = _state(engine)
    logits, _ = engine._decode()
    replayed = (logits.clone(), _state(engine))
    assert any(not torch.equal(a, b) for got, was in zip(replayed[1], saved)
               for a, b in zip(got, was))
    _set_state(engine, saved)
    man = engine.manager
    logits, _ = engine._decode_body(
        torch.as_tensor(man.last_token[:, None], device=cuda),
        torch.as_tensor(man.pos, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(replayed[0], logits)
    for got, want in zip(replayed[1], _state(engine)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert ptrs == [t.data_ptr() for c in engine.manager.state for t in c]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", _RECURRENT)
def test_gpu_recurrent_served_captured_equals_uncaptured(cuda, arch):
    """Whole serving runs on the Q4 trunk, captured and uncaptured: the same
    tokens for every request."""
    tokens = []
    for cuda_graph in (True, False):
        engine = _graph_engine(cuda, "q4-db", cuda_graph=cuda_graph,
                               arch=arch)
        assert engine.captured == cuda_graph
        engine.run_until_idle()
        tokens.append([r.generated for r in engine.finished])
    assert tokens[0] == tokens[1]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", _RECURRENT)
def test_gpu_adopt_and_release_of_a_recurrent_row(cuda, arch):
    """``adopt`` copies every leaf of a batch-1 state into its row and no
    other; ``release`` zeroes only the KV cache index and leaves the
    recurrent row as it is, and the next adopt overwrites it."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import init_state
    from repro_torch.models.attention import KVCache
    from repro_torch.serving.slots import SlotCacheManager

    cfg = reduced_config(arch)
    man = SlotCacheManager(cfg, 3, 16, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)

    def filled():
        small = init_state(cfg, 1, 16, device=cuda)
        for c in small:
            for t in c:
                if t.is_floating_point():
                    t.copy_(torch.randn(t.shape, generator=gen, device=cuda))
                else:
                    t.fill_(5)
        return small

    small = filled()
    before = [tuple(t.clone() for t in c) for c in man.state]
    slot = man.allocate()
    man.adopt(slot, small, n_context=5, last_token=3)
    for big, sm, was in zip(man.state, small, before):
        for b, s, w in zip(big, sm, was):
            want = s[:, 0] if s.dim() == b.dim() else s
            assert torch.equal(b[:, slot], want)
            others = [i for i in range(3) if i != slot]
            assert torch.equal(b[:, others], w[:, others])
    man.release(slot)
    for big, sm in zip(man.state, small):
        if isinstance(big, KVCache):
            assert not big.idx[:, slot].any()
            assert torch.equal(big.k[:, slot], sm.k[:, 0])
        else:
            for b, s in zip(big, sm):
                assert torch.equal(b[:, slot], s[:, 0])
    again = filled()
    assert man.allocate() == slot
    man.adopt(slot, again, n_context=2, last_token=1)
    for big, sm in zip(man.state, again):
        for b, s in zip(big, sm):
            want = s[:, 0] if s.dim() == b.dim() else s
            assert torch.equal(b[:, slot], want)


# ------------------------------------------------------------ training --
@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-1b-a400m",
                                  "xlstm-1.3b"])
def test_gpu_train_step_equals_the_cpu(cuda, arch):
    """One make_train_step step (2 microbatches, remat) of the reduced
    arch cut to 2 layers, in float32 with TF32 off, on the card against
    the CPU from the same weights and batch: loss and grad norm within
    1e-5, and no parameter parting by a learning rate or more (an Adam
    sign flip parts one by 2·lr).  Two layers, because deeper random
    mLSTM stacks are ill-conditioned: scaling the reduced xlstm's weights
    by one ulp moves its grad norm by 3.4e-3 at 16 layers, 1.7e-3 at 8
    and 2.6e-7 at 2 (on the CPU)."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import init_params
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)
    from repro_torch.tree import leaves, tree_map

    cfg = dataclasses.replace(reduced_config(arch), n_layers=2)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 2, 16),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": toks}
    out = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("cpu", cuda):
            p = tree_map(lambda t: t.to(dev), params)
            step = make_train_step(cfg, opt_cfg, remat=True)
            new_p, _, m = step(p, init_opt_state(p, opt_cfg),
                               {k: v.to(dev) for k, v in batch.items()})
            out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]),
                             [t.cpu() for t in leaves(new_p)])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (l_c, g_c, p_c), (l_g, g_g, p_g) = out["cpu"], out["cuda"]
    assert abs(l_g - l_c) <= 1e-5 * abs(l_c)
    assert abs(g_g - g_c) <= 1e-5 * abs(g_c)
    for a, b in zip(p_g, p_c):
        assert a.device.type == "cpu" and a.shape == b.shape
        assert int(((a - b).abs() >= opt_cfg.lr).sum()) == 0


@pytest.mark.gpu
def test_gpu_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """A tree of bf16, f32 and int32 tensors on the card saves and restores
    onto the card bit for bit, in the template's dtypes."""
    from repro_torch.checkpoint import restore, save
    from repro_torch.training import init_opt_state
    from repro_torch.tree import leaves

    g = torch.Generator(device=cuda).manual_seed(0)
    params = {"w": torch.randn((64, 32), generator=g, device=cuda)
              .to(torch.bfloat16),
              "b": torch.randn((32,), generator=g, device=cuda)}
    tree = {"params": params, "opt": init_opt_state(params)}
    save(str(tmp_path), 1, tree)
    got, _ = restore(str(tmp_path), 1, tree, device=cuda)
    for a, b in zip(leaves(got), leaves(tree)):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)


# ------------------------------------------------------------ sharding --
@pytest.fixture(scope="module")
def mesh11(tmp_path_factory):
    """An NCCL process group of world size 1 (a file rendezvous) and its
    (1, 1) ("data", "model") mesh on the card, as chip_smoke's phase 13."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (NCCL process group on the card)")
    import torch.distributed as dist

    from repro_torch.launch.cluster import init_cluster
    from repro_torch.launch.mesh import make_debug_mesh

    rdv = tmp_path_factory.mktemp("rendezvous") / "store"
    assert init_cluster(f"file://{rdv}", 1, 0, device="cuda")
    assert dist.get_backend() == "nccl"
    yield make_debug_mesh(1, 1, device="cuda")
    dist.destroy_process_group()


def _sharded(mesh, params, opt):
    from repro_torch.sharding import distribute, opt_shardings, param_shardings

    ps = param_shardings(mesh, params)
    tree = distribute({"params": params, "opt": opt},
                      {"params": ps, "opt": opt_shardings(mesh, opt, ps)})
    return tree["params"], tree["opt"], ps


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-1b-a400m"])
def test_gpu_sharded_train_step_equals_the_plain(mesh11, arch):
    """One train step (2 layers, f32, TF32 off, 2 microbatches, remat) on
    the (1, 1) mesh over NCCL — DTensor parameters, optimizer state and
    batch, ``grad_shardings`` — against the plain step on the card from the
    same weights and batch: loss and grad norm within 1e-5, no parameter
    parting by a learning rate or more, every leaf still on the mesh."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import reduced_config
    from repro_torch.models import init_params
    from repro_torch.sharding import (activation_sharding, batch_shardings,
                                      distribute)
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(reduced_config(arch), n_layers=2)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 2, 16),
                         generator=torch.Generator().manual_seed(1)).cuda()
    batch = {"tokens": toks, "labels": toks}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        step = make_train_step(cfg, opt_cfg, remat=True)
        plain_p, _, pm = step(params, init_opt_state(params, opt_cfg), batch)
        dp, do, ps = _sharded(mesh11, params, init_opt_state(params,
                                                             opt_cfg))
        db = distribute(batch, batch_shardings(mesh11, batch, batch_dim=1))
        sstep = make_train_step(cfg, opt_cfg, remat=True, grad_shardings=ps)
        with activation_sharding(mesh11):
            shard_p, shard_o, sm = sstep(dp, do, db)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert all(isinstance(t, DTensor) and t.device_mesh is mesh11
               for t in leaves(shard_p) + leaves(shard_o))
    assert abs(float(sm["loss"]) - float(pm["loss"])) <= \
        1e-5 * abs(float(pm["loss"]))
    assert abs(float(sm["grad_norm"]) - float(pm["grad_norm"])) <= \
        1e-5 * abs(float(pm["grad_norm"]))
    for a, b in zip(leaves(shard_p), leaves(plain_p)):
        assert int(((a.full_tensor() - b).abs() >= opt_cfg.lr).sum()) == 0


@pytest.mark.gpu
def test_gpu_restore_onto_the_mesh_is_bitwise(mesh11, tmp_path):
    """A plain checkpoint of reduced olmo (bf16 params, f32 moments)
    restored with ``shardings=`` onto the (1, 1) mesh: DTensor leaves on
    the mesh, bitwise the plain restore."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import restore, save
    from repro_torch.configs import reduced_config
    from repro_torch.models import init_params
    from repro_torch.sharding import opt_shardings, param_shardings
    from repro_torch.training import init_opt_state
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(reduced_config("olmo-1b"), n_layers=2,
                              dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    tree = {"params": params, "opt": init_opt_state(params)}
    save(str(tmp_path), 1, tree)
    plain, _ = restore(str(tmp_path), 1, tree, device="cuda")
    ps = param_shardings(mesh11, params)
    onto, _ = restore(str(tmp_path), 1, tree, device="cuda", shardings={
        "params": ps, "opt": opt_shardings(mesh11, tree["opt"], ps)})
    for a, b in zip(leaves(onto), leaves(plain)):
        assert isinstance(a, DTensor) and a.device_mesh is mesh11
        assert a.dtype == b.dtype and torch.equal(a.full_tensor(), b)


@pytest.mark.gpu
def test_gpu_sharded_decode_equals_the_plain(mesh11):
    """Reduced granite-8b on the (1, 1) mesh over NCCL: serve-mode
    parameters, the caches laid out by ``state_shardings(phase="decode")``
    (DTensors, so the cache write takes the sharded path, each rank
    writing its own slice of the sequence), a prefill of 8 tokens and 3
    decode steps: the logits of each and the caches within 1e-5 of their
    scale of the plain run's on the card, as on the CPU meshes
    (``tests/test_torch_sharding.py``).  Not held bitwise: on the CPU the
    (1, 1) mesh's decode steps part from the plain ones by ~1e-6 in the
    attention's output, though each product alone is bitwise."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import forward, init_params, init_state
    from repro_torch.sharding import (activation_sharding, batch_shardings,
                                      distribute, param_shardings,
                                      state_shardings)

    cfg = reduced_config("granite-8b")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    gen = torch.Generator().manual_seed(1)
    steps = [torch.randint(0, cfg.vocab_size, (4, 8), generator=gen)] + \
        [torch.randint(0, cfg.vocab_size, (4, 1), generator=gen)
         for _ in range(3)]
    steps = [t.cuda() for t in steps]

    def run(mesh):
        st = init_state(cfg, 4, 16, device="cuda")
        p = params
        if mesh is not None:
            p = distribute(params, param_shardings(mesh, params, mode="serve"))
            st = distribute(st, state_shardings(mesh, st, 4, phase="decode"))
        logits = []
        with (activation_sharding(mesh) if mesh is not None
              else contextlib.nullcontext()), torch.no_grad():
            for i, t in enumerate(steps):
                if mesh is not None:
                    t = distribute({"t": t}, batch_shardings(mesh, {"t": t}))[
                        "t"]
                out = forward(cfg, p, t, state=st,
                              pos_offset=0 if i == 0 else 7 + i,
                              logits_mode="last")
                st = out.state
                lo = out.logits
                logits.append(lo.full_tensor() if mesh is not None else lo)
        caches = [getattr(c, a) for c in st for a in ("k", "v")]
        if mesh is not None:
            caches = [c.full_tensor() for c in caches]
        return logits, caches

    plain, sharded = run(None), run(mesh11)
    pairs = list(zip(sharded[0] + sharded[1], plain[0] + plain[1]))
    print(f"sharded decode on (1, 1) bitwise the plain: "
          f"{all(torch.equal(a, b) for a, b in pairs)}")
    for a, b in pairs:
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


# ------------------------------------------- launch variants, threads --
@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", [(1, 4096, 4096), (4, 11008, 4096),
                                   (32, 4096, 11008)])
def test_gpu_every_variant_equals_the_default_entry(cuda, m, n, k):
    """The kernel tuner's candidates: both Q4 entries, and every compiled
    instantiation of the int8 kernel at any M, bitwise equal to the
    default entry."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device=cuda).manual_seed(m + n)
    x = torch.randn((m, k), generator=gen, device=cuda)
    qw = quantize_q4_0(torch.randn((n, k), generator=gen, device=cuda))
    want = K.q4_matmul(x, qw, q4_blocks(k)[2])
    for variant in ops.Q4_CANDIDATES:
        assert torch.equal(ops.q4_variant(x, qw, variant), want), variant
    a, w = _ints(m, n, k, cuda, seed=m)
    want = I8.int8_gemm(a, w)
    before = I8.int8_gemm.launches
    for variant in ops.INT8_CANDIDATES:
        assert torch.equal(I8.int8_gemm(a, w, variant=variant), want), \
            variant
    torch.cuda.synchronize()
    assert I8.int8_gemm.launches - before == len(ops.INT8_CANDIDATES)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["q4", "int8", "f32"])
def test_gpu_threaded_region_equals_virtual(cuda, kernel):
    """A threaded dispatcher's region: shards launched from 4 worker
    threads, each on its own CUDA stream after the caller's, equal to the
    virtual dispatcher's shards run in turn on the caller's stream (Q4 and
    int8 bitwise); the output is ready on the caller's stream."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    # x made on the caller's stream just before the region
    x = torch.randn((4, 4096), generator=gen, device=cuda) * 2.0
    w = torch.randn((11008, 4096), generator=gen, device=cuda)
    virt = HybridKernelDispatcher.virtual("ultra-125h", execute=True)
    thr = HybridKernelDispatcher.threaded(4)
    try:
        outs = []
        for d in (virt, thr):
            if kernel == "q4":
                outs.append(d.q4_matmul(x, quantize_q4_0(w)))
            elif kernel == "int8":
                a, ws = _ints(4, 11008, 4096, cuda, seed=3)
                outs.append(d.int8_gemm(a, ws))
            else:
                outs.append(d.f32_matmul(x, w))
            outs[-1] = outs[-1].clone()   # read on the caller's stream
        torch.cuda.synchronize()
        if kernel == "f32":
            torch.testing.assert_close(outs[1], outs[0], rtol=1e-5,
                                       atol=1e-4)
        else:
            assert torch.equal(outs[1], outs[0])
        assert len(thr._streams.streams) == 4
        assert (thr.last_stats.times > 0).sum() == 4
    finally:
        virt.close()
        thr.close()


@pytest.mark.gpu
def test_gpu_captured_step_makes_no_host_sync(cuda):
    """JA001 on the card: reduced llama2-7b's compiled decode step, run
    uncaptured and replayed from its graph under sync debug mode
    "error", makes no synchronizing CUDA call."""
    from repro_torch.analysis import step_audit

    engine = _graph_engine(cuda, "q4-db")
    engine.step()                      # prefill: workspaces, first launches
    _until_all_decoding(engine)
    engine.step()                      # the capture
    torch.cuda.synchronize()
    man = engine.manager
    tok = torch.as_tensor(man.last_token[:, None], device=cuda)
    pos = torch.as_tensor(man.pos, device=cuda)
    torch.cuda.synchronize()
    got = step_audit.audit_sync_debug(
        lambda: engine._decode_body(tok, pos), where="body")
    got += step_audit.audit_sync_debug(engine._graph.graph.replay,
                                       where="replay")
    torch.cuda.synchronize()
    assert got == []
