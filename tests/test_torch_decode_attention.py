"""The decode attention kernel's module on the CPU: its plain version
against the attention's plain path at one query per row, the dispatch that
keeps the CPU, prefill chunks and DTensors on the plain path, and what the
wrapper refuses.  The kernel itself runs only on a card
(``tests/test_torch_gpu.py``, marked ``gpu``).
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.kernels import decode_attention as DA
from repro_torch.models import attention as A

SRC = str(Path(__file__).resolve().parents[1] / "src")

S_MAX = 520   # two splits of 384 positions: the merge runs


def _inputs(b, hkv, g, hd, dtype, lengths, seed=0):
    """q (B, Hkv, G, 1, hd), k, v (B, Hkv, S_MAX, hd) in ``dtype``; per row
    ``(q_pos, kv_len)`` from ``lengths``."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((b, hkv, g, 1, hd), generator=gen).to(dtype)
    k = torch.randn((b, hkv, S_MAX, hd), generator=gen).to(dtype)
    v = torch.randn((b, hkv, S_MAX, hd), generator=gen).to(dtype)
    q_pos = torch.tensor([[p] for p, _ in lengths], dtype=torch.int64)
    kv_len = torch.tensor([n for _, n in lengths], dtype=torch.int32)
    return q, k, v, q_pos, kv_len


# (q_pos, kv_len) of each row: 1 live position, 17, S_MAX, an index run
# past S_MAX (a free slot), and no live position (q_pos -1: the plain
# path's softmax over a fully masked row is uniform)
ROWS = [(0, 1), (16, 17), (S_MAX - 1, S_MAX), (S_MAX + 5, S_MAX + 6),
        (-1, 3)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("g", [1, 2, 4, 16])
@pytest.mark.parametrize("hd", [16, 64, 128])
def test_plain_version_equals_the_attention_path(hd, g, dtype):
    """The kernel's arithmetic (splits, running max and sum, log-sum-exp
    merge) against ``_sdpa_grouped`` at Sq = 1, on every kind of row.
    Tolerance: both sum in float32 but in other orders (one softmax over
    every position against per-split sums merged), ~1e-6 of scale; in
    bf16 that can move an output by one rounding step of its 8 bits."""
    tdt = getattr(torch, dtype)
    q, k, v, q_pos, kv_len = _inputs(len(ROWS), 2, g, hd, tdt, ROWS)
    got = DA.decode_attention_plain(q, k, v, q_pos, kv_len)
    want = A._sdpa_grouped(q, k, v, q_pos, torch.arange(S_MAX), kv_len)
    assert got.dtype == want.dtype == tdt and got.shape == want.shape
    tol = 2 ** -7 if dtype == "bfloat16" else 2e-6
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("form", ["scalar", "per_row"])
def test_plain_version_takes_one_length_or_one_per_row(form):
    """kv_len as one value for every row (a batch prefill's cache) or one
    per row (slot-batched serving), q_pos broadcast from one row."""
    q, k, v, _, _ = _inputs(3, 1, 4, 64, torch.float32, ROWS[:3])
    q_pos = torch.broadcast_to(torch.tensor([[40]]), (3, 1))
    kv_len = torch.tensor(41) if form == "scalar" else \
        torch.tensor([41, 41, 41], dtype=torch.int64)
    got = DA.decode_attention_plain(q, k, v, q_pos, kv_len)
    want = A._sdpa_grouped(q, k, v, q_pos, torch.arange(S_MAX), kv_len)
    torch.testing.assert_close(got, want, rtol=2e-6, atol=2e-6)


# ---------------------------------------------------------------- dispatch --
def _layer(arch="granite-8b"):
    cfg = reduced_config(arch)
    p = {k: v[0] for k, v in A.init_attn(cfg, torch.Generator().manual_seed(0),
                                         "cpu").items()}
    return cfg, p


def _run(cfg, p, s, idx, seed=1):
    """attn_fwd on a fresh (B=3, S_max=24) cache holding ``idx`` positions
    per row, then an ``s``-token chunk at each row's index."""
    gen = torch.Generator().manual_seed(seed)
    b, s_max = 3, 24
    cache = A.KVCache(
        torch.randn((b, cfg.n_kv_heads, s_max, cfg.hd), generator=gen),
        torch.randn((b, cfg.n_kv_heads, s_max, cfg.hd), generator=gen),
        torch.tensor(idx, dtype=torch.int32))
    x = torch.randn((b, s, cfg.d_model), generator=gen)
    pos = torch.tensor(idx, dtype=torch.int32)[:, None] + torch.arange(s)
    return A.attn_fwd(cfg, p, x, pos, cache)


@pytest.mark.parametrize("s", [1, 4], ids=["decode", "chunk"])
def test_cpu_keeps_the_plain_path(monkeypatch, s):
    """On the CPU neither a decode step nor a prefill chunk reaches the
    kernel: the output is the plain path's, bit for bit."""
    cfg, p = _layer()
    want, _ = _run(cfg, p, s, [5, 9, 0])

    def refuse(*a):
        raise AssertionError("the kernel was called")

    monkeypatch.setattr(A, "decode_attention", refuse)
    got, cache = _run(cfg, p, s, [5, 9, 0])
    assert torch.equal(got, want)
    assert cache.idx.tolist() == [5 + s, 9 + s, 0 + s]


@pytest.mark.parametrize("arch", ["granite-8b", "granite-moe-1b-a400m",
                                  "chatglm3-6b", "olmo-1b"])
def test_dispatch_hands_the_kernel_what_the_plain_path_reads(monkeypatch,
                                                             arch):
    """Where the kernel applies (stood in for by its plain version), a
    decode step's output matches the plain path's: the query's layout,
    the positions and the cache's length reach it as the plain path reads
    them.  A prefill chunk (s > 1) still takes the plain path."""
    cfg, p = _layer(arch)
    want, _ = _run(cfg, p, 1, [5, 23, 0])
    calls = []

    def kernel(*args):
        calls.append(args)
        return DA.decode_attention_plain(*args)

    monkeypatch.setattr(A, "decode_attention", kernel)
    monkeypatch.setattr(A, "_on_card", lambda *ts: True)
    got, _ = _run(cfg, p, 1, [5, 23, 0])
    assert len(calls) == 1
    torch.testing.assert_close(got, want, rtol=2e-6, atol=2e-6)
    _run(cfg, p, 4, [5, 9, 0])
    assert len(calls) == 1


_DTENSOR = textwrap.dedent("""
    import contextlib, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import reduced_config
    from repro_torch.models import attention as A
    from repro_torch.models import forward, init_params, init_state
    from repro_torch.sharding import (activation_sharding, batch_shardings,
                                      distribute, param_shardings,
                                      state_shardings)

    dist.init_process_group("gloo", init_method="file://" + sys.argv[1],
                            rank=0, world_size=1)
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    cfg = reduced_config("granite-8b")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    steps = [torch.randint(0, cfg.vocab_size, (4, 8), generator=gen),
             torch.randint(0, cfg.vocab_size, (4, 1), generator=gen)]

    def run(mesh):
        st = init_state(cfg, 4, 16, device="cpu")
        p = params
        if mesh is not None:
            p = distribute(params, param_shardings(mesh, params, mode="serve"))
            st = distribute(st, state_shardings(mesh, st, 4, phase="decode"))
        with (activation_sharding(mesh) if mesh is not None
              else contextlib.nullcontext()), torch.no_grad():
            for i, t in enumerate(steps):
                if mesh is not None:
                    t = distribute({"t": t}, batch_shardings(mesh, {"t": t}))["t"]
                out = forward(cfg, p, t, state=st, pos_offset=8 * i,
                              logits_mode="last")
                st = out.state
        lo = out.logits
        return lo.full_tensor() if mesh is not None else lo

    plain = run(None)

    def refuse(*a):
        raise AssertionError("the kernel was called")

    A.decode_attention = refuse
    sharded = run(mesh)
    err = float((sharded - plain).abs().max())
    assert err <= 1e-5 * float(plain.abs().max()), err
    dist.destroy_process_group()
    print("ok")
""")


def test_dtensors_keep_the_plain_path(tmp_path):
    """Reduced granite-8b's decode step on the (1, 1) mesh (gloo, one rank;
    DTensor parameters and caches laid out for decode) takes the plain
    path: the kernel is never called, and the logits are the plain run's
    within the mesh path's own 1e-5 of scale."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _DTENSOR,
                           str(tmp_path / "rendezvous")], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


# ----------------------------------------------------------------- wrapper --
def _valid():
    return _inputs(2, 2, 4, 64, torch.bfloat16, [(3, 4), (9, 10)])


@pytest.mark.parametrize("case,match", [
    ("cpu", "needs CUDA tensors"),
    ("head_dim", "head dim 12"),
    ("head_dim_large", "head dim 264"),
    ("dtype", "bfloat16 or float32"),
    ("mixed_dtype", "bfloat16 or float32"),
    ("group", "query heads per KV head"),
    ("positions", "int32 or int64"),
])
def test_wrapper_raises(case, match):
    """The wrapper takes CUDA tensors of the shapes and types the kernel
    handles, and raises on anything else: there is no fallback."""
    q, k, v, q_pos, kv_len = _valid()
    if case in ("head_dim", "head_dim_large"):
        hd = 12 if case == "head_dim" else 264
        q, k, v, q_pos, kv_len = _inputs(2, 2, 4, hd, torch.bfloat16,
                                         [(3, 4), (9, 10)])
    elif case == "dtype":
        k, v = k.to(torch.float16), v.to(torch.float16)
    elif case == "mixed_dtype":
        v = v.float()
    elif case == "group":
        q, k, v, q_pos, kv_len = _inputs(2, 1, 17, 64, torch.bfloat16,
                                         [(3, 4), (9, 10)])
    elif case == "positions":
        q_pos = q_pos.float()
    with pytest.raises(ValueError, match=match):
        DA.decode_attention(q, k, v, q_pos, kv_len)
    assert DA.decode_attention.launches == 0


def test_module_imports_without_cuda():
    """The module imports where there is no card and no nvcc (the library
    builds at first launch), and its launch count starts at 0."""
    code = ("from repro_torch.kernels import decode_attention as DA; "
            "import torch; assert not torch.cuda.is_available(); "
            "assert DA.decode_attention.launches == 0; "
            "assert DA._library.cache_info().currsize == 0; print('ok')")
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"
