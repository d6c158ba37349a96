"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs an NVIDIA GPU and is marked ``gpu``; on a machine
without one each skips with its reason.  The file imports neither JAX nor
the reference package, so it runs where only the port is installed:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

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
        before = (K.q4_matmul.launches, I8.int8_gemm.launches)
        y = disp.q4_matmul(x, qw)
        acc = disp.int8_gemm(a, w)
        torch.cuda.synchronize()
        assert K.q4_matmul.launches - before[0] <= n_live
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
