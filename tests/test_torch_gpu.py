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
    """Including bk = 32, where a row's scale tile is too small for
    cp.async and the db kernel reads its scales directly."""
    gen = torch.Generator(device=cuda).manual_seed(bk)
    x = torch.randn((6, 2048), generator=gen, device=cuda)
    qw = quantize_q4_0(torch.randn((200, 2048), generator=gen, device=cuda))
    a = K.q4_matmul(x, qw, bk)
    b = K.q4_matmul_db(x, qw, bk)
    assert torch.equal(a, b)
    torch.testing.assert_close(a, K.q4_matmul_plain(x, qw, bk),
                               rtol=2e-5, atol=2e-5 * 2048)


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
