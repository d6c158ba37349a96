"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs an NVIDIA GPU and is marked ``gpu``; on a machine
without one each skips with its reason.  The file imports neither JAX nor
the reference package, so it runs where only the port is installed:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from repro_torch.kernels import q4_matmul as K
from repro_torch.kernels.compiled import q4_blocks
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
