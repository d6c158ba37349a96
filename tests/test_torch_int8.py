"""The port's int8 quantization and u8 x s8 GEMM against the reference.

Inputs are made from a numpy seed and handed to both packages.  On the CPU
the port's kernel wrapper takes its plain torch version; the reference's
Pallas kernel runs in interpret mode.  The integer sums are exact in both,
so the accumulators must agree bit for bit; the f32 dequant agrees within
rtol 1e-6 (XLA may fuse its multiply-subtract).  The CUDA kernel against
the plain version, on a card, is in ``test_torch_gpu.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import int8_gemm as ref_int8_gemm
from repro.kernels import int8_linear as ref_int8_linear
from repro.kernels import ref as ref_oracle
from repro.quant import int8 as R
from repro_torch.kernels import _build, ops
from repro_torch.kernels import int8_gemm as K
from repro_torch.kernels import q4_matmul as Q4
from repro_torch.kernels import ref as port_oracle
from repro_torch.quant import int8 as P
from repro_torch.quant.q4 import quantize_q4_0


def _ints(m, n, k, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, size=(m, k)).astype(np.uint8)
    w = rng.integers(-127, 128, size=(n, k)).astype(np.int8)
    return a, w


# ------------------------------------------------------------ quantization --
@pytest.mark.parametrize("m,k", [(1, 64), (4, 4096), (8, 11008), (33, 200)])
def test_u8_activation_quantization_bit_identical(m, k):
    """Codes, scales and zero points, including a constant row (scale 0 ->
    1.0), an all-zero row and a row whose codes sit on a rounding edge."""
    x = np.random.default_rng(m + k).standard_normal((m, k)).astype(
        np.float32) * 3.0
    x[0] = 1.5
    if m > 2:
        x[1] = 0.0
        x[2, :2] = (-1.0, 1.0)
        x[2, 2:] = 0.5 * (2.0 / 255.0)   # half a code above 0: ties to even
    a = R.quantize_u8_dynamic(jnp.asarray(x))
    b = P.quantize_u8_dynamic(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(a.q), b.q.numpy())
    np.testing.assert_array_equal(np.asarray(a.scale), b.scale.numpy())
    np.testing.assert_array_equal(np.asarray(a.zero), b.zero.numpy())
    assert b.q.dtype == torch.uint8 and b.zero.dtype == torch.int32
    assert float(b.scale[0]) == 1.0


@pytest.mark.parametrize("n,k", [(8, 64), (300, 512), (64, 4096)])
def test_s8_weight_quantization_bit_identical(n, k):
    """Codes and scales equal the reference's, including an all-zero row;
    the column sums are the exact int32 row sums of the codes."""
    w = np.random.default_rng(n * k).standard_normal((n, k)).astype(
        np.float32)
    w[1] = 0.0
    a = R.quantize_s8_symmetric(jnp.asarray(w))
    b = P.quantize_s8_symmetric(torch.from_numpy(w))
    np.testing.assert_array_equal(np.asarray(a.q), b.q.numpy())
    np.testing.assert_array_equal(np.asarray(a.scale), b.scale.numpy())
    np.testing.assert_array_equal(
        np.asarray(a.q).astype(np.int64).sum(-1), b.colsum.numpy())
    assert b.colsum.dtype == torch.int32 and b.q.is_contiguous()
    assert (b.out_features, b.in_features) == (n, k)


def test_quantization_from_bf16_matches():
    x = np.random.default_rng(3).standard_normal((16, 128)).astype(
        np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    a, b = R.quantize_u8_dynamic(xj), P.quantize_u8_dynamic(xt)
    np.testing.assert_array_equal(np.asarray(a.q), b.q.numpy())
    np.testing.assert_array_equal(np.asarray(a.scale), b.scale.numpy())
    wa, wb = R.quantize_s8_symmetric(xj), P.quantize_s8_symmetric(xt)
    np.testing.assert_array_equal(np.asarray(wa.q), wb.q.numpy())
    np.testing.assert_array_equal(np.asarray(wa.scale), wb.scale.numpy())


def test_weight_quantization_of_a_transposed_view():
    """The trunk quantizes ``w.T`` views of (d_in, d_out) parameters: the
    codes come out contiguous and equal to those of the copied matrix."""
    w = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (96, 40)).astype(np.float32))
    a = P.quantize_s8_symmetric(w.T)
    b = P.quantize_s8_symmetric(w.T.contiguous())
    assert a.q.is_contiguous()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_dequantize_bit_identical():
    x = np.random.default_rng(5).standard_normal((6, 256)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(R.dequantize_u8(R.quantize_u8_dynamic(jnp.asarray(x)))),
        P.dequantize_u8(P.quantize_u8_dynamic(torch.from_numpy(x))).numpy())
    np.testing.assert_array_equal(
        np.asarray(R.dequantize_s8(R.quantize_s8_symmetric(jnp.asarray(x)))),
        P.dequantize_s8(P.quantize_s8_symmetric(torch.from_numpy(x))).numpy())


@pytest.mark.parametrize("m,n,k", [(4, 64, 256), (8, 300, 4096)])
def test_decompose_matches_reference(m, n, k):
    rng = np.random.default_rng(m + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((n, k)).astype(np.float32)
    qa_r, qw_r = (R.quantize_u8_dynamic(jnp.asarray(x)),
                  R.quantize_s8_symmetric(jnp.asarray(w)))
    qa_p, qw_p = (P.quantize_u8_dynamic(torch.from_numpy(x)),
                  P.quantize_s8_symmetric(torch.from_numpy(w)))
    acc = ref_oracle.int8_gemm_ref(qa_r.q, qw_r.q)
    want = R.u8s8_matmul_decompose(qa_r, qw_r, acc)
    got = P.u8s8_matmul_decompose(qa_p, qw_p,
                                  torch.from_numpy(np.array(acc)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# --------------------------------------------- plain version vs reference --
@pytest.mark.parametrize("m,n,k", [
    (128, 128, 256),     # one block
    (256, 256, 512),     # multi-block
    (100, 120, 200),     # all dims ragged
    (1, 128, 256),       # GEMV row
    (4, 96, 4096),       # a narrow main-path decode shape (M = 4, K = d)
])
def test_int8_gemm_plain_equals_reference_bit_for_bit(m, n, k):
    """The plain version (and the front end, which takes it on the CPU)
    against the reference's Pallas kernel in interpret mode and its
    oracle, at tests/test_kernels.py's shapes."""
    a, w = _ints(m, n, k, seed=m * 7 + n + k)
    want = np.asarray(ref_int8_gemm(jnp.asarray(a), jnp.asarray(w),
                                    interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(ref_oracle.int8_gemm_ref(jnp.asarray(a),
                                                  jnp.asarray(w))))
    at, wt = torch.from_numpy(a), torch.from_numpy(w)
    for got in (K.int8_gemm_plain(at, wt), ops.int8_gemm(at, wt),
                port_oracle.int8_gemm_ref(at, wt)):
        assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
        np.testing.assert_array_equal(got.numpy(), want)


def test_int8_gemm_plain_exact_at_the_extremes():
    """All-255 activations against all-127 and all-(-127) rows at the
    widest main-path K: the largest sums the trunk can form, exact in the
    float64 plain version."""
    k = 11008
    a = torch.full((2, k), 255, dtype=torch.uint8)
    w = torch.stack([torch.full((k,), 127, dtype=torch.int8),
                     torch.full((k,), -127, dtype=torch.int8)])
    got = K.int8_gemm_plain(a, w)
    assert got.tolist() == [[255 * 127 * k, -255 * 127 * k]] * 2


@pytest.mark.parametrize("m,n,k", [(32, 64, 256), (3, 200, 512)])
def test_int8_linear_matches_reference(m, n, k):
    rng = np.random.default_rng(n + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((n, k)).astype(np.float32)
    want = ref_int8_linear(R.quantize_u8_dynamic(jnp.asarray(x)),
                           R.quantize_s8_symmetric(jnp.asarray(w)),
                           interpret=True)
    qa = P.quantize_u8_dynamic(torch.from_numpy(x))
    qw = P.quantize_s8_symmetric(torch.from_numpy(w))
    for got in (ops.int8_linear(qa, qw), ops.int8_linear(qa, qw, plain=True),
                port_oracle.int8_gemm_f32_ref(qa, qw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# ----------------------------------------------------- routing and counts --
def test_cpu_tensors_take_plain_path_and_do_not_count():
    K.reset_launch_counts()
    a, w = _ints(4, 64, 512, seed=0)
    at, wt = torch.from_numpy(a), torch.from_numpy(w)
    assert torch.equal(K.int8_gemm(at, wt), K.int8_gemm_plain(at, wt))
    assert K.int8_gemm.launches == 0


def test_wrapper_raises_on_devices_without_a_kernel():
    a = torch.empty((2, 64), dtype=torch.uint8, device="meta")
    w = torch.empty((8, 64), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no int8 kernel"):
        K.int8_gemm(a, w)


@pytest.mark.parametrize("case", ["dtype_a", "dtype_w", "k", "layout",
                                  "rank", "m_range"])
def test_kernel_input_checks(case):
    """What the CUDA kernel refuses is refused before any launch."""
    a = torch.zeros((4, 256), dtype=torch.uint8)
    w = torch.zeros((16, 256), dtype=torch.int8)
    if case == "dtype_a":
        a = a.to(torch.int8)
    elif case == "dtype_w":
        w = w.to(torch.uint8)
    elif case == "k":
        w = torch.zeros((16, 128), dtype=torch.int8)
    elif case == "layout":
        w = torch.zeros((256, 16), dtype=torch.int8).T
    elif case == "rank":
        a = a[None]
    elif case == "m_range":
        a = torch.zeros((8 * 65535 + 1, 1), dtype=torch.uint8)
        w = torch.zeros((1, 1), dtype=torch.int8)
    with pytest.raises(ValueError):
        K._check(a, w)


@pytest.mark.parametrize("kernel", ["int8_gemm", "q4_matmul", "q4_matmul_db"])
def test_wrappers_write_into_a_column_slice(kernel):
    """``out=`` (one eager shard's columns of a wider output) receives the
    product and nothing outside its columns changes."""
    m, n, k = 3, 40, 256
    if kernel == "int8_gemm":
        a, w = (torch.from_numpy(t) for t in _ints(m, n, k, seed=3))
        fn, want, dtype = K.int8_gemm, K.int8_gemm_plain(a, w), torch.int32
    else:
        rng = np.random.default_rng(3)
        a = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32))
        w = quantize_q4_0(
            torch.from_numpy(rng.standard_normal((n, k), dtype=np.float32)))
        fn = functools.partial(getattr(Q4, kernel), bk=128)
        want, dtype = Q4.q4_matmul_plain(a, w, 128), torch.float32
    full = torch.full((m, n + 24), -7, dtype=dtype)
    got = fn(a, w, out=full[:, 16:16 + n])
    assert got.data_ptr() == full[:, 16:].data_ptr()
    assert torch.equal(full[:, 16:16 + n], want)
    assert bool((full[:, :16] == -7).all()) and bool((full[:, -8:] == -7).all())


@pytest.mark.parametrize("case", ["shape", "dtype", "device", "columns"])
def test_kernel_output_checks(case):
    """A destination the kernels cannot write row-major is refused."""
    out = torch.zeros((4, 32), dtype=torch.int32)
    if case == "shape":
        out = out[:, :16]
    elif case == "dtype":
        out = out.float()
    elif case == "device":
        out = torch.empty((4, 32), dtype=torch.int32, device="meta")
    elif case == "columns":
        out = torch.zeros((32, 4), dtype=torch.int32).T
    with pytest.raises(ValueError, match="out must be"):
        _build.output(out, 4, 32, torch.int32, torch.device("cpu"))
    got, ld = _build.output(torch.zeros((4, 48), dtype=torch.int32)[:, 8:40],
                            4, 32, torch.int32, torch.device("cpu"))
    assert ld == 48 and tuple(got.shape) == (4, 32)


@pytest.mark.parametrize("module", [K, Q4], ids=["int8_gemm", "q4_matmul"])
def test_build_helper_without_nvcc_raises(monkeypatch, module):
    """Both kernel libraries build through one helper; without nvcc it
    raises (no fallback) and names the source."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match=f"nvcc.*{module.SOURCE.name}"):
        module.compile_library(force=True)


def test_kernel_source_names_what_it_replaces():
    text = K.SOURCE.read_text()
    for needle in ("int8_gemm_pallas", "repro/kernels/int8_gemm.py",
                   ":42", ":60", "HBM", "dp4a.u32.s32", "__shfl_xor_sync",
                   "__shared__", "sm_90a", "cudaGetLastError"):
        assert needle in text
