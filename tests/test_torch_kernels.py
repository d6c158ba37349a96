"""The port's Q4 quantization and kernels against the reference.

Inputs are made from a numpy seed and handed to both packages.  On the CPU
the port's kernel wrappers take their plain torch version; the reference's
Pallas kernels run in interpret mode.  The CUDA kernels against the plain
version, on a card, are in ``test_torch_gpu.py``.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import q4_matmul as ref_q4_ops
from repro.kernels import ref as ref_oracle
from repro.kernels.compiled import q4_blocks as ref_q4_blocks
from repro.kernels.q4_matmul import q4_matmul_pallas, q4_matmul_pallas_db
from repro.quant.q4 import QuantizedLinear as RefQL
from repro.quant.q4 import dequantize_q4_0 as ref_dequant
from repro.quant.q4 import quantize_q4_0 as ref_quant
from repro_torch.kernels import _build, ops
from repro_torch.kernels import q4_matmul as K
from repro_torch.kernels import ref as port_oracle
from repro_torch.kernels.compiled import q4_blocks
from repro_torch.quant.q4 import QuantizedLinear, dequantize_q4_0, quantize_q4_0

RNG = np.random.default_rng(0)


def _weights(n, k, seed=0):
    w = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    return ref_quant(jnp.asarray(w)), quantize_q4_0(torch.from_numpy(w))


# ------------------------------------------------------------------ Q4_0 ---
@pytest.mark.parametrize("n,k", [(8, 64), (16, 128), (300, 512), (64, 4096)])
def test_q4_quantize_bit_identical(n, k):
    """Packed bytes and f16 scales equal the reference's bit for bit,
    including all-zero groups and tied absmax elements."""
    w = np.random.default_rng(n + k).standard_normal((n, k)).astype(np.float32)
    w[0, :32] = 0.0                 # d == 0 group
    w[1, 3], w[1, 4] = 5.0, -5.0    # tie: argmax takes the first
    w[2, 7] = 0.5 * 8 * 0.25        # a half-way code rounds to even
    a = ref_quant(jnp.asarray(w))
    b = quantize_q4_0(torch.from_numpy(w))
    np.testing.assert_array_equal(np.asarray(a.packed), b.packed.numpy())
    np.testing.assert_array_equal(np.asarray(a.scales).view(np.uint16),
                                  b.scales.numpy().view(np.uint16))


def test_q4_dequantize_bit_identical():
    qa, qb = _weights(32, 256)
    np.testing.assert_array_equal(np.asarray(ref_dequant(qa)),
                                  dequantize_q4_0(qb).numpy())


def test_q4_quantize_from_bf16_matches():
    w = RNG.standard_normal((16, 128)).astype(np.float32)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    a = ref_quant(jnp.asarray(w).astype(jnp.bfloat16))
    b = quantize_q4_0(wb)
    np.testing.assert_array_equal(np.asarray(a.packed), b.packed.numpy())


def test_q4_rejects_ragged_k():
    with pytest.raises(ValueError):
        quantize_q4_0(torch.zeros((4, 48)))


def test_quantized_linear_properties():
    _, qw = _weights(24, 256)
    assert (qw.out_features, qw.in_features) == (24, 256)
    assert qw.nbytes == 24 * 128 + 2 * 24 * 8


# -------------------------------------------- plain version vs reference --
@pytest.mark.parametrize("m,n,k", [
    (8, 256, 512),      # exactly one block
    (16, 512, 1024),    # multi-block in every dim
    (8, 256, 1536),     # 3 k-steps
    (1, 100, 512),      # GEMV with a ragged N
    (5, 256, 512),      # ragged M
    (9, 300, 512),      # ragged M and N
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q4_matmul_front_end_matches_reference(m, n, k, dtype):
    """The port's front end (plain path on CPU) against the reference's
    Pallas front end (interpret mode) and oracle, at test_kernels.py's
    shapes and tolerances: f32 rtol 2e-5, atol 2e-5*K; bf16 2e-2 (the
    order of the f32 sums differs)."""
    rng = np.random.default_rng(m * 1000 + n + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    qa, qb = _weights(n, k, seed=k + n)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    xj, xt = jnp.asarray(x, dtype=jdt), torch.from_numpy(x).to(tdt)
    got = ops.q4_matmul(xt, qb)
    assert got.shape == (m, n) and got.dtype == tdt
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for want in (ref_q4_ops(xj, qa, interpret=True),
                 ref_oracle.q4_matmul_ref(xj, qa)):
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want, dtype=np.float32),
            rtol=tol, atol=tol * k)


@pytest.mark.parametrize("shape,bk", [
    ((8, 256, 512), 512),
    ((8, 512, 1024), 256),
    ((16, 256, 256), 128),
])
def test_q4_matmul_plain_matches_both_pallas_kernels(shape, bk):
    """q4_matmul_plain (the per-tile low-then-high-plane body) against the
    plain and double-buffered Pallas kernels at the same bk."""
    m, n, k = shape
    x = np.random.default_rng(1).standard_normal((m, k)).astype(np.float32)
    qa, qb = _weights(n, k, seed=2)
    got = K.q4_matmul_plain(torch.from_numpy(x), qb, bk).numpy()
    for fn in (q4_matmul_pallas, q4_matmul_pallas_db):
        want = np.asarray(fn(jnp.asarray(x), qa, blocks=(8, 128, bk),
                             interpret=True))
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * k)


def test_q4_oracle_matches_reference_oracle():
    x = RNG.standard_normal((3, 256)).astype(np.float32)
    qa, qb = _weights(40, 256)
    np.testing.assert_allclose(
        port_oracle.q4_matmul_ref(torch.from_numpy(x), qb).numpy(),
        np.asarray(ref_oracle.q4_matmul_ref(jnp.asarray(x), qa)),
        rtol=2e-5, atol=2e-5 * 256)


@pytest.mark.parametrize("k", [32, 192, 512, 4096, 11008])
def test_q4_blocks_match_reference(k):
    assert q4_blocks(k) == ref_q4_blocks(k)
    assert ops.fit_bk(k, 512) == q4_blocks(k)[2]


# ----------------------------------------------------- routing and counts --
def test_cpu_tensors_take_plain_path_and_do_not_count():
    K.reset_launch_counts()
    x = torch.from_numpy(RNG.standard_normal((4, 512)).astype(np.float32))
    _, qw = _weights(64, 512)
    want = K.q4_matmul_plain(x, qw, 512)
    for fn in (K.q4_matmul, K.q4_matmul_db):
        torch.testing.assert_close(fn(x, qw, 512), want, rtol=0, atol=0)
    torch.testing.assert_close(ops.q4_matmul(x, qw), want, rtol=0, atol=0)
    assert K.q4_matmul.launches == 0 and K.q4_matmul_db.launches == 0


@pytest.mark.parametrize("double_buffer", [True, False])
@pytest.mark.parametrize("plain", [False, True])
def test_compiled_apply_bf16_equals_the_f32_product_rounded_once(
        double_buffer, plain):
    """A Q4 projection of bf16 activations goes into the Q4 path without a
    cast to float32: on the CPU it gives bitwise what the float32 product
    rounded once to bf16 gave, in x's dtype and shape; float32 x is
    unchanged."""
    from repro_torch.kernels.compiled import CompiledDispatcher
    from repro_torch.kernels.dispatch import HybridKernelDispatcher
    from repro_torch.models.layers import BalancedQuantLinear

    disp = HybridKernelDispatcher.virtual("ultra-125h")
    cd = CompiledDispatcher(disp, double_buffer=double_buffer, device="cpu")
    w = torch.from_numpy(RNG.standard_normal((96, 512)).astype(np.float32))
    layer = BalancedQuantLinear.from_dense(w, disp)
    x = torch.from_numpy(RNG.standard_normal((2, 3, 512)).astype(
        np.float32)).to(torch.bfloat16)
    bk = q4_blocks(512)[2]
    want = K.q4_matmul_plain(x.reshape(6, 512).to(torch.float32), layer.qw,
                             bk).to(torch.bfloat16).reshape(2, 3, 96)
    got = cd.apply(layer, x, isa="membw", kind="attn_proj", plain=plain)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 96)
    assert torch.equal(got, want)
    x32 = x.to(torch.float32)
    got32 = cd.apply(layer, x32, isa="membw", kind="attn_proj", plain=plain)
    assert got32.dtype == torch.float32
    assert torch.equal(got32, K.q4_matmul_plain(
        x32.reshape(6, 512), layer.qw, bk).reshape(2, 3, 96))


def test_wrappers_raise_on_devices_without_a_kernel():
    x = torch.empty((2, 64), device="meta")
    qw = QuantizedLinear(torch.empty((8, 32), dtype=torch.uint8,
                                     device="meta"),
                         torch.empty((8, 2), dtype=torch.float16,
                                     device="meta"))
    for fn in (K.q4_matmul, K.q4_matmul_db):
        with pytest.raises(ValueError, match="no Q4 kernel"):
            fn(x, qw, 64)


@pytest.mark.parametrize("case", ["dtype", "layout", "bk", "shape", "scales"])
def test_kernel_input_checks(case):
    """What the CUDA kernels refuse is refused before any launch."""
    x = torch.zeros((4, 256))
    _, qw = _weights(16, 256)
    bk = 128
    if case == "dtype":
        x = x.to(torch.float16)
    elif case == "layout":
        x = torch.zeros((256, 4)).T
    elif case == "bk":
        bk = 96                     # not 32 * 2**i
    elif case == "shape":
        x = torch.zeros((4, 192))
    elif case == "scales":
        qw = QuantizedLinear(qw.packed, qw.scales.float())
    with pytest.raises(ValueError):
        K._check(x, qw, bk)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No fallback: a kernel that cannot be built raises.  The build helper
    keeps the library's name: lib<source stem>-<hash of the source>.so."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.compile_library(K.SOURCE, tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc"):
        K.compile_library(force=True)


def test_q4_roofline_sees_every_q4_kernel_body():
    """The benchmark's ``q4_roofline`` readers find Q4_0 launches by the
    names ``kernel_names`` reads from the source: one for each
    ``__global__`` declaration, the f32 and the tensor-core body both."""
    from perfbench.harness.view import kernel_names

    declared = re.findall(r"__global__\s", K.SOURCE.read_text())
    names = kernel_names([K.SOURCE])
    assert len(names) == len(declared) >= 2
    assert {"q4_gemv_kernel", "q4_mma_kernel"} <= set(names)


def test_kernel_source_names_what_it_replaces():
    text = K.SOURCE.read_text()
    for needle in ("q4_matmul_pallas", "q4_matmul_pallas_db", "HBM",
                   "cp.async", "__shfl_xor_sync", "sm_90a"):
        assert needle in text
