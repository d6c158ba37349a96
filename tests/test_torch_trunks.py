"""The balanced trunk's three weight paths (Q4_0, int8, fp32) and its two
modes (compiled, eager) against the reference and against each other, on
the CPU.

Reduced llama2-7b (f32) with the reference's weights carried across.  On
the CPU the port's kernel wrappers take their plain torch version; the
reference's Pallas kernels run in interpret mode.  Tolerances:

* port against reference, Q4: the reference's kernel tolerance (rtol 2e-5,
  atol 2e-5 * K; the order of the f32 sums differs);
* port against reference, int8: accumulators exact, outputs within rtol
  1e-6 (the dequant's multiply-subtract may be fused by XLA);
* port against reference, fp32: within 1e-6 of the output's scale (two
  BLAS libraries sum in two orders);
* eager against compiled within the port: bitwise for Q4 (the same ``bk``)
  and int8 (exact sums); fp32 within 1e-6 of the scale, since a row shard
  of a matmul may be summed in another order than the whole product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced
from repro.kernels import int8_gemm as ref_int8_gemm
from repro.kernels.dispatch import HybridKernelDispatcher as RefDisp
from repro.models import BalancedTrunk as RefTrunk
from repro.models import init_params as ref_init_params
from repro.quant.int8 import quantize_u8_dynamic as ref_quantize_u8
from repro_torch.analysis import invariants
from repro_torch.configs import reduced_config
from repro_torch.kernels import ops
from repro_torch.kernels.dispatch import GEMM_ISA, GEMV_ISA
from repro_torch.kernels.dispatch import HybridKernelDispatcher as PortDisp
from repro_torch.models import (
    BalancedFp32Linear,
    BalancedLinear,
    BalancedQuantLinear,
    BalancedTrunk,
    params_from_numpy,
)
from repro_torch.quant.int8 import quantize_u8_dynamic

# the paper trunk's 7 projection kinds (4 attn + 3 SwiGLU MLP); the head
# is checked beside them
PROJECTIONS = [("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
               ("attn", "wo"), ("ffn", "wi"), ("ffn", "wg"), ("ffn", "wo")]
QUANTS = ("q4", "int8", "fp32")
LAYER_CLS = {"q4": BalancedQuantLinear, "int8": BalancedLinear,
             "fp32": BalancedFp32Linear}


@pytest.fixture(scope="module")
def model():
    cfg_r, cfg_p = ref_reduced("llama2-7b"), reduced_config("llama2-7b")
    params_r = ref_init_params(cfg_r, jax.random.key(0))
    params_p = params_from_numpy(jax.tree.map(np.asarray, params_r),
                                 device="cpu")
    return cfg_r, cfg_p, params_r, params_p


def _inputs(cfg, m=3, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, cfg.d_model)).astype(np.float32),
            rng.standard_normal((m, cfg.d_ff)).astype(np.float32))


def _outputs(trunk, x, xff, isa=GEMV_ISA, offsets=None, as_torch=True):
    """Every projection kind of period position 0, repeat 1, and the
    head, on x (and on the d_ff-wide input for the down projection)."""
    conv = torch.from_numpy if as_torch else jnp.asarray
    kw = {"offsets": offsets} if offsets is not None else {}
    outs = {}
    for group, name in PROJECTIONS:
        proj = trunk.projector(0, 1, group, isa, **kw)
        xin = xff if (group, name) == ("ffn", "wo") else x
        outs[(group, name)] = np.asarray(proj(name, conv(xin), None))
    outs["head"] = np.asarray(trunk.apply_head(conv(x), isa=isa, **kw))
    return outs


def _close(got, want, rel):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max |diff| {err} > {rel} * {scale}"


# ------------------------------------------------------------ construction --
@pytest.mark.parametrize("quant", QUANTS)
def test_from_params_banks_every_projection(model, quant):
    cfg_p, params_p = model[1], model[3]
    for mode in ("compiled", "eager"):
        trunk = BalancedTrunk.from_params(cfg_p, params_p,
                                          PortDisp.virtual("ultra-125h"),
                                          quant=quant, mode=mode,
                                          device="cpu")
        assert trunk.mode == mode and trunk.quant == quant
        assert len(trunk.bank) == len(PROJECTIONS)
        layers = [l for ls in trunk.bank.values() for l in ls]
        assert len(layers) == len(PROJECTIONS) * cfg_p.n_layers
        assert all(type(l) is LAYER_CLS[quant] for l in layers)
        assert type(trunk.head) is LAYER_CLS[quant]
        assert trunk.head.out_features == cfg_p.vocab_size


# -------------------------------------------- compiled lowering vs reference --
@pytest.mark.parametrize("quant", QUANTS)
def test_compiled_projections_match_reference(model, quant):
    """All 7 projection kinds and the head through the port's compiled
    lowering against the reference's compiled lowering, on the same
    weights and inputs."""
    cfg_r, cfg_p, params_r, params_p = model
    ref = RefTrunk.from_params(cfg_r, params_r,
                               RefDisp.virtual("ultra-125h", execute=True),
                               quant=quant, mode="compiled")
    port = BalancedTrunk.from_params(cfg_p, params_p,
                                     PortDisp.virtual("ultra-125h"),
                                     quant=quant, device="cpu")
    x, xff = _inputs(cfg_p)
    want = _outputs(ref, x, xff, offsets=ref.compiled_refresh(),
                    as_torch=False)
    got = _outputs(port, x, xff, offsets=port.compiled_refresh())
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape and g.dtype == np.float32, key
        if quant == "q4":
            k = cfg_p.d_ff if key == ("ffn", "wo") else cfg_p.d_model
            np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5 * k)
        elif quant == "int8":
            np.testing.assert_allclose(g, w, rtol=1e-6)
        else:
            _close(g, w, 1e-6)


def test_compiled_int8_accumulators_exact(model):
    """The s32 sums under every int8 projection: the reference's Pallas
    kernel (interpret mode) on the reference's quantized activations and
    weights, against the port's front end on its own — bit for bit."""
    cfg_r, cfg_p, params_r, params_p = model
    ref = RefTrunk.from_params(cfg_r, params_r,
                               RefDisp.virtual("ultra-125h", execute=True),
                               quant="int8", mode="compiled")
    port = BalancedTrunk.from_params(cfg_p, params_p,
                                     PortDisp.virtual("ultra-125h"),
                                     quant="int8", device="cpu")
    x, xff = _inputs(cfg_p, m=4, seed=2)
    for group, name in [*PROJECTIONS, ("head", None)]:
        lr = ref.head if group == "head" else ref.bank[(0, group, name)][1]
        lp = port.head if group == "head" else port.bank[(0, group, name)][1]
        xin = xff if (group, name) == ("ffn", "wo") else x
        qa_r = ref_quantize_u8(jnp.asarray(xin))
        qa_p = quantize_u8_dynamic(torch.from_numpy(xin))
        np.testing.assert_array_equal(np.asarray(lr.w.q), lp.w.q.numpy())
        np.testing.assert_array_equal(np.asarray(qa_r.q), qa_p.q.numpy())
        want = np.asarray(ref_int8_gemm(qa_r.q, lr.w.q, interpret=True))
        np.testing.assert_array_equal(ops.int8_gemm(qa_p.q, lp.w.q).numpy(),
                                      want)


@pytest.mark.parametrize("quant", QUANTS)
def test_compiled_cost_tape_feeds_the_ratio_tables(model, quant):
    """Every compiled projection goes to the cost tape, and the feedback
    replays it into the dispatcher's tables with the reference's work and
    bytes model (the same tables and bandwidth accounting as the
    reference's replay of the same records)."""
    cfg_r, cfg_p, params_r, params_p = model
    disp_r = RefDisp.virtual("ultra-125h", execute=True)
    disp_p = PortDisp.virtual("ultra-125h")
    ref = RefTrunk.from_params(cfg_r, params_r, disp_r, quant=quant,
                               mode="compiled")
    port = BalancedTrunk.from_params(cfg_p, params_p, disp_p, quant=quant,
                                     device="cpu")
    x, xff = _inputs(cfg_p)
    for trunk, as_torch in ((ref, False), (port, True)):
        for isa in (GEMV_ISA, GEMM_ISA):
            offs = trunk.compiled_refresh()
            tape = trunk.compiled_tape_begin()
            _outputs(trunk, x, xff, isa=isa, offsets=offs, as_torch=as_torch)
            recs = trunk.compiled_tape_end(tape)
            assert len(recs) == len(PROJECTIONS) + 1
            trunk.compiled_feedback(jax.device_get(recs) if not as_torch
                                    else recs)
    assert sorted(disp_r.table.keys()) == sorted(disp_p.table.keys())
    for key in disp_r.table.keys():
        np.testing.assert_array_equal(disp_r.table.ratios(key),
                                      disp_p.table.ratios(key))
    for isa in (GEMV_ISA, GEMM_ISA):
        assert (disp_r.achieved_bandwidth(isa)
                == disp_p.achieved_bandwidth(isa) > 0)


# ------------------------------------------------ eager against compiled --
def _pair(model, quant, disp=None):
    cfg_p, params_p = model[1], model[3]
    disp = disp or PortDisp.virtual("ultra-125h", execute=True)
    eager = BalancedTrunk.from_params(cfg_p, params_p, disp, quant=quant,
                                      mode="eager", device="cpu")
    compiled = BalancedTrunk.from_params(cfg_p, params_p, disp,
                                         quant=quant, device="cpu")
    return disp, eager, compiled


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("m", [1, 4, 8])
def test_eager_shards_match_compiled(model, quant, m):
    """Per-core shards of the real kernel against the compiled lowering's
    one launch over the whole output, for every projection kind and the
    head."""
    disp, eager, compiled = _pair(model, quant)
    x, xff = _inputs(model[1], m=m, seed=m)
    a = _outputs(eager, x, xff)
    b = _outputs(compiled, x, xff, offsets=compiled.compiled_refresh())
    for key in b:
        if quant == "fp32":
            _close(a[key], b[key], 1e-6)
        else:
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("quant", QUANTS)
def test_eager_dispatch_feeds_back_per_call(model, quant):
    """An eager projection plans, runs and reports when it is called: the
    kind's table key moves off its even start and the bytes it streamed
    are accounted (the weight's bytes per row times N)."""
    disp, eager, _ = _pair(model, quant)
    cfg = model[1]
    x, _ = _inputs(cfg, m=2)
    layer = eager.bank[(0, "attn", "wq")][0]
    proj = eager.projector(0, 0, "attn", GEMV_ISA)
    for _ in range(3):
        proj("wq", torch.from_numpy(x), None)
    ratios = disp.table.ratios("membw/attn_proj")
    assert ratios.max() / ratios.min() > 1.05
    per_row = {"q4": 0.5625, "int8": 1.0, "fp32": 4.0}[quant] * cfg.d_model
    assert disp._bytes[GEMV_ISA] == 3 * layer.out_features * per_row


@pytest.mark.parametrize("quant", QUANTS)
def test_zero_width_shards_stay_legal(model, quant):
    """Parking half the workers re-plans to zero-width shards: the eager
    trunk skips them (no launch, no write) and still fills every output
    column; the compiled snapshot keeps fixed-width boundary tensors with
    equal adjacent entries.  Both equal the dense split's outputs (eager
    fp32 within its tolerance)."""
    disp, eager, compiled = _pair(model, quant)
    x, xff = _inputs(model[1])
    dense = _outputs(compiled, x, xff, offsets=compiled.compiled_refresh())
    dense_eager = _outputs(eager, x, xff)
    n = disp.n_workers
    for c in range(n // 2, n):
        disp.set_active(c, False)
    masked = compiled.compiled_refresh()
    snap = compiled._compiled().snapshot
    for name in snap.names:
        b = snap.boundaries(name)
        assert b.shape == (n + 1,)
        counts = snap.counts(name)
        assert (counts[n // 2:] == 0).all()
        assert counts.sum() == snap.spec(name).total
        with invariants.contracts():
            invariants.check_offset_boundaries(b, snap.spec(name).total)
    got_c = _outputs(compiled, x, xff, offsets=masked)
    got_e = _outputs(eager, x, xff)
    head = disp.last_stats                  # the eager head's region
    assert head.counts.sum() == model[1].vocab_size
    assert (head.counts[n // 2:] == 0).all()
    for key in dense:
        np.testing.assert_array_equal(got_c[key], dense[key])
        if quant == "fp32":
            _close(got_e[key], dense[key], 1e-6)
        else:
            np.testing.assert_array_equal(got_e[key], dense_eager[key])


def test_eager_call_needs_an_executing_dispatcher(model):
    """A virtual dispatcher built without ``execute=True`` runs no shard
    function, so an eager call refuses instead of returning garbage."""
    disp = PortDisp.virtual("ultra-125h")
    _, eager, _ = _pair(model, "int8", disp=disp)
    x, _ = _inputs(model[1])
    with pytest.raises(ValueError, match="execute=True"):
        eager.apply_head(torch.from_numpy(x), isa=GEMV_ISA)


def test_eager_mode_has_no_compiled_state(model):
    _, eager, _ = _pair(model, "q4")
    with pytest.raises(ValueError, match="not 'compiled'"):
        eager.compiled_refresh()
    with pytest.raises(ValueError, match="plain"):
        eager.projector(0, 0, "attn", GEMV_ISA, plain=True)
