"""The port's dense transformer against the reference's, on the CPU.

Reduced llama2-7b (``reduced_config``: 2 layers, d_model 64, f32) with the
reference's weights carried across by ``repro_torch.models.convert``.  Both
packages run in float32; the only differences are the order of the f32
sums inside matmuls and softmax (XLA's CPU kernels against PyTorch's), so
the logits agree to about 1e-6 of their scale.  The tolerance below, 2e-5
relative to the largest logit, leaves an order of magnitude of headroom;
a wrong rotation, mask or cache write is off by O(1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels.compiled as port_compiled
from repro.configs import reduced_config as ref_reduced
from repro.kernels.dispatch import HybridKernelDispatcher as RefDisp
from repro.models import BalancedTrunk as RefTrunk
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import init_slot_state as ref_init_slot_state
from repro.models import init_state as ref_init_state
from repro.models.attention import KVCache as RefKV
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.dispatch import HybridKernelDispatcher as PortDisp
from repro_torch.models import BalancedTrunk, forward, init_params
from repro_torch.models import init_slot_state, init_state, params_from_numpy
from repro_torch.models.attention import KVCache

REL_TOL = 2e-5


@pytest.fixture(scope="module")
def model():
    """(reference cfg, port cfg, reference params, port params)."""
    cfg_r, cfg_p = ref_reduced("llama2-7b"), reduced_config("llama2-7b")
    params_r = ref_init_params(cfg_r, jax.random.key(0))
    params_p = params_from_numpy(jax.tree.map(np.asarray, params_r),
                                 device="cpu")
    return cfg_r, cfg_p, params_r, params_p


@pytest.fixture(scope="module")
def trunks(model):
    """Compiled Q4 trunks (with head) over the same weights."""
    cfg_r, cfg_p, params_r, params_p = model
    ref = RefTrunk.from_params(cfg_r, params_r,
                               RefDisp.virtual("ultra-125h", execute=True),
                               quant="q4", mode="compiled")
    port = BalancedTrunk.from_params(cfg_p, params_p,
                                     PortDisp.virtual("ultra-125h"),
                                     quant="q4", device="cpu")
    return ref, port


def _close(got, want, rel=REL_TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max |diff| {err} > {rel} * {scale}"


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape,
                                                dtype=np.int32)


# ------------------------------------------------------------ parameters --
def test_config_is_the_published_llama2_7b():
    cfg = get_config("llama2-7b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab_size) == (32, 4096, 32, 32, 11008, 32000)
    assert cfg.cdtype == torch.bfloat16
    assert reduced_config("llama2-7b").cdtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_shapes_and_distributions_match(model, dtype):
    """The port's own init: the reference's tree, shapes and dtypes; normal
    weights at std d_in**-0.5 (embedding 0.02), norms at 1.  The numbers
    differ (jax.random is not reproducible in torch), so the spread is
    held to 10% of its target on the larger leaves."""
    cfg_r = dataclasses.replace(model[0], dtype=dtype)
    cfg_p = dataclasses.replace(model[1], dtype=dtype)
    ref = jax.tree.map(np.asarray, ref_init_params(cfg_r, jax.random.key(1)))
    port = init_params(cfg_p, torch.Generator().manual_seed(1), device="cpu")
    ref_leaves, ref_def = jax.tree.flatten(ref)
    port_leaves, port_def = jax.tree.flatten(
        jax.tree.map(lambda t: t, port,
                     is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert ref_def == port_def
    for path, r in jax.tree_util.tree_flatten_with_path(ref)[0]:
        p = port
        for key in path:
            p = p[key.key if hasattr(key, "key") else key.idx]
        assert tuple(p.shape) == r.shape, path
        assert str(p.dtype).replace("torch.", "") == r.dtype.name, path
        name = jax.tree_util.keystr(path)
        pf = p.float().numpy()
        if "norm" in name:
            np.testing.assert_array_equal(pf, 1.0)
            continue
        want = 0.02 if "tok" in name else r.shape[-2] ** -0.5
        assert abs(float(pf.mean())) < 0.1 * want
        assert abs(float(pf.std()) / want - 1.0) < 0.1, (name, pf.std(), want)


def test_convert_carries_bf16_bit_for_bit():
    w = jax.random.normal(jax.random.key(2), (8, 16)).astype(jnp.bfloat16)
    tree = {"period": [{"w": np.asarray(w)}], "n": np.arange(3)}
    out = params_from_numpy(tree, device="cpu")
    assert out["period"][0]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out["period"][0]["w"].view(torch.int16).numpy(),
        np.asarray(w).view(np.int16))
    np.testing.assert_array_equal(out["n"].numpy(), np.arange(3))


# --------------------------------------------------------------- forward --
def test_forward_logits_match_without_trunk(model):
    cfg_r, cfg_p, params_r, params_p = model
    tok = _tokens(cfg_p, (2, 24), 0)   # 24 > attn_chunk: the chunk branch
    want = ref_forward(cfg_r, params_r, jnp.asarray(tok)).logits
    got = forward(cfg_p, params_p, torch.from_numpy(tok)).logits
    _close(got, want)


def test_forward_logits_match_with_compiled_q4_trunk(model, trunks):
    """Every projection and the head through the compiled Q4 lowering (the
    port's plain kernel version on the CPU, the reference's Pallas kernel
    in interpret mode)."""
    cfg_r, cfg_p, params_r, params_p = model
    ref_trunk, port_trunk = trunks
    tok = _tokens(cfg_p, (2, 5), 1)
    offs_r, offs_p = ref_trunk.compiled_refresh(), port_trunk.compiled_refresh()
    out = []
    for fwd, cfg, params, trunk, offs, t in (
            (ref_forward, cfg_r, params_r, ref_trunk, offs_r, jnp.asarray(tok)),
            (forward, cfg_p, params_p, port_trunk, offs_p,
             torch.from_numpy(tok))):
        fo = fwd(cfg, params, t, apply_head=False, trunk=trunk,
                 trunk_isa="avx_vnni", trunk_offsets=offs)
        out.append(trunk.apply_head(fo.logits, isa="avx_vnni", offsets=offs))
    _close(out[1], out[0])
    # the Q4 trunk really is in the path: it moves the logits off the
    # dense forward's
    dense = forward(cfg_p, params_p, torch.from_numpy(tok)).logits
    assert float((dense - out[1]).abs().max()) > 1e-3


@pytest.mark.parametrize("use_trunk", [False, True])
def test_prefill_then_decode_with_cache(model, trunks, use_trunk):
    """A 6-token prefill then two decode steps on a batch-1 cache: logits
    and the caches (k, v, idx) match the reference's."""
    cfg_r, cfg_p, params_r, params_p = model
    ref_trunk, port_trunk = trunks if use_trunk else (None, None)
    prompt = _tokens(cfg_p, (1, 6), 2)
    steps = [(prompt, 0, "last", "avx_vnni"),
             (_tokens(cfg_p, (1, 1), 3), 6, "all", "membw"),
             (_tokens(cfg_p, (1, 1), 4), 7, "all", "membw")]
    st_r = ref_init_state(cfg_r, 1, 16)
    st_p = init_state(cfg_p, 1, 16, device="cpu")
    for tok, pos, mode, isa in steps:
        kw_r, kw_p = {}, {}
        if use_trunk:
            kw_r = dict(trunk=ref_trunk, trunk_isa=isa,
                        trunk_offsets=ref_trunk.compiled_refresh())
            kw_p = dict(trunk=port_trunk, trunk_isa=isa,
                        trunk_offsets=port_trunk.compiled_refresh())
        fr = ref_forward(cfg_r, params_r, jnp.asarray(tok), state=st_r,
                         pos_offset=pos, logits_mode=mode, **kw_r)
        fp = forward(cfg_p, params_p, torch.from_numpy(tok), state=st_p,
                     pos_offset=pos, logits_mode=mode, **kw_p)
        _close(fp.logits[:, -1], fr.logits[:, -1])
        st_r, st_p = fr.state, fp.state
    for cr, cp in zip(st_r, st_p):
        np.testing.assert_array_equal(np.asarray(cr.idx), cp.idx.numpy())
        _close(cp.k, cr.k)
        _close(cp.v, cr.v)


def test_free_slot_idx_drift_past_max_seq(model):
    """Slot-batched decode where row 1 is a free slot whose idx has drifted
    past max_seq: the write start clamps to S_max - 1 as
    jax.lax.dynamic_update_slice clamps it, kv_len stays unclamped, and
    the live row 0 is unaffected."""
    cfg_r, cfg_p, params_r, params_p = model
    n_slots, max_seq = 2, 8
    ref_state = ref_init_slot_state(cfg_r, n_slots, max_seq)
    rng = np.random.default_rng(5)
    idx = np.array([3, max_seq + 3], dtype=np.int32)
    states_r, states_p = [], []
    for c in ref_state:
        k = rng.standard_normal(c.k.shape).astype(np.float32)
        v = rng.standard_normal(c.v.shape).astype(np.float32)
        ix = np.broadcast_to(idx, c.idx.shape).copy()
        states_r.append(RefKV(k=jnp.asarray(k), v=jnp.asarray(v),
                              idx=jnp.asarray(ix)))
        states_p.append(KVCache(k=torch.from_numpy(k.copy()),
                                v=torch.from_numpy(v.copy()),
                                idx=torch.from_numpy(ix)))
    assert [tuple(c.k.shape) for c in init_slot_state(
        cfg_p, n_slots, max_seq, device="cpu")] == \
        [c.k.shape for c in ref_state]
    tok = _tokens(cfg_p, (n_slots, 1), 6)
    fr = ref_forward(cfg_r, params_r, jnp.asarray(tok), state=states_r,
                     pos_offset=jnp.asarray(idx))
    fp = forward(cfg_p, params_p, torch.from_numpy(tok), state=states_p,
                 pos_offset=torch.from_numpy(idx))
    _close(fp.logits, fr.logits)
    for cr, cp in zip(fr.state, fp.state):
        np.testing.assert_array_equal(np.asarray(cr.idx), cp.idx.numpy())
        assert int(cp.idx[0, 1]) == max_seq + 4          # unclamped
        _close(cp.k, cr.k)
        _close(cp.v, cr.v)


# ------------------------------------------------ order of sums at depth --
def test_order_of_sums_drift_at_depth():
    """How far two orders of the f32 sums inside the Q4 projections move
    the logits of a 32-layer bf16 model: the plain path at the compiled
    K tile against the same path at half that tile.  The bf16 activations
    between layers turn sum-order differences of ~1e-7 into 2**-8 flips,
    and 32 layers carry them to the logits.  chip_smoke.py holds the CUDA
    kernel path against the plain path at full width within 5e-2 of the
    logits' scale; this drift has to stay under half of that."""
    cfg = dataclasses.replace(get_config("llama2-7b"), d_model=128,
                              n_heads=2, n_kv_heads=2, d_ff=256,
                              vocab_size=1024)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    trunk = BalancedTrunk.from_params(cfg, params,
                                      PortDisp.virtual("ultra-125h"),
                                      device="cpu")
    offs = trunk.compiled_refresh()
    prompt = torch.from_numpy(_tokens(cfg, (1, 8), 7))
    nxt = torch.from_numpy(_tokens(cfg, (1, 1), 8))
    orig = port_compiled.q4_blocks

    def run(div):
        port_compiled.q4_blocks = lambda k: (*orig(k)[:2], orig(k)[2] // div)
        try:
            st, outs = init_state(cfg, 1, 16, device="cpu"), []
            for tok, pos, isa, mode in ((prompt, 0, "avx_vnni", "last"),
                                        (nxt, 8, "membw", "all")):
                fo = forward(cfg, params, tok, state=st, pos_offset=pos,
                             logits_mode=mode, apply_head=False, trunk=trunk,
                             trunk_isa=isa, trunk_offsets=offs, plain=True)
                st = fo.state
                outs.append(trunk.apply_head(fo.logits[:, -1], isa=isa,
                                             offsets=offs, plain=True).float())
            return outs
        finally:
            port_compiled.q4_blocks = orig

    base, half = run(1), run(2)
    for a, b in zip(base, half):
        rel = float((a - b).abs().max() / b.abs().max())
        assert 0.0 < rel < 2.5e-2, rel
        assert torch.isfinite(a).all()


# ---------------------------------------------------- what is not ported --
def test_direct_kernel_lowering_equals_double_buffered(model):
    """``double_buffer=False`` lowers onto the direct kernel through the
    ``ops`` front end, at the same pinned ``bk``: the same numbers."""
    cfg_p, params_p = model[1], model[3]
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (3, cfg_p.d_model)).astype(np.float32))
    outs = []
    for db in (True, False):
        trunk = BalancedTrunk.from_params(cfg_p, params_p,
                                          PortDisp.virtual("ultra-125h"),
                                          double_buffer=db, device="cpu")
        offs = trunk.compiled_refresh()
        proj = trunk.projector(0, 1, "attn", "membw", offsets=offs)
        outs.append((proj("wq", x, None),
                     trunk.apply_head(x, isa="membw", offsets=offs)))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["bridge", "topology", "arch",
                                  "no_card"])
def test_unported_paths_raise(model, case, monkeypatch):
    cfg_p, params_p = model[1], model[3]
    disp = PortDisp.virtual("ultra-125h")
    from repro_torch.serving import ContinuousBatchingEngine

    calls = {
        "bridge": (ValueError, lambda: BalancedTrunk.from_params(
            cfg_p, params_p, disp, mode="bridge", device="cpu")),
        # the reference's error: topology= needs a topology trunk
        "topology": (ValueError, lambda: ContinuousBatchingEngine(
            cfg_p, params_p, max_slots=2, max_seq=16, topology="dual-125h",
            device="cpu")),
        "arch": (KeyError, lambda: get_config("granite-8b")),
        "no_card": (RuntimeError, lambda: init_params(
            cfg_p, torch.Generator(), device="cuda")),
    }
    if case == "no_card":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    exc, call = calls[case]
    with pytest.raises(exc):
        call()
