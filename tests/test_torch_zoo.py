"""The port's model zoo (the attention families) against the reference's, on
the CPU.

The registry and every configuration, the norms and the tanh GeLU, the
MoE layer (routing, drops and expert placement), the modality stubs and
``forward`` — logits, prefill and one decode step — of the eight
attention-family architectures at ``reduced_config`` size (f32), with the
reference's weights carried across by ``repro_torch.models.convert`` and
the same numpy inputs fed to both packages.  As in
``tests/test_torch_model.py`` the packages differ only in the order of
their f32 sums (XLA's CPU kernels against PyTorch's): logits are held to
2e-5 of their scale, the MoE output to rtol = atol = 1e-5, and routing
(the chosen experts, the expert loads, the dropped share) exactly.  The
recurrent mixers (mamba, mLSTM, sLSTM) and their architectures (jamba,
xlstm) are held in ``tests/test_torch_recurrent.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import init_state as ref_init_state
from repro.models import layers as ref_layers
from repro.models import modality as ref_modality
from repro.models import moe as ref_moe
from repro.kernels.dispatch import HybridKernelDispatcher as RefDisp
from repro.models import BalancedTrunk as RefTrunk
import repro_torch.configs as port_configs
from repro_torch.kernels.dispatch import HybridKernelDispatcher as PortDisp
from repro_torch.models import (BalancedTrunk, forward, init_params,
                                init_state, params_from_numpy)
from repro_torch.models import layers as port_layers
from repro_torch.models import modality as port_modality
from repro_torch.models import moe as port_moe

REL_TOL = 2e-5
MOE_TOL = 1e-5
ALL_ARCHS = ref_configs.ARCHS + ref_configs.EXTRA_ARCHS
RECURRENT = ("jamba-1.5-large-398b", "xlstm-1.3b")
ATTENTION = tuple(a for a in ref_configs.ARCHS if a not in RECURRENT)
MOE_ARCHS = ("granite-moe-1b-a400m", "llama4-maverick-400b-a17b")
# launches per trunk call of the full configs: q/k/v/o of every attention
# layer, the banked MLP projections of each dense layer (3 SwiGLU, 2 GeLU;
# an MoE layer's experts and the recurrent mixers run plain), and the head
LAUNCHES = {"granite-8b": 253, "chatglm3-6b": 197, "starcoder2-15b": 241,
            "olmo-1b": 113, "granite-moe-1b-a400m": 97,
            "internvl2-26b": 337, "musicgen-medium": 289,
            "llama4-maverick-400b-a17b": 48 // 2 * 11 + 1, "llama2-7b": 225,
            "jamba-1.5-large-398b": 145,
            "xlstm-1.3b": 1}


def _close(got, want, rel=REL_TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max |diff| {err} > {rel} * {scale}"


class _Models(dict):
    """arch -> (reference cfg, port cfg, reference params, port params),
    each made on first use."""

    def __missing__(self, arch):
        cfg_r, cfg_p = (ref_configs.reduced_config(arch),
                        port_configs.reduced_config(arch))
        params_r = ref_init_params(cfg_r, jax.random.key(0))
        params_p = params_from_numpy(jax.tree.map(np.asarray, params_r),
                                     device="cpu")
        self[arch] = cfg_r, cfg_p, params_r, params_p
        return self[arch]


@pytest.fixture(scope="module")
def models():
    return _Models()


def _inputs(cfg, b, s, seed):
    """(reference kwargs, port kwargs) of one call on the same numpy
    inputs: tokens, or frame embeddings for an embed-input arch, plus the
    patch-embedding prefix where the arch has one."""
    rng = np.random.default_rng(seed)
    kw_r, kw_p = {}, {}
    if cfg.embed_input:
        e = (rng.standard_normal((b, s, cfg.d_model)) * 0.02).astype(np.float32)
        kw_r["embeds"], kw_p["embeds"] = jnp.asarray(e), torch.from_numpy(e)
        tok = None
    else:
        tok = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    if cfg.n_prefix:
        e = (rng.standard_normal((b, cfg.n_prefix, cfg.d_model))
             * 0.02).astype(np.float32)
        kw_r["prefix_embeds"] = jnp.asarray(e)
        kw_p["prefix_embeds"] = torch.from_numpy(e)
    return ((None if tok is None else jnp.asarray(tok), kw_r),
            (None if tok is None else torch.from_numpy(tok), kw_p))


# ------------------------------------------------------------- registry --
def test_registry_equals_the_references():
    assert port_configs.ARCHS == ref_configs.ARCHS
    assert port_configs.EXTRA_ARCHS == ref_configs.EXTRA_ARCHS
    assert {k: dataclasses.astuple(v) for k, v in port_configs.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in ref_configs.SHAPES.items()}
    for skipped in (False, True):
        assert list(port_configs.cells(skipped)) == \
            list(ref_configs.cells(skipped))
    assert len(list(port_configs.cells(True))) == 40
    with pytest.raises(KeyError):
        port_configs.get_config("gpt-2")


def _config_facts(mod, cfg):
    return {"fields": dataclasses.asdict(cfg), "period": cfg.period(),
            "plan": cfg.layer_plan(), "n_periods": cfg.n_periods,
            "param_count": cfg.param_count(),
            "active": cfg.active_param_count(), "hd": cfg.hd,
            "long_500k": mod.shape_supported(cfg, "long_500k")}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_config_and_reduced_config_equal_the_references(arch):
    """Every field, the layer plan and period, and both parameter counts,
    of the published configuration and of its reduced shrink."""
    for make in ("get_config", "reduced_config"):
        want = _config_facts(ref_configs,
                             getattr(ref_configs, make)(arch))
        got = _config_facts(port_configs,
                            getattr(port_configs, make)(arch))
        assert got == want, make
    assert port_configs.reduced_config(arch).cdtype == torch.float32
    assert port_configs.get_config(arch).cdtype == torch.bfloat16


def test_launches_per_trunk_call_of_the_full_configs():
    """The kernel launches of one compiled trunk call at full size, from
    the banking rule (q/k/v/o per attention layer, none for a recurrent
    mixer, 3 or 2 banked MLP projections per dense layer, none for an MoE
    layer, one head)."""
    def rule(cfg):
        mlp = 3 if cfg.mlp == "swiglu" else 2
        return 1 + sum((4 if mixer == "attn" else 0)
                       + (mlp if ffn == "dense" else 0)
                       for mixer, ffn in cfg.layer_plan())

    assert {a: rule(port_configs.get_config(a)) for a in LAUNCHES} \
        == LAUNCHES


# ---------------------------------------------------------------- layers --
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_norms_equal_the_references(norm):
    cfg = dataclasses.replace(ref_configs.reduced_config("granite-8b"),
                              norm=norm)
    cfg_p = dataclasses.replace(port_configs.reduced_config("granite-8b"),
                                norm=norm)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 5, cfg.d_model)) * 3 + 1).astype(np.float32)
    p = {k: (rng.standard_normal(v.shape) + 1).astype(np.float32)
         for k, v in jax.tree.map(np.asarray,
                                  ref_layers._norm_init(cfg, None)).items()}
    assert sorted(p) == sorted(port_layers._norm_init(cfg_p, "cpu"))
    want = ref_layers.norm_fwd(cfg, jax.tree.map(jnp.asarray, p),
                               jnp.asarray(x))
    got = port_layers.norm_fwd(cfg_p, {k: torch.from_numpy(v)
                                       for k, v in p.items()},
                               torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # bf16 in, bf16 out: the norm is computed in float32 either way
    got16 = port_layers.norm_fwd(cfg_p, {k: torch.from_numpy(v)
                                         for k, v in p.items()},
                                 torch.from_numpy(x).to(torch.bfloat16))
    assert got16.dtype == torch.bfloat16


def test_gelu_mlp_is_the_tanh_approximation():
    """``jax.nn.gelu`` is the tanh approximation by default; the port's
    GeLU MLP must be too (``F.gelu``'s default, the erf form, differs by
    ~1e-4 here, far above the f32 tolerance)."""
    cfg = ref_configs.reduced_config("starcoder2-15b")
    cfg_p = port_configs.reduced_config("starcoder2-15b")
    p_r = ref_layers.init_mlp(cfg, jax.random.key(3))
    assert sorted(p_r) == ["wi", "wo"]
    p_p = {k: torch.from_numpy(np.array(v)) for k, v in p_r.items()}
    x = np.random.default_rng(2).standard_normal((3, cfg.d_model)).astype(
        np.float32) * 2
    want = np.asarray(ref_layers.mlp_fwd(cfg, p_r, jnp.asarray(x)))
    got = port_layers.mlp_fwd(cfg_p, p_p, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    erf = (torch.nn.functional.gelu(torch.from_numpy(x) @ p_p["wi"])
           @ p_p["wo"]).numpy()
    assert np.abs(erf - want).max() > 1e-4


# ------------------------------------------------------------------- MoE --
def _moe_case(arch, t, seed):
    """One MoE layer of the reduced arch (the reference's init) and an
    (1, t, d) input."""
    cfg_r = ref_configs.reduced_config(arch)
    cfg_p = port_configs.reduced_config(arch)
    p_r = ref_moe.init_moe(cfg_r, jax.random.key(seed))
    p_p = params_from_numpy(jax.tree.map(np.asarray, p_r), device="cpu")
    x = np.random.default_rng(seed).standard_normal(
        (1, t, cfg_r.d_model)).astype(np.float32)
    return cfg_r, cfg_p, p_r, p_p, x


def _ref_top_e(cfg, p, x):
    """The reference's routing: top-k of the router's softmax."""
    xf = jnp.asarray(x).reshape(-1, cfg.d_model)
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ p["router"], axis=-1)
    return np.asarray(jax.lax.top_k(probs, cfg.moe.top_k)[1])


def _moe_equal(cfg_r, cfg_p, p_r, p_p, x, capacity=None):
    y_r, aux_r = ref_moe.moe_fwd(cfg_r, p_r, jnp.asarray(x), capacity)
    y_p, aux_p = port_moe.moe_fwd(cfg_p, p_p, torch.from_numpy(x), capacity)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), rtol=MOE_TOL,
                               atol=MOE_TOL)
    np.testing.assert_array_equal(aux_p["top_e"].numpy(),
                                  _ref_top_e(cfg_r, p_r, x))
    np.testing.assert_array_equal(aux_p["load"].numpy(),
                                  np.asarray(aux_r["load"]))
    assert float(aux_p["dropped"]) == float(aux_r["dropped"])
    np.testing.assert_allclose(float(aux_p["lb_loss"]),
                               float(aux_r["lb_loss"]), rtol=1e-6)
    return aux_p


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_fwd_equals_the_references(arch):
    """granite-moe (top-8 of 8 experts) and llama4 (top-1 of 8, with the
    shared expert) at the default capacity."""
    cfg_r, cfg_p, p_r, p_p, x = _moe_case(arch, 24, 4)
    assert ("swi" in p_p) == (arch == MOE_ARCHS[1])
    _moe_equal(cfg_r, cfg_p, p_r, p_p, x)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_capacity_that_drops_tokens(arch):
    """A capacity of 8 for 80 tokens (at most 64 of the 80 or 640
    assignments fit): those past each expert's 8th drop, the same ones in
    both packages."""
    cfg_r, cfg_p, p_r, p_p, x = _moe_case(arch, 80, 5)
    aux = _moe_equal(cfg_r, cfg_p, p_r, p_p, x, capacity=8)
    assert float(aux["dropped"]) >= 0.2


def test_moe_default_capacity_equals_the_references():
    for arch in MOE_ARCHS:
        for full in (True, False):
            get = "get_config" if full else "reduced_config"
            cfg_r = getattr(ref_configs, get)(arch)
            cfg_p = getattr(port_configs, get)(arch)
            for t in (1, 4, 7, 32, 64, 100, 4096):
                assert port_moe.default_capacity(cfg_p, t) == \
                    ref_moe.default_capacity(cfg_r, t), (arch, full, t)


def test_moe_expert_permutation_invariant():
    """A permutation of the experts (and the router's columns) leaves the
    output as it is, and permutes the parameters as the reference's."""
    cfg_r, cfg_p, p_r, p_p, x = _moe_case(MOE_ARCHS[1], 16, 6)
    perm = np.random.default_rng(0).permutation(cfg_p.moe.n_experts)
    q_r = ref_moe.apply_expert_permutation(p_r, perm)
    q_p = port_moe.apply_expert_permutation(p_p, perm)
    for name in ("router", "wi", "wg", "wo"):
        np.testing.assert_array_equal(q_p[name].numpy(), np.asarray(q_r[name]))
    y0, _ = port_moe.moe_fwd(cfg_p, p_p, torch.from_numpy(x))
    y1, _ = port_moe.moe_fwd(cfg_p, q_p, torch.from_numpy(x))
    torch.testing.assert_close(y1, y0, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_balanced_expert_assignment_equals_the_references(n_shards):
    rng = np.random.default_rng(n_shards)
    for load in (rng.exponential(size=8), rng.integers(0, 5, 16),
                 np.ones(32)):
        want = ref_moe.balanced_expert_assignment(load, n_shards)
        got = port_moe.balanced_expert_assignment(load, n_shards)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        port_moe.balanced_expert_assignment(np.ones(6), 4)


# -------------------------------------------------------------- modality --
def test_modality_specs_and_stubs():
    for arch, spec, args in (("internvl2-26b", "vlm_prefix_spec", (2,)),
                             ("musicgen-medium", "audio_frame_spec", (2, 5))):
        for make in ("get_config", "reduced_config"):
            cfg_r = getattr(ref_configs, make)(arch)
            cfg_p = getattr(port_configs, make)(arch)
            want = getattr(ref_modality, spec)(cfg_r, *args)
            got = getattr(port_modality, spec)(cfg_p, *args)
            assert tuple(got.shape) == tuple(want.shape)
            assert str(got.dtype).replace("torch.", "") == \
                jnp.dtype(want.dtype).name
    cfg = port_configs.reduced_config("internvl2-26b")
    gen = torch.Generator().manual_seed(3)
    a = port_modality.vlm_prefix_stub(cfg, 3, gen, device="cpu")
    b = port_modality.vlm_prefix_stub(cfg, 3, device="cpu")
    assert tuple(a.shape) == (3, cfg.n_prefix, cfg.d_model)
    assert abs(float(b.std()) / 0.02 - 1) < 0.1
    torch.testing.assert_close(
        b, port_modality.vlm_prefix_stub(cfg, 3, device="cpu"))
    cfg = port_configs.get_config("musicgen-medium")
    f = port_modality.audio_frame_stub(cfg, 1, 4, device="cpu")
    assert f.dtype == torch.bfloat16 and tuple(f.shape) == (1, 4, 1536)


# ------------------------------------------------------------ parameters --
@pytest.mark.parametrize("arch", ATTENTION)
def test_init_params_tree_shapes_and_dtypes_match(arch):
    """The port's own init has the reference's tree (empty dicts of the
    non-parametric norm, E-stacked expert leaves and QKV biases included),
    shapes and dtypes; the converter carries the reference's leaves
    across bit for bit into the same tree."""
    cfg_r = ref_configs.reduced_config(arch)
    cfg_p = port_configs.reduced_config(arch)
    port = init_params(cfg_p, torch.Generator().manual_seed(0), device="cpu")

    def shapes(tree, leaf):
        if isinstance(tree, dict):
            return {k: shapes(v, leaf) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [shapes(v, leaf) for v in tree]
        return leaf(tree)

    def ref_leaf(s):
        return tuple(s.shape), jnp.dtype(s.dtype).name

    def port_leaf(t):
        return tuple(t.shape), str(t.dtype).replace("torch.", "")

    ref_shapes = shapes(jax.eval_shape(
        lambda: ref_init_params(cfg_r, jax.random.key(0))), ref_leaf)
    assert shapes(port, port_leaf) == ref_shapes
    carried = params_from_numpy(jax.tree.map(
        np.asarray, ref_init_params(cfg_r, jax.random.key(0))), device="cpu")
    assert shapes(carried, port_leaf) == ref_shapes


def test_converter_on_moe_biases_and_empty_norms(models):
    """The reference's E-stacked expert leaves, QKV biases and the empty
    dicts of the non-parametric norm convert leaf for leaf."""
    for arch, check in (("granite-moe-1b-a400m",
                         lambda p: p["period"][0]["ffn"]["wi"]),
                        ("chatglm3-6b",
                         lambda p: p["period"][0]["mixer"]["bk"]),
                        ("olmo-1b", lambda p: p["period"][0]["norm1"])):
        _, _, params_r, params_p = models[arch]
        want, got = check(params_r), check(params_p)
        if isinstance(want, dict):
            assert want == {} and got == {}
            assert params_p["final_norm"] == {}
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tuple(models["granite-moe-1b-a400m"][3]["period"][0]["ffn"]
                 ["wi"].shape) == (2, 8, 64, 64)


# --------------------------------------------------------------- forward --
class _Runs(dict):
    """arch -> ((reference prefill, decode), (port prefill, decode)): a
    14-token prefill (logits at every position) on a batch-2 cache, then
    one decode step from the prefill's argmax (an embed-input arch steps
    on one more frame embedding)."""

    def __init__(self, models):
        super().__init__()
        self.models = models

    def __missing__(self, arch):
        cfg_r, cfg_p, params_r, params_p = self.models[arch]
        b, s = 2, 14
        max_seq = s + cfg_p.n_prefix + 4
        (tok_r, kw_r), (tok_p, kw_p) = _inputs(cfg_p, b, s, 0)
        pre_r = ref_forward(cfg_r, params_r, tok_r,
                            state=ref_init_state(cfg_r, b, max_seq), **kw_r)
        pre_p = forward(cfg_p, params_p, tok_p,
                        state=init_state(cfg_p, b, max_seq, device="cpu"),
                        **kw_p)
        pos = s + cfg_p.n_prefix
        if cfg_p.embed_input:
            (_, st_r), (_, st_p) = _inputs(cfg_p, b, 1, 1)
            st_r, st_p = dict(embeds=st_r["embeds"]), dict(
                embeds=st_p["embeds"])
            nxt_r = nxt_p = None
        else:
            nxt = np.asarray(jnp.argmax(pre_r.logits[:, -1:], -1)).astype(
                np.int32)
            nxt_r, nxt_p = jnp.asarray(nxt), torch.from_numpy(nxt)
            st_r = st_p = {}
        dec_r = ref_forward(cfg_r, params_r, nxt_r, state=pre_r.state,
                            pos_offset=pos, **st_r)
        dec_p = forward(cfg_p, params_p, nxt_p, state=pre_p.state,
                        pos_offset=pos, **st_p)
        self[arch] = (pre_r, dec_r), (pre_p, dec_p)
        return self[arch]


@pytest.fixture(scope="module")
def runs(models):
    return _Runs(models)


@pytest.mark.parametrize("arch", ATTENTION)
def test_forward_logits_equal(runs, arch):
    """Prefill logits at every position (the prefix's too for internvl2),
    and the MoE layers' mean load-balance loss and dropped share."""
    (pre_r, _), (pre_p, _) = runs[arch]
    _close(pre_p.logits, pre_r.logits)
    n = 14 + (8 if arch == "internvl2-26b" else 0)
    assert tuple(pre_p.logits.shape) == (2, n, 512)
    np.testing.assert_allclose(float(pre_p.aux["lb_loss"]),
                               float(pre_r.aux["lb_loss"]), rtol=1e-5)
    assert float(pre_p.aux["dropped"]) == float(pre_r.aux["dropped"])
    if arch in MOE_ARCHS:
        assert float(pre_p.aux["lb_loss"]) > 0


@pytest.mark.parametrize("arch", ATTENTION)
def test_prefill_then_decode_step_equal(runs, arch):
    """The decode step's logits and every cache (k, v, idx) after it."""
    (_, dec_r), (_, dec_p) = runs[arch]
    _close(dec_p.logits, dec_r.logits)
    assert tuple(dec_p.logits.shape) == (2, 1, 512)
    for cr, cp in zip(dec_r.state, dec_p.state, strict=True):
        np.testing.assert_array_equal(np.asarray(cr.idx), cp.idx.numpy())
        _close(cp.k, cr.k)
        _close(cp.v, cr.v)


@pytest.mark.parametrize("arch", ["starcoder2-15b", "granite-moe-1b-a400m"])
def test_forward_with_compiled_trunk_equal(models, arch):
    """Through the compiled fp32 trunk (the GeLU bank of two; MoE layers
    whose experts stay plain): the bank and the logits equal the
    reference's compiled trunk's, and one trunk call records one
    projection per banked weight of every layer, plus the head.  (The Q4
    and int8 trunks of these banks serve in
    ``tests/test_torch_zoo_serving.py``.)"""
    cfg_r, cfg_p, params_r, params_p = models[arch]
    ref = RefTrunk.from_params(cfg_r, params_r,
                               RefDisp.virtual("ultra-125h", execute=True),
                               quant="fp32", mode="compiled")
    port = BalancedTrunk.from_params(cfg_p, params_p,
                                     PortDisp.virtual("ultra-125h"),
                                     quant="fp32", device="cpu")
    assert sorted(port.bank) == sorted(ref.bank)
    tok = np.random.default_rng(7).integers(0, cfg_p.vocab_size, (2, 5),
                                            dtype=np.int32)
    offs_r, offs_p = ref.compiled_refresh(), port.compiled_refresh()
    fr = ref_forward(cfg_r, params_r, jnp.asarray(tok), apply_head=False,
                     trunk=ref, trunk_isa="avx_vnni", trunk_offsets=offs_r)
    want = ref.apply_head(fr.logits, isa="avx_vnni", offsets=offs_r)
    tape = port.compiled_tape_begin()
    fp = forward(cfg_p, params_p, torch.from_numpy(tok), apply_head=False,
                 trunk=port, trunk_isa="avx_vnni", trunk_offsets=offs_p)
    got = port.apply_head(fp.logits, isa="avx_vnni", offsets=offs_p)
    records = port.compiled_tape_end(tape)
    _close(got, want)
    mlp = 3 if cfg_p.mlp == "swiglu" else 2
    per_call = 1 + sum(4 + (mlp if f == "dense" else 0)
                       for _, f in cfg_p.layer_plan())
    assert len(records) == per_call
