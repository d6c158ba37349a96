"""The port's recurrent mixers (mamba, mLSTM, sLSTM) against the reference's,
on the CPU.

Each mixer at ``reduced_config`` size (f32) on the reference's weights,
carried across by ``repro_torch.models.convert``, and the same numpy
inputs: without state and with state, chunked against a single chunk,
prefill then decode against the whole sequence, and the chunkwise mLSTM
against its step recurrence; the ``init_*`` functions' trees, shapes,
dtypes and deterministic leaves; and ``forward`` of reduced jamba and
xlstm, logits and prefill then decode.  As in ``tests/test_torch_zoo.py``
the packages differ only in the order of their f32 sums — here also the
order of the mamba scan (the reference's associative scan against the
port's loop) — and outputs are held to 2e-5 of their scale, but for
``forward`` on xlstm: a stack of random-weight mLSTM blocks amplifies any
rounding difference about twofold a layer (the port against the
reference: 7e-7 of scale after one mLSTM block, 5e-6 after 4, 4e-5 after
8), and the reference itself moves by 3.3e-5 of scale at 16 layers when
its embeddings move by one ulp, so xlstm's logits are held to 2e-4.
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
from repro.models import init_slot_state as ref_init_slot_state
from repro.models import init_state as ref_init_state
from repro.models import ssm as ref_ssm
from repro.models import xlstm as ref_xlstm
import repro_torch.configs as port_configs
from repro_torch.models import (forward, init_params, init_slot_state,
                                init_state, params_from_numpy)
from repro_torch.models import ssm, xlstm

REL_TOL = 2e-5
XLSTM_FORWARD_TOL = 2e-4   # see the module docstring
RECURRENT = ("jamba-1.5-large-398b", "xlstm-1.3b")
# mixer -> (arch whose reduced config it takes, reference init, port
# init, reference fwd, port fwd, reference state init, port state init)
MIXERS = {
    "mamba": ("jamba-1.5-large-398b", ref_ssm.init_mamba, ssm.init_mamba,
              ref_ssm.mamba_fwd, ssm.mamba_fwd, ref_ssm.init_mamba_state,
              ssm.init_mamba_state),
    "mlstm": ("xlstm-1.3b", ref_xlstm.init_mlstm, xlstm.init_mlstm,
              ref_xlstm.mlstm_fwd, xlstm.mlstm_fwd,
              ref_xlstm.init_mlstm_state, xlstm.init_mlstm_state),
    "slstm": ("xlstm-1.3b", ref_xlstm.init_slstm, xlstm.init_slstm,
              ref_xlstm.slstm_fwd, xlstm.slstm_fwd,
              ref_xlstm.init_slstm_state, xlstm.init_slstm_state),
}


def _close(got, want, rel=REL_TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max |diff| {err} > {rel} * {scale}"


def _state_close(got, want, rel=REL_TOL):
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for name in got._fields:
        _close(getattr(got, name), getattr(want, name), rel)


def _forward_tol(arch):
    return XLSTM_FORWARD_TOL if arch == "xlstm-1.3b" else REL_TOL


def _to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _mixer(name, **changes):
    """(reference cfg, port cfg, reference params, port params, reference
    fwd, port fwd, reference state init, port state init) of one mixer,
    the reference's weights carried across.  ``changes`` go into the
    mixer's own config (``ssm`` or ``xlstm``)."""
    arch, r_init, _, r_fwd, p_fwd, r_st, p_st = MIXERS[name]
    cfg_r, cfg_p = (ref_configs.reduced_config(arch),
                    port_configs.reduced_config(arch))
    if changes:
        sub = "ssm" if name == "mamba" else "xlstm"
        cfg_r = dataclasses.replace(cfg_r, **{sub: dataclasses.replace(
            getattr(cfg_r, sub), **changes)})
        cfg_p = dataclasses.replace(cfg_p, **{sub: dataclasses.replace(
            getattr(cfg_p, sub), **changes)})
    p_r = r_init(cfg_r, jax.random.key(3))
    return cfg_r, cfg_p, p_r, _to_port(p_r), r_fwd, p_fwd, r_st, p_st


def _x(cfg, b, s, seed):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _port_state(p_st, cfg, b):
    return p_st(cfg, b, device="cpu")


# ----------------------------------------------------------- the mixers --
@pytest.mark.parametrize("name", list(MIXERS))
def test_mixer_without_state_equals_the_references(name):
    """A 16-token sequence in two chunks of 8 (the reduced chunk)."""
    cfg_r, cfg_p, p_r, p_p, r_fwd, p_fwd, _, _ = _mixer(name)
    x_r, x_p = _x(cfg_p, 2, 16, 0)
    want, st_r = r_fwd(cfg_r, p_r, x_r)
    got, st_p = p_fwd(cfg_p, p_p, x_p)
    assert st_r is None and st_p is None
    _close(got, want)


@pytest.mark.parametrize("name", list(MIXERS))
def test_mixer_with_state_equals_the_references(name):
    """From a state that earlier tokens advanced: the output and every
    leaf of the advanced state, which the port writes into the tensors it
    was given."""
    cfg_r, cfg_p, p_r, p_p, r_fwd, p_fwd, r_st, p_st = _mixer(name)
    x0_r, x0_p = _x(cfg_p, 2, 8, 1)
    x1_r, x1_p = _x(cfg_p, 2, 13, 2)   # 13 % 8: one chunk of 13
    _, st_r = r_fwd(cfg_r, p_r, x0_r, r_st(cfg_r, 2))
    given = _port_state(p_st, cfg_p, 2)
    _, st_p = p_fwd(cfg_p, p_p, x0_p, given)
    _state_close(st_p, st_r)
    want, st_r = r_fwd(cfg_r, p_r, x1_r, st_r)
    got, st_p = p_fwd(cfg_p, p_p, x1_p, st_p)
    _close(got, want)
    _state_close(st_p, st_r)
    assert all(a is b for a, b in zip(st_p, given))


@pytest.mark.parametrize("name", list(MIXERS))
def test_mixer_chunked_equals_one_chunk(name):
    """24 tokens in three chunks of 8 against one chunk of 24, in the port
    and against the reference's one chunk; the states alike."""
    outs = {}
    for chunk in (8, 24):
        cfg_r, cfg_p, p_r, p_p, r_fwd, p_fwd, r_st, p_st = _mixer(
            name, chunk=chunk)
        x_r, x_p = _x(cfg_p, 2, 24, 4)
        outs[chunk] = p_fwd(cfg_p, p_p, x_p, _port_state(p_st, cfg_p, 2))
    want, st_r = r_fwd(cfg_r, p_r, x_r, r_st(cfg_r, 2))
    for chunk in (8, 24):
        _close(outs[chunk][0], want)
        _state_close(outs[chunk][1], st_r)
    _close(outs[8][0], outs[24][0].numpy())


@pytest.mark.parametrize("name", list(MIXERS))
def test_mixer_prefill_then_decode_equals_the_whole_sequence(name):
    """A 9-token prefill, then three one-token decode steps, against the
    12-token sequence in one call (and the reference's decode steps)."""
    cfg_r, cfg_p, p_r, p_p, r_fwd, p_fwd, r_st, p_st = _mixer(name)
    x_r, x_p = _x(cfg_p, 3, 12, 5)
    whole, _ = p_fwd(cfg_p, p_p, x_p, _port_state(p_st, cfg_p, 3))
    want_whole, _ = r_fwd(cfg_r, p_r, x_r, r_st(cfg_r, 3))
    _close(whole, want_whole)
    st_p = _port_state(p_st, cfg_p, 3)
    parts, _ = [p_fwd(cfg_p, p_p, x_p[:, :9], st_p)[0]], None
    _, st_r = r_fwd(cfg_r, p_r, x_r[:, :9], r_st(cfg_r, 3))
    for t in range(9, 12):
        got, st_p = p_fwd(cfg_p, p_p, x_p[:, t:t + 1], st_p)
        want, st_r = r_fwd(cfg_r, p_r, x_r[:, t:t + 1], st_r)
        _close(got, want)
        parts.append(got)
    _state_close(st_p, st_r)
    _close(torch.cat(parts, dim=1), whole.numpy())


def _mlstm_inputs(b, h, l, dk, dv, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, l, dk)).astype(np.float32) * dk ** -0.5
    k = rng.standard_normal((b, h, l, dk)).astype(np.float32)
    v = rng.standard_normal((b, h, l, dv)).astype(np.float32)
    ig = rng.standard_normal((b, h, l)).astype(np.float32)
    fg = np.log(1 / (1 + np.exp(-(rng.standard_normal((b, h, l)) + 3)))
                ).astype(np.float32)
    state = (rng.standard_normal((b, h, dv, dk)).astype(np.float32),
             rng.standard_normal((b, h, dk)).astype(np.float32),
             rng.standard_normal((b, h)).astype(np.float32))
    return (q, k, v, ig, fg), state


@pytest.mark.parametrize("fresh", [True, False], ids=["fresh", "carried"])
def test_mlstm_chunk_equals_the_step_recurrence(fresh):
    """``_mlstm_chunk`` against ``mlstm_recurrent_reference`` (the exact
    step recurrence) in the port, from a fresh and from a carried state
    that it advances in place, and against the reference's chunk."""
    ins, state = _mlstm_inputs(2, 4, 11, 8, 16, 6)
    if fresh:
        state = (np.zeros_like(state[0]), np.zeros_like(state[1]),
                 np.full_like(state[2], xlstm.NEG))
    t = [torch.from_numpy(a) for a in ins]
    h_rec, st_rec = xlstm.mlstm_recurrent_reference(
        *t, tuple(torch.from_numpy(a.copy()) for a in state))
    given = tuple(torch.from_numpy(a.copy()) for a in state)
    h, st = xlstm._mlstm_chunk(*t, given)
    assert all(a is b for a, b in zip(st, given))
    h_ref, st_ref = ref_xlstm._mlstm_chunk(
        *(jnp.asarray(a) for a in ins), tuple(jnp.asarray(a) for a in state))
    _close(h, h_rec.numpy())
    _close(h, h_ref)
    for a, b, c in zip(st, st_rec, st_ref):
        _close(a, b.numpy())
        _close(a, c)


def test_mlstm_step_and_recurrence_equal_the_references():
    ins, state = _mlstm_inputs(2, 4, 6, 8, 16, 7)
    h, st = xlstm.mlstm_recurrent_reference(
        *(torch.from_numpy(a) for a in ins),
        tuple(torch.from_numpy(a) for a in state))
    h_ref, st_ref = ref_xlstm.mlstm_recurrent_reference(
        *(jnp.asarray(a) for a in ins), tuple(jnp.asarray(a) for a in state))
    _close(h, h_ref)
    for a, b in zip(st, st_ref):
        _close(a, b)


def test_slstm_step_equals_the_references():
    cfg_r, cfg_p, p_r, p_p, *_ = _mixer("slstm")
    rng = np.random.default_rng(8)
    d = cfg_p.d_model
    xt = rng.standard_normal((3, 4 * d)).astype(np.float32)
    st = [rng.standard_normal((3, d)).astype(np.float32) for _ in range(4)]
    st[1] = np.abs(st[1]) + 0.5
    want = ref_xlstm.slstm_step(cfg_r, p_r, jnp.asarray(xt),
                                ref_xlstm.SLSTMState(*map(jnp.asarray, st)))
    got = xlstm.slstm_step(cfg_p, p_p, torch.from_numpy(xt),
                           xlstm.SLSTMState(*map(torch.from_numpy, st)))
    _state_close(got, want)


def test_softplus_is_logaddexp_above_the_threshold():
    """``jax.nn.softplus`` at x = 30 is log(1 + e^30), one ulp above 30 in
    f32 where ``F.softplus`` (threshold 20) returns x itself."""
    x = np.array([-40.0, -3.0, 0.0, 2.5, 19.0, 21.0, 30.0, 90.0], np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_array_equal(ssm.softplus(torch.from_numpy(x)).numpy(),
                                  want)


# ------------------------------------------------------------- the inits --
def _shapes(tree, leaf):
    if isinstance(tree, dict):
        return {k: _shapes(v, leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v, leaf) for v in tree]
    return leaf(tree)


def _ref_leaf(s):
    return tuple(s.shape), jnp.dtype(s.dtype).name


def _port_leaf(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", RECURRENT)
def test_init_params_and_states_shapes_and_dtypes_match(arch):
    """The port's own init has the reference's tree, shapes and dtypes, and
    the converter carries the reference's leaves into the same tree; the
    states too — ``init_state`` and ``init_slot_state``, the recurrent
    leaves stacked (n_rep, B, ...) with no per-row idx."""
    cfg_r = ref_configs.reduced_config(arch)
    cfg_p = port_configs.reduced_config(arch)
    for ref_st, port_st in ((ref_init_state, init_state),
                            (ref_init_slot_state, init_slot_state)):
        want = _shapes(jax.eval_shape(lambda: ref_st(cfg_r, 3, 16)),
                       _ref_leaf)
        assert _shapes(port_st(cfg_p, 3, 16, device="cpu"),
                       _port_leaf) == want
    want = _shapes(jax.eval_shape(
        lambda: ref_init_params(cfg_r, jax.random.key(0))), _ref_leaf)
    port = init_params(cfg_p, torch.Generator().manual_seed(0), device="cpu")
    assert _shapes(port, _port_leaf) == want
    assert _shapes(_to_port(ref_init_params(cfg_r, jax.random.key(0))),
                   _port_leaf) == want


@pytest.mark.parametrize("name", list(MIXERS))
def test_init_deterministic_leaves_equal_the_references(name):
    """The leaves no key decides (S4D ``A_log``, ``D``, the conv biases, the
    gate biases) equal the reference's exactly (``A_log`` to one ulp, the
    reference's log being one ulp off at 7); the states' initial values
    too (``m = NEG``, sLSTM ``n = 1e-6``); ``dt_bias`` is the inverse
    softplus of a dt in [1e-3, 0.1]; the drawn leaves have the reference's
    scale."""
    cfg_r, cfg_p, p_r, _, _, _, r_st, p_st = _mixer(name)
    port = MIXERS[name][2](cfg_p, torch.Generator().manual_seed(0), "cpu",
                           n_rep=2)
    fixed = {"mamba": ("A_log", "D", "conv_b"), "mlstm": ("b_if", "conv_b"),
             "slstm": ("bias",)}[name]
    for key in fixed:
        for r in range(2):
            if key == "A_log":
                # log(1..n) rounded once to f32; XLA's CPU log is one ulp
                # above that at 7
                np.testing.assert_array_equal(port[key][r].numpy(), np.log(
                    np.arange(1, cfg_p.ssm.d_state + 1.0)).astype(
                        np.float32)[None].repeat(port[key].shape[1], 0))
                np.testing.assert_array_max_ulp(port[key][r].numpy(),
                                                np.asarray(p_r[key]), 1)
            else:
                np.testing.assert_array_equal(port[key][r].numpy(),
                                              np.asarray(p_r[key]))
    for key, leaf in port.items():
        assert leaf.shape[1:] == p_r[key].shape, key
        assert str(leaf.dtype).replace("torch.", "") == \
            jnp.dtype(p_r[key].dtype).name, key
        if key not in fixed and key != "dt_bias":
            ratio = float(leaf.float().std()) / float(jnp.std(
                p_r[key].astype(jnp.float32)))
            assert 0.8 < ratio < 1.25, (key, ratio)
    if name == "mamba":
        dt = ssm.softplus(port["dt_bias"])
        assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
        assert float(dt.max()) <= 0.1 * (1 + 1e-5)
        assert not torch.equal(port["dt_bias"][0], port["dt_bias"][1])
    _state_close(_port_state(p_st, cfg_p, 2), r_st(cfg_r, 2))
    stacked = p_st(cfg_p, 2, device="cpu", n_rep=3)
    for leaf, one in zip(stacked, _port_state(p_st, cfg_p, 2)):
        assert leaf.shape == (3, *one.shape)
        assert torch.equal(leaf[1], one)


# --------------------------------------------------------------- forward --
class _Runs(dict):
    """arch -> ((reference prefill, decode), (port prefill, decode)): a
    14-token prefill (logits at every position) on a batch-2 state, then
    one decode step from the prefill's argmax; the reference's weights
    carried across."""

    def __missing__(self, arch):
        cfg_r, cfg_p = (ref_configs.reduced_config(arch),
                        port_configs.reduced_config(arch))
        params_r = ref_init_params(cfg_r, jax.random.key(0))
        params_p = _to_port(params_r)
        tok = np.random.default_rng(0).integers(0, cfg_p.vocab_size, (2, 14),
                                                dtype=np.int32)
        pre_r = ref_forward(cfg_r, params_r, jnp.asarray(tok),
                            state=ref_init_state(cfg_r, 2, 18))
        pre_p = forward(cfg_p, params_p, torch.from_numpy(tok),
                        state=init_state(cfg_p, 2, 18, device="cpu"))
        nxt = np.asarray(jnp.argmax(pre_r.logits[:, -1:], -1)).astype(
            np.int32)
        dec_r = ref_forward(cfg_r, params_r, jnp.asarray(nxt),
                            state=pre_r.state, pos_offset=14)
        dec_p = forward(cfg_p, params_p, torch.from_numpy(nxt),
                        state=pre_p.state, pos_offset=14)
        whole = forward(cfg_p, params_p,
                        torch.from_numpy(np.concatenate([tok, nxt], 1)))
        self[arch] = (pre_r, dec_r), (pre_p, dec_p), whole
        return self[arch]


@pytest.fixture(scope="module")
def runs():
    return _Runs()


@pytest.mark.parametrize("arch", RECURRENT)
def test_forward_logits_equal(runs, arch):
    """Prefill logits at every position, and jamba's MoE aux."""
    (pre_r, _), (pre_p, _), _ = runs[arch]
    _close(pre_p.logits, pre_r.logits, _forward_tol(arch))
    assert tuple(pre_p.logits.shape) == (2, 14, 512)
    np.testing.assert_allclose(float(pre_p.aux["lb_loss"]),
                               float(pre_r.aux["lb_loss"]), rtol=1e-5)
    assert float(pre_p.aux["dropped"]) == float(pre_r.aux["dropped"])


@pytest.mark.parametrize("arch", RECURRENT)
def test_prefill_then_decode_step_equal(runs, arch):
    """The decode step's logits and every state leaf after it (KV caches,
    mamba, mLSTM and sLSTM states), and the step's logits against the
    whole 15-token sequence in one call without state."""
    (_, dec_r), (_, dec_p), whole = runs[arch]
    tol = _forward_tol(arch)
    _close(dec_p.logits, dec_r.logits, tol)
    _close(dec_p.logits, whole.logits[:, -1:].numpy(), tol)
    assert tuple(dec_p.logits.shape) == (2, 1, 512)
    kinds = set()
    for sr, sp in zip(dec_r.state, dec_p.state, strict=True):
        kinds.add(type(sp).__name__)
        if type(sp).__name__ == "KVCache":
            np.testing.assert_array_equal(np.asarray(sr.idx), sp.idx.numpy())
            _close(sp.k, sr.k)
            _close(sp.v, sr.v)
        else:
            _state_close(sp, sr, tol)
    assert kinds == ({"KVCache", "MambaState"} if arch.startswith("jamba")
                     else {"MLSTMState", "SLSTMState"})


@pytest.mark.parametrize("arch", RECURRENT)
def test_forward_rowwise_equals_batched(arch):
    """``rowwise`` (multi-lane prefill) runs each recurrent mixer one row
    at a time on views of the state's rows: the same logits and states as
    the batched call, within f32 tolerance (the CPU's products may sum in
    another order at another M)."""
    cfg = port_configs.reduced_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    tok = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (3, 8), dtype=np.int32))
    outs = []
    for rowwise in (False, True):
        st = init_slot_state(cfg, 3, 12, device="cpu")
        outs.append(forward(cfg, params, tok, state=st,
                            pos_offset=torch.zeros(3, dtype=torch.int32),
                            rowwise=rowwise))
    _close(outs[1].logits, outs[0].logits.numpy())
    for a, b in zip(outs[1].state, outs[0].state):
        for x, y in zip(a, b):
            if x.is_floating_point():
                _close(x, y.numpy())
            else:
                assert torch.equal(x, y)
