"""The port's training path against the reference's, on the CPU.

Weights come from the reference's ``init_params`` and cross to the port
through ``repro_torch.models.convert`` (optimizer states through
``opt_state_from_numpy``); batches are the same numpy arrays.  The configs
are the reduced ones in float32, cut to the fewest layers that hold every
(mixer, ffn) pair of the arch: 2 for the attention archs, 8 (one period:
seven mLSTM blocks and an sLSTM) for xlstm-1.3b, 4 for jamba (mamba with
dense and MoE FFNs, attention with MoE); 16 tokens, two chunks of the
recurrent mixers.

Tolerances, each against the scale of what it compares (max |reference|):

* ``loss_fn`` and every gradient leaf: 2e-5 (``GRAD_TOL``).  The packages
  differ only in the order of their float32 sums; measured worst leaf
  1.9e-6 (dense, MoE with and without drops), 4.0e-6 (jamba).  xlstm's
  gradients are held to 2e-3 (``XLSTM_GRAD_TOL``; measured 3.6e-4): a
  stack of random mLSTM blocks doubles a rounding difference per block
  (``tests/test_torch_recurrent.py`` holds its forward at 2e-4 for that
  reason), and backward goes through the stack twice.
* ``adamw_update`` on carried gradients and state, plain and factored:
  1e-6 (measured 1.8e-7); ``lr_at`` 1e-6 (its cosine and the bias
  corrections' ``pow`` differ by an ulp at a few steps).
* ``grad_compress``: bitwise.  ``remat``: bitwise.
* Three ``make_train_step`` steps: loss and grad norm 1e-5; no parameter
  parts from the reference's by a learning rate or more.  Adam's first
  step moves every parameter by about ±lr whatever its gradient's size, so
  a near-zero gradient whose sign differed would move it 2·lr the other
  way; none does (the worst part is 1.4e-5 against lr 1.5e-3, a gradient
  near eps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.data import DataConfig, SyntheticLM
from repro.models import init_params as ref_init_params
from repro.models import loss_fn as ref_loss_fn
from repro.training import AdamWConfig as RefAdamWConfig
from repro.training import adamw_update as ref_adamw_update
from repro.training import grad_compress as ref_gc
from repro.training import init_opt_state as ref_init_opt_state
from repro.training import lr_at as ref_lr_at
from repro.training import make_train_step as ref_make_train_step
from repro.training import uneven_data_parallel_step as ref_uneven_step
from repro.training.optimizer import global_norm as ref_global_norm
import repro_torch.configs as port_configs
from repro_torch.models import loss_fn, opt_state_from_numpy, params_from_numpy
from repro_torch.training import (AdamWConfig, adamw_update, grad_compress,
                                  init_opt_state, local_accum, lr_at,
                                  make_train_step, microbatch_grads,
                                  uneven_data_parallel_step, weighted_combine)
from repro_torch.training.optimizer import global_norm
from repro_torch.tree import leaves, leaves_with_path, tree_map, unflatten

GRAD_TOL = 2e-5
XLSTM_GRAD_TOL = 2e-3   # see the module docstring
ADAM_TOL = 1e-6
# (arch, layers, capacity): the MoE once at its default capacity (no drop)
# and once at 8 slots per expert (3/4 of its assignments dropped)
CASES = [("olmo-1b", 2, None), ("granite-8b", 2, None),
         ("granite-moe-1b-a400m", 2, None), ("granite-moe-1b-a400m", 2, 8),
         ("xlstm-1.3b", 8, None), ("jamba-1.5-large-398b", 4, None)]
CASE_IDS = ["olmo", "granite-8b", "moe", "moe-dropping", "xlstm", "jamba"]


def _configs(arch, n_layers):
    ref = dataclasses.replace(ref_configs.reduced_config(arch),
                              n_layers=n_layers, dtype="float32")
    port = dataclasses.replace(port_configs.reduced_config(arch),
                               n_layers=n_layers, dtype="float32")
    return ref, port


def _to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _batch(vocab, b=2, s=16, seed=1):
    """Tokens, next-token labels with the last position and one more
    ignored (-100)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((b, 1), -100, np.int32)], 1)
    labels[0, 3] = -100
    return {"tokens": toks, "labels": labels}


def _port_value_and_grad(cfg, params, batch, **kw):
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    loss, metrics = loss_fn(cfg, unflatten(params, flat),
                            {k: torch.from_numpy(v) for k, v in batch.items()},
                            **kw)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max |diff| {err} > {tol} * {scale}"


# ------------------------------------------------------------ loss_fn --
@pytest.mark.parametrize("arch,n_layers,capacity", CASES, ids=CASE_IDS)
def test_loss_and_grads_match_reference(arch, n_layers, capacity):
    """The port's loss_fn value, its metrics and every gradient leaf
    against ``jax.value_and_grad`` of the reference's, on the same weights
    and batch (the MoE's router among them, with and without drops)."""
    rcfg, pcfg = _configs(arch, n_layers)
    rp = ref_init_params(rcfg, jax.random.key(0))
    batch = _batch(rcfg.vocab_size)
    (r_loss, r_m), r_grads = jax.value_and_grad(
        lambda p: ref_loss_fn(rcfg, p, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                              capacity=capacity), has_aux=True)(rp)
    loss, metrics, grads = _port_value_and_grad(pcfg, _to_port(rp), batch,
                                                capacity=capacity)
    _close(loss, r_loss, GRAD_TOL, "loss")
    for name in ("ce", "lb", "dropped"):
        _close(metrics[name], r_m[name], GRAD_TOL, name)
    if capacity is not None:
        assert float(metrics["dropped"]) > 0
    tol = XLSTM_GRAD_TOL if arch == "xlstm-1.3b" else GRAD_TOL
    r_flat = jax.tree_util.tree_flatten_with_path(r_grads)[0]
    paths = [k for k, _ in leaves_with_path(_to_port(rp))]
    assert len(r_flat) == len(grads) == len(paths)
    for path, g, (_, rg) in zip(paths, grads, r_flat):
        assert g is not None, path
        _close(g, rg, tol, path)


@pytest.mark.parametrize("arch,n_layers,capacity", CASES, ids=CASE_IDS)
def test_remat_changes_no_bit(arch, n_layers, capacity):
    """remat=True (each period repeat under torch.utils.checkpoint) gives
    the loss and every gradient of remat=False bit for bit."""
    _, pcfg = _configs(arch, n_layers)
    rp = ref_init_params(_configs(arch, n_layers)[0], jax.random.key(0))
    params = _to_port(rp)
    batch = _batch(pcfg.vocab_size)
    plain = _port_value_and_grad(pcfg, params, batch, capacity=capacity)
    remat = _port_value_and_grad(pcfg, params, batch, capacity=capacity,
                                 remat=True)
    assert torch.equal(plain[0], remat[0])
    for a, b in zip(plain[2], remat[2]):
        assert torch.equal(a, b)


def test_prefix_positions_carry_no_loss():
    """With prefix embeddings the logits are longer than the labels; the
    loss reads only the last len(labels) positions, as the reference's."""
    rcfg, pcfg = _configs("olmo-1b", 2)
    rp = ref_init_params(rcfg, jax.random.key(0))
    batch = _batch(rcfg.vocab_size)
    prefix = np.random.default_rng(5).normal(
        size=(2, 3, rcfg.d_model)).astype(np.float32)
    r_loss, _ = ref_loss_fn(rcfg, rp, {**{k: jnp.asarray(v)
                                          for k, v in batch.items()},
                                       "prefix_embeds": jnp.asarray(prefix)})
    loss, _ = loss_fn(pcfg, _to_port(rp),
                      {**{k: torch.from_numpy(v) for k, v in batch.items()},
                       "prefix_embeds": torch.from_numpy(prefix)})
    _close(loss, r_loss, GRAD_TOL, "loss")


def test_remat_refuses_state_and_trunk():
    from repro_torch.models import forward, init_state

    _, pcfg = _configs("olmo-1b", 2)
    params = _to_port(ref_init_params(_configs("olmo-1b", 2)[0],
                                      jax.random.key(0)))
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="remat"):
        forward(pcfg, params, toks, remat=True,
                state=init_state(pcfg, 1, 8, device="cpu"))


# ---------------------------------------------------------- optimizer --
def _adam_case(factored, seed=0):
    """Params of three ranks, a state after one reference step (non-zero
    moments), and fresh gradients large enough to be clipped."""
    rng = np.random.default_rng(seed)
    params = {"w": jnp.asarray(rng.normal(size=(3, 8, 16)), jnp.float32),
              "b": jnp.asarray(rng.normal(size=(16,)), jnp.float32),
              "m": {"k": jnp.asarray(rng.normal(size=(16, 8)), jnp.float32)}}

    def draw(scale):
        return jax.tree.map(lambda p: jnp.asarray(
            rng.normal(size=p.shape) * scale, jnp.float32), params)

    cfg = RefAdamWConfig(lr=1e-2, warmup_steps=3, total_steps=20,
                         factored=factored)
    p1, st1, _ = ref_adamw_update(cfg, params, draw(3.0),
                                  ref_init_opt_state(params, cfg))
    return cfg, p1, st1, draw(5.0)


@pytest.mark.parametrize("factored", [False, True], ids=["plain", "factored"])
def test_adamw_update_matches_reference(factored):
    """One AdamW step from a carried state on carried gradients: new
    params, step, moments (bf16 mu and row/col statistics when factored)
    and metrics within 1e-6 of the reference's; the gradient norm is the
    pre-clip one and the clip is applied."""
    cfg, p1, st1, g = _adam_case(factored)
    r_p, r_st, r_m = ref_adamw_update(cfg, p1, g, st1)
    port_cfg = AdamWConfig(**dataclasses.asdict(cfg))
    p, st, m = adamw_update(port_cfg, _to_port(p1), _to_port(g),
                            opt_state_from_numpy(
                                jax.tree.map(np.asarray, st1), device="cpu"))
    assert int(st.step) == int(r_st.step) == 2
    if factored:
        assert st.mu["w"].dtype == torch.bfloat16
        assert set(st.nu["w"]) == {"row", "col"}
    want = jax.tree_util.tree_flatten_with_path((r_p, r_st.mu, r_st.nu))[0]
    got = leaves_with_path((p, st.mu, st.nu))
    assert [k for k, _ in got] == [
        "/".join(str(q).strip("[].'") for q in path) for path, _ in want]
    for (key, a), (_, b) in zip(got, want):
        _close(a, b, ADAM_TOL, key)
    _close(m["grad_norm"], r_m["grad_norm"], ADAM_TOL, "grad_norm")
    _close(m["lr"], r_m["lr"], ADAM_TOL, "lr")
    assert float(m["grad_norm"]) > cfg.grad_clip


def test_init_opt_state_layout():
    """Zero moments in the reference's layout and dtypes, factored only for
    tensors with two dims of size > 1."""
    params = {"w": torch.zeros((3, 8, 16)), "b": torch.zeros((16,)),
              "v": torch.zeros((1, 16))}
    plain = init_opt_state(params)
    fact = init_opt_state(params, AdamWConfig(factored=True))
    ref_params = jax.tree.map(lambda t: jnp.zeros(t.shape), params)
    for ours, ref in ((plain, ref_init_opt_state(ref_params)),
                      (fact, ref_init_opt_state(
                          ref_params, RefAdamWConfig(factored=True)))):
        want = jax.tree_util.tree_flatten_with_path((ref.mu, ref.nu))[0]
        got = leaves_with_path((ours.mu, ours.nu))
        assert len(got) == len(want)
        for (_, a), (_, b) in zip(got, want):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            assert not a.any()
        assert ours.step.dtype == torch.int32 and int(ours.step) == 0


@pytest.mark.parametrize("cfg_kw", [
    dict(lr=3e-3, warmup_steps=20, total_steps=100),
    dict(lr=1.0, warmup_steps=10, total_steps=110, min_lr_frac=0.1),
    dict(lr=2e-4, warmup_steps=0, total_steps=50, min_lr_frac=0.0),
], ids=["train-default", "reference-test", "no-warmup"])
def test_lr_at_matches_reference(cfg_kw):
    """Linear warmup then cosine decay, at every step from 0 past the end."""
    steps = np.arange(0, 130, dtype=np.int32)
    want = np.array([np.float32(ref_lr_at(RefAdamWConfig(**cfg_kw),
                                          jnp.asarray(s))) for s in steps])
    got = np.array([float(lr_at(AdamWConfig(**cfg_kw),
                                torch.tensor(int(s), dtype=torch.int32)))
                    for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=ADAM_TOL, atol=0)


def test_global_norm_and_clipping():
    """The global norm over the reference's leaf order; a gradient above
    the clip is scaled to norm grad_clip, one below is not scaled."""
    rng = np.random.default_rng(3)
    g = {"a": rng.normal(size=(7, 5)).astype(np.float32),
         "b": [rng.normal(size=(11,)).astype(np.float32),
               rng.normal(size=(2, 3, 4)).astype(np.float32)]}
    want = float(ref_global_norm(jax.tree.map(jnp.asarray, g)))
    got = float(global_norm(_to_port(g)))
    assert abs(got - want) <= ADAM_TOL * want
    for clip, scaled in ((1.0, True), (100.0, False)):
        cfg = AdamWConfig(lr=1.0, warmup_steps=0, grad_clip=clip, b1=0.0,
                          b2=0.0, weight_decay=0.0)
        params = tree_map(torch.zeros_like, _to_port(g))
        # b1 = b2 = 0: each update is g * s / (|g * s| + eps); its
        # first moment holds the clipped gradient itself
        _, st, m = adamw_update(cfg, params, _to_port(g),
                                init_opt_state(params))
        mu_norm = float(global_norm(st.mu))
        assert float(m["grad_norm"]) == pytest.approx(got, rel=1e-6)
        assert mu_norm == pytest.approx(clip if scaled else got, rel=1e-5)


# -------------------------------------------------------- compression --
def test_compress_codes_and_error_bitwise():
    """int8 codes, scale and carried error equal the reference's bit for
    bit over a stream with error feedback (values at and near .5 codes
    included, which round half to even)."""
    rng = np.random.default_rng(0)
    err_r = jnp.zeros((257,), jnp.float32)
    err_p = torch.zeros((257,), dtype=torch.float32)
    for i in range(20):
        g = (rng.normal(size=(257,)) * 10 ** rng.uniform(-4, 1)).astype(
            np.float32)
        g[:4] = np.array([0.5, -0.5, 1.5, -2.5], np.float32) * g[4]
        c_r, err_r = ref_gc.compress(jnp.asarray(g), err_r)
        c_p, err_p = grad_compress.compress(torch.from_numpy(g), err_p)
        assert c_p.q.dtype == torch.int8
        np.testing.assert_array_equal(c_p.q.numpy(), np.asarray(c_r.q))
        assert c_p.scale.numpy().tobytes() == np.asarray(c_r.scale).tobytes()
        assert err_p.numpy().tobytes() == np.asarray(err_r).tobytes()
        np.testing.assert_array_equal(
            grad_compress.decompress(c_p).numpy(),
            np.asarray(ref_gc.decompress(c_r)))


def test_compress_tree_round_trip():
    """compress_tree / decompress_tree keep the tree and equal the
    reference's codes, errors and values leaf by leaf."""
    rng = np.random.default_rng(1)
    g = {"a": rng.normal(size=(8, 8)).astype(np.float32),
         "b": {"c": rng.normal(size=(4,)).astype(np.float32)}}
    comp, errs = grad_compress.compress_tree(
        _to_port(g), grad_compress.init_errors(_to_port(g)))
    r_comp, r_errs = ref_gc.compress_tree(
        jax.tree.map(jnp.asarray, g),
        ref_gc.init_errors(jax.tree.map(jnp.asarray, g)))
    deq = grad_compress.decompress_tree(comp)
    r_deq = ref_gc.decompress_tree(r_comp)
    assert isinstance(comp["b"]["c"], grad_compress.Compressed)
    for ours, ref in ((deq, r_deq), (errs, r_errs)):
        got = leaves_with_path(ours)
        want = jax.tree_util.tree_flatten_with_path(ref)[0]
        assert [k for k, _ in got] == ["a", "b/c"] and len(want) == 2
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(deq["a"].numpy(), g["a"], rtol=0,
                               atol=float(np.abs(g["a"]).max()) / 127)


# ------------------------------------------------------- train steps --
def _olmo():
    rcfg, pcfg = _configs("olmo-1b", 2)
    return rcfg, pcfg, ref_init_params(rcfg, jax.random.key(0))


def _micro(n_micro, vocab, mb=2, s=16, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, vocab, (n_micro, mb, s)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}


def _assert_trees_close(a, b, rtol=2e-4, atol=2e-5):
    for x, y in zip(leaves(a), leaves(b)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=rtol, atol=atol)


def test_microbatch_accumulation_equals_big_batch():
    """The reference's identity on the port: the mean over k microbatches
    equals one big batch (token-mean loss, equal valid counts), at the
    reference test's tolerance."""
    _, pcfg, rp = _olmo()
    params = _to_port(rp)
    batch = _micro(4, pcfg.vocab_size)
    l_micro, g_micro, _ = microbatch_grads(pcfg, params, batch)
    big = {k: v.reshape(1, 8, 16) for k, v in batch.items()}
    l_big, g_big, _ = microbatch_grads(pcfg, params, big)
    assert float(l_micro) == pytest.approx(float(l_big), rel=1e-6)
    _assert_trees_close(g_micro, g_big)
    assert all(g.dtype == torch.float32 for g in leaves(g_micro))


def test_uneven_equals_even():
    """The paper's uneven DP on the port: the weighted combine of per-pod
    local grads equals the global average, regardless of the split."""
    _, pcfg, rp = _olmo()
    params = _to_port(rp)
    batch = _micro(8, pcfg.vocab_size)
    _, g_all, _ = microbatch_grads(pcfg, params, batch)
    counts = np.array([4, 2, 1, 1])
    shards, start = [], 0
    for c in counts:
        shards.append({k: v[start:start + c] for k, v in batch.items()})
        start += c
    g_comb = weighted_combine([local_accum(pcfg, params, s)[1]
                               for s in shards], counts)
    _assert_trees_close(g_comb, g_all)


def test_uneven_step_matches_reference():
    """uneven_data_parallel_step (pods of 3, 1 and 2 microbatches) against
    the reference's: mean loss and updated params."""
    rcfg, pcfg, rp = _olmo()
    batch = _micro(6, pcfg.vocab_size, seed=3)
    counts = np.array([3, 1, 2])
    cuts = np.concatenate([[0], np.cumsum(counts)])
    pods = [{k: v[a:b] for k, v in batch.items()}
            for a, b in zip(cuts[:-1], cuts[1:])]
    opt = dict(lr=1e-2, warmup_steps=0, total_steps=100)
    r_p, _, r_loss = ref_uneven_step(
        rcfg, RefAdamWConfig(**opt), rp, ref_init_opt_state(rp),
        [{k: jnp.asarray(v.numpy()) for k, v in b.items()} for b in pods],
        counts)
    params = _to_port(rp)
    p, st, loss = uneven_data_parallel_step(
        pcfg, AdamWConfig(**opt), params, init_opt_state(params), pods,
        counts)
    assert loss == pytest.approx(r_loss, rel=1e-6)
    assert int(st.step) == 1
    parted = sum(int((np.abs(a.numpy() - np.asarray(b)) >= opt["lr"]).sum())
                 for a, b in zip(leaves(p), jax.tree.leaves(r_p)))
    assert parted == 0


def test_uneven_dp_step_learns():
    _, pcfg, rp = _olmo()
    params = _to_port(rp)
    opt = init_opt_state(params)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=100)
    batch = _micro(8, pcfg.vocab_size, seed=3)
    shards = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()}
              for i in range(4)]
    losses = []
    for _ in range(5):
        params, opt, loss = uneven_data_parallel_step(
            pcfg, cfg, params, opt, shards, np.array([2, 2, 2, 2]))
        losses.append(loss)
    assert losses[-1] < losses[0]


def test_train_step_matches_reference_for_three_steps():
    """make_train_step on the reference's weights and SyntheticLM batches,
    three steps against the reference's jitted step: loss and grad norm
    within 1e-5 each step, lr equal to 1e-6, and no parameter parting from
    the reference's by a learning rate or more (see the module docstring:
    a sign flip under Adam would part it by 2·lr)."""
    rcfg, pcfg, rp = _olmo()
    opt_kw = dict(lr=3e-3, warmup_steps=2, total_steps=50)
    r_step = jax.jit(ref_make_train_step(rcfg, RefAdamWConfig(**opt_kw)))
    step = make_train_step(pcfg, AdamWConfig(**opt_kw), remat=True)
    r_opt = ref_init_opt_state(rp)
    params = _to_port(rp)
    opt = init_opt_state(params)
    it = iter(SyntheticLM(DataConfig(vocab_size=rcfg.vocab_size, seq_len=16,
                                     global_batch=4, microbatch=2)))
    for _ in range(3):
        b = next(it)
        rp, r_opt, r_m = r_step(rp, r_opt, {k: jnp.asarray(v)
                                            for k, v in b.items()})
        params, opt, m = step(params, opt, {k: torch.from_numpy(v)
                                            for k, v in b.items()})
        for name in ("loss", "grad_norm"):
            _close(m[name], r_m[name], 1e-5, name)
        _close(m["lr"], r_m["lr"], ADAM_TOL, "lr")
        lr = float(r_m["lr"])
        for a, b_ in zip(leaves(params), jax.tree.leaves(rp)):
            assert int((np.abs(a.numpy() - np.asarray(b_)) >= lr).sum()) == 0
    assert int(opt.step) == int(r_opt.step) == 3


@pytest.mark.parametrize("capacity", [None, 8], ids=["default", "dropping"])
def test_moe_backward_is_deterministic(capacity):
    """The MoE layer's gradients (input, router, experts) are the same bits
    on every run: no two gradient rows meet in a scatter-add."""
    from repro_torch.models import moe

    _, pcfg = _configs("granite-moe-1b-a400m", 2)
    p = {k: v[0] for k, v in moe.init_moe(
        pcfg, torch.Generator().manual_seed(0), "cpu").items()}
    x = torch.randn((2, 40, pcfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    runs = []
    for _ in range(3):
        xs = x.clone().requires_grad_()
        ps = {k: v.clone().requires_grad_() for k, v in p.items()}
        y, aux = moe.moe_fwd(pcfg, ps, xs, capacity=capacity)
        runs.append(torch.autograd.grad((y * y).sum() + aux["lb_loss"],
                                        [xs, *ps.values()]))
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)
