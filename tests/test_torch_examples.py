"""The port's examples (``repro_torch.examples``) against the reference's
``examples/*.py``, on the CPU.

The reference's examples are loaded from their files and run as they are,
their printout captured, except where a test needs a number the reference
only prints rounded: there the test runs the reference's own functions on
the example's inputs, as the example does.  The model examples take the
reference's weights (``init_params(cfg, key(0))``) through
``params_from_numpy``.

* ``hybrid_cpu_inference``, ``serve_batch``, ``continuous_serving`` and
  ``quickstart``'s scheduler line are on the virtual clock (float64 numpy
  in both packages): their lines must be equal letter for letter.  The
  serving examples send no stop token, so their lines do not depend on
  the weights.
* ``quickstart``'s 30 training steps from the reference's weights: the
  first loss within 1e-5 of the reference's (one forward pass; f32 sums in
  other orders; measured 7.0e-8), the last within ``QUICKSTART_LAST_TOL``
  relative.  After the first Adam steps the relative difference wanders
  between 5e-6 and 2.2e-4 from step to step (measured at every step: 9.5e-6
  at step 30, 2.2e-4 at step 21, 8.2e-5 at step 5), so the last step is
  held to 1e-3, about 4.6 times the worst reading of the run, not to its
  own lucky one.
* ``q4_inference``: 7 matrices quantized; the Q4_0 codes bitwise the
  reference's; the port's product (the plain version here) within the
  reference's kernel tolerance (f32 rtol 2e-5, atol 2e-5·K) of the
  reference's oracle on the same codes; the quantization error within
  1e-5 and the greedy agreement exact, on the reference's weights and
  inputs.  The reference's interpreted tuner loop is not run (it is most
  of its example's time, and the port's tuner chooses among other
  candidates).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLM as RefSyntheticLM
from repro.kernels import q4_matmul as ref_q4_matmul
from repro.kernels import ref as ref_oracles
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.quant import quantize_q4_0 as ref_quantize_q4_0
from repro.training import AdamWConfig as RefAdamWConfig
from repro.training import init_opt_state as ref_init_opt_state
from repro.training import make_train_step as ref_make_train_step
from repro_torch.examples import (continuous_serving, hybrid_cpu_inference,
                                  q4_inference, quickstart, serve_batch,
                                  train_100m)
from repro_torch.models import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
QUICKSTART_FIRST_TOL = 1e-5
QUICKSTART_LAST_TOL = 1e-3   # relative; see the module docstring
Q4_TOL = 2e-5                # the reference's f32 kernel tolerance
EXAMPLES = {"quickstart": quickstart, "q4_inference": q4_inference,
            "hybrid_cpu_inference": hybrid_cpu_inference,
            "serve_batch": serve_batch,
            "continuous_serving": continuous_serving,
            "train_100m": train_100m}


def _reference(name):
    """The reference's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(capsys, fn, *args, **kwargs):
    capsys.readouterr()
    result = fn(*args, **kwargs)
    return capsys.readouterr().out.splitlines(), result


@pytest.fixture(scope="module")
def granite():
    """Reduced granite-8b with the reference's weights, in both packages."""
    cfg = ref_reduced("granite-8b")
    params = ref_init_params(cfg, jax.random.key(0))
    return cfg, params, params_from_numpy(jax.tree.map(np.asarray, params),
                                          device="cpu")


@pytest.mark.parametrize("name", ["hybrid_cpu_inference", "serve_batch",
                                  "continuous_serving"])
def test_virtual_clock_lines_equal_the_references(capsys, name):
    want, _ = _printed(capsys, _reference(name).main)
    got, _ = _printed(capsys, EXAMPLES[name].main, ["--device", "cpu"])
    assert got == want
    assert len(got) >= 4


def test_quickstart_scheduler_line_equals_the_references(capsys):
    want, _ = _printed(capsys, _reference("quickstart").demo_scheduler)
    assert want == [quickstart.demo_scheduler()]
    assert want[0] == "[scheduler] static 26.36 ms -> dynamic 15.39 ms (+71%)"


def _reference_quickstart_losses(cfg, params):
    """The reference's ``demo_training`` loop (examples/quickstart.py),
    every step's loss kept in full."""
    opt_cfg = RefAdamWConfig(lr=3e-3, warmup_steps=5, total_steps=30)
    data = iter(RefSyntheticLM(RefDataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=8, microbatch=4)))
    opt = ref_init_opt_state(params, opt_cfg)
    step = jax.jit(ref_make_train_step(cfg, opt_cfg))
    losses = []
    for _ in range(30):
        batch = {k: jnp.asarray(v) for k, v in next(data).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    return losses


def test_quickstart_training_against_the_reference(capsys, granite):
    cfg, params_r, params_p = granite
    want = _reference_quickstart_losses(cfg, params_r)
    lines, got = _printed(capsys, quickstart.main, ["--device", "cpu"],
                          params=params_p)
    losses = got["training"]["losses"]
    assert len(losses) == 30
    assert abs(losses[0] - want[0]) <= QUICKSTART_FIRST_TOL * abs(want[0])
    assert abs(losses[-1] - want[-1]) <= QUICKSTART_LAST_TOL * abs(want[-1])
    assert losses[-1] < 0.7 * losses[0]      # it trains
    assert lines == [got["scheduler"], got["training"]["line"]]
    assert lines[1] == (f"[training] loss {losses[0]:.3f} -> "
                        f"{losses[-1]:.3f} over 30 steps")


def test_q4_inference_against_the_reference(capsys, granite):
    cfg, params_r, params_p = granite
    ref_mod = _reference("q4_inference")
    _, n_ref = ref_mod.quantize_params(params_r)
    # the reference's inputs (examples/q4_inference.py), carried across
    w = params_r["period"][0]["mixer"]["wq"][0]
    qw_r = ref_quantize_q4_0(jnp.asarray(w).T)
    x = jax.random.normal(jax.random.key(1), (8, w.shape[0]), jnp.float32)
    toks = jax.random.randint(jax.random.key(2), (2, 16), 0, cfg.vocab_size)
    y_pallas = ref_q4_matmul(x, qw_r, interpret=True)
    y_float = x @ w
    quant_rel = float(jnp.abs(y_pallas - y_float).max()
                      / jnp.abs(y_float).max())
    qparams_r, _ = ref_mod.quantize_params(params_r)
    deq = jax.tree_util.tree_map(
        lambda l: (jnp.swapaxes(jax.vmap(ref_mod.dequantize_q4_0)(l), 1, 2)
                   .astype(cfg.cdtype) if l.packed.ndim == 3 else
                   ref_mod.dequantize_q4_0(l).T.astype(cfg.cdtype))
        if hasattr(l, "packed") else l,
        qparams_r, is_leaf=lambda l: hasattr(l, "packed"))
    lg_f = ref_forward(cfg, params_r, toks).logits
    lg_q = ref_forward(cfg, deq, toks).logits
    agree = float((jnp.argmax(lg_f, -1) == jnp.argmax(lg_q, -1)).mean())

    lines, got = _printed(capsys, q4_inference.main, ["--device", "cpu"],
                          params=params_p, x=torch.from_numpy(np.array(x)),
                          tokens=torch.from_numpy(np.array(toks)))
    assert got["n_quantized"] == n_ref == 7
    assert np.array_equal(got["qw"].packed.numpy(), np.asarray(qw_r.packed))
    assert np.array_equal(got["qw"].scales.numpy(), np.asarray(qw_r.scales))
    k = x.shape[1]
    oracle = np.asarray(ref_oracles.q4_matmul_ref(x, qw_r))
    np.testing.assert_allclose(got["y_kernel"].numpy(), oracle, rtol=Q4_TOL,
                               atol=Q4_TOL * k)
    assert got["route"] == "plain" and got["kernel_err"] <= Q4_TOL * k
    assert abs(got["quant_rel"] - quant_rel) <= 1e-5
    assert got["agree"] == agree
    assert got["variant"] in (("direct",), ("ring",))
    assert lines == got["lines"]
    assert lines[0] == ("[q4] quantized 7 weight matrices to Q4_0 "
                        "(0.5625 bytes/element vs 4)")
    assert lines[3].startswith(f"[q4] tuner selected variant "
                               f"{got['variant']} for shape (8, 64, 64)")


def test_q4_inference_seeded_run_quantizes_every_trunk_matrix(capsys):
    """Without a seam the example draws its own weights and inputs."""
    lines, got = _printed(capsys, q4_inference.main, ["--device", "cpu"])
    assert got["n_quantized"] == 7 and len(lines) == 4
    assert 0.0 < got["quant_rel"] < 0.3 and 0.0 <= got["agree"] <= 1.0


@pytest.mark.parametrize("argv", [[], ["--device", "cuda"]],
                         ids=["default", "cuda"])
@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_examples_run_on_the_card_or_raise(capsys, name, argv):
    """The default device is the card; without one every example raises
    before it prints a line, and none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        EXAMPLES[name].main(argv)
    assert capsys.readouterr().out == ""
