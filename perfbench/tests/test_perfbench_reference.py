"""The frozen plain reference against the port's engine, at a cut of each
configuration on the CPU: chunked prefill, then decode through the slot
cache with two live rows, compared on the logits the engine's sampler seam
sees at every step (the port's kernels run their plain versions here)."""

import numpy as np
import pytest
import torch

from perfbench.harness import spec, system
from perfbench.reference.decoder import Decoder, Spec


@pytest.mark.parametrize("arch", ["granite-8b", "granite-moe-1b-a400m"])
def test_weight_layout_is_the_ports(arch, tiny_root):
    """The benchmark's weights have the port's tree, shapes and types."""
    import json

    from repro_torch.models import abstract_params

    from perfbench.harness.weights import layout

    config = json.loads((tiny_root / f"perfbench/configs/{arch}.json")
                        .read_text())
    for cfg in (system.port_config(config),
                system.port_config(dict(config, **json.loads(
                    (tiny_root / "perfbench/configs/"
                     f"{'tiny-dense' if arch == 'granite-8b' else 'tiny-moe'}"
                     ".json").read_text())))):
        want = abstract_params(cfg)

        def same(a, b):
            if isinstance(b, dict):
                assert set(a) == set(b)
                for k in b:
                    same(a[k], b[k])
            elif isinstance(b, list):
                assert len(a) == len(b)
                for x, y in zip(a, b):
                    same(x, y)
            else:
                assert a == (tuple(b.shape), b.dtype)

        same(layout(cfg), want)


@pytest.mark.parametrize("name", ["tiny.closed", "tiny.open"])
def test_reference_follows_the_engine(tiny_root, name):
    from repro_torch.serving import PREFILL, Request

    cpu = torch.device("cpu")
    cell = spec.load_cell(name, tiny_root)
    cfg = system.port_config(cell.config)
    params = system.weights_for(cfg, 2 ** 31 + 3, cpu)
    sut = system.build(cell, cfg, params, cpu, 7)
    eng = sut.engine
    seen = {}
    pick = eng._pick

    def sampler(logits):
        # a prefill chunk's logits are its lane's; a decode step's rows are
        # the running requests' slots
        if logits.shape[0] == 1 and eng.scheduler.lanes:
            seen.setdefault(id(eng.scheduler.lanes[0]), []).append(logits[0])
        else:
            for r in eng._running:
                seen.setdefault(id(r), []).append(logits[r.slot])
        return pick(logits)

    eng._pick = sampler
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n,
                                        dtype=np.int32), max_new_tokens=6)
            for n in (19, 13)]
    for r in reqs:
        sut.inflight.submit(r)
    sut.inflight.run_until_idle()
    assert PREFILL == "prefill"

    ref = Decoder(Spec.from_config(cell.config), params, "f32")
    want = ref.logits([torch.as_tensor(r.tokens) for r in reqs],
                      [r.prompt_len for r in reqs])
    for r, w in zip(reqs, want):
        got = torch.stack(seen[id(r)])
        assert got.shape == w.shape == (6, cfg.vocab_size)
        scale = float(w.abs().max())
        # both float32 on the same Q4_0 codes: the sums' order differs
        assert float((got - w).abs().max()) <= 1e-4 * scale
        assert torch.equal(got.argmax(-1), w.argmax(-1))
