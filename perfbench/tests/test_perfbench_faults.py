"""The harness's verdict on a run whose timed path is broken underneath:
everything of a run but the look for a card, on the CPU at a cut of each
cell (its limit the cell's), with the window stepped by a fixed clock.
Each fault that a served cell can have makes ``correct`` false; the sound
run is correct.  (The cells run on one card: there is no exchange between
chips to leave out.)"""

import pytest
import torch

from perfbench.harness import cell as cell_mod
from perfbench.harness import spec


class Tick:
    """A clock that advances a fixed step at every reading."""

    def __init__(self, dt: float = 0.002):
        self.t, self.dt = 0.0, dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


def run(root, name, tamper=None):
    c = spec.load_cell(name, root)
    return cell_mod.run(c, 2 ** 31 + 11, 0.5, False, torch.device("cpu"),
                        0.0, log=lambda *a: None, tamper=tamper,
                        clock=Tick())


def state_unchanged(sut):
    """The decode step leaves the slot caches' indices where they were."""
    from repro_torch.serving import DECODE

    eng = sut.engine

    def body(tok, pos):
        logits, _, recs = eng._run(tok, eng.manager.state, pos, DECODE)
        return logits, recs

    eng._decode_body = body


def half_batch(sut):
    """Half of the live rows left out of the decode step, each given the
    mean of the rest."""
    eng = sut.engine
    decode = eng._decode

    def step():
        logits, recs = decode()
        rows = [r.slot for r in eng._running]
        if len(rows) > 1:
            logits = logits.clone()
            logits[rows[1::2]] = logits[rows[0::2]].mean(0)
        return logits, recs

    eng._decode = step


def token_altered(sut):
    """Every third token the pick produces is the next id."""
    eng = sut.engine
    pick, n = eng._pick, [0]

    def altered(logits):
        tok = pick(logits)
        n[0] += 1
        return (tok + 1) % logits.shape[-1] if n[0] % 3 == 0 else tok

    eng._pick = altered


CELLS = ["tiny.closed", "tiny.open"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny_root, name):
    res = run(tiny_root, name)
    assert res["correct"], res["checks"]
    assert res["checks"]["served_tokens_checked"]["value"] > 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   token_altered])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(tiny_root, name, fault):
    res = run(tiny_root, name, tamper=fault)
    assert not res["correct"], res["checks"]
