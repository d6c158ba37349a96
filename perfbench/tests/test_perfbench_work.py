"""The yardstick's work counts against values worked out by hand at the
cells' shapes, with the bfloat16 dense peak and live-context KV."""

import json
from pathlib import Path

import pytest

from perfbench.harness import work

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def model(name):
    return work.Model.from_config(
        json.loads((CONFIGS / f"{name}.json").read_text())["model"])


G8, MOE = model("granite-8b"), model("granite-moe-1b-a400m")
HBM, PEAK = 3.35e12, 989e12


def test_peaks():
    assert work.HBM_BYTES_PER_S == HBM
    assert work.BF16_FLOP_PER_S == PEAK      # not the f32 SIMT 67e12


def test_q4_launch_by_hand():
    # q at M = 32: 4096 x 4096 weights at 18 bytes per 32, x and y bf16
    b, f = work.q4_launch(32, 4096, 4096)
    assert b == 4096 * 4096 * 18 / 32 + 2 * (32 * 4096 + 32 * 4096)
    assert b == 9_961_472
    assert f == 2 * 32 * 4096 * 4096
    assert work.bound_s(b, f) == pytest.approx(9_961_472 / HBM)
    # a 512-row prefill chunk through it is compute-bound at the bf16 peak
    b, f = work.q4_launch(512, 4096, 4096)
    assert work.bound_s(b, f) == pytest.approx(2 * 512 * 4096 ** 2 / PEAK)


def test_launches_by_hand():
    assert len(work.q4_launches(G8, None, 32)) == 36 * 7 + 1
    assert len(work.q4_launches(MOE, None, 64)) == 24 * 4 + 1
    both = work.q4_launches(MOE, 256, 64)
    assert len(both) == 2 * 97
    assert both[0] == (256, 1024, 1024) and both[96] == (1, 49155, 1024)
    assert both[-1] == (64, 49155, 1024)
    assert work.q4_launches(G8, None, 32)[4:7] == [
        (32, 14336, 4096), (32, 14336, 4096), (32, 4096, 14336)]


def test_weight_bytes_by_hand():
    # granite-8b: per layer q 4096², k and v 1024·4096, o 4096², three
    # 14336·4096 MLP matrices; 36 layers; head 49152·4096; all Q4_0
    per_layer = 2 * 4096 ** 2 + 2 * 1024 * 4096 + 3 * 14336 * 4096
    q4 = (36 * per_layer + 49152 * 4096) * 18 / 32
    assert q4 == pytest.approx(4.530e9, rel=1e-3)
    norms = (2 * 36 + 1) * 4096 * 4
    assert work.weight_bytes(G8, 32) == q4 + norms + 32 * 4096 * 2
    # granite-moe: attention Q4_0, the router f32, the experts bf16
    q4 = (24 * (2 * 1024 ** 2 + 2 * 512 * 1024) + 49155 * 1024) * 18 / 32
    router = 24 * 1024 * 32 * 4
    one_token = 24 * 8 * 3 * 1024 * 512 * 2        # its 8 experts
    assert work.weight_bytes(MOE, 1) == pytest.approx(
        q4 + (2 * 24 + 1) * 1024 * 4 + 1024 * 2 + router + one_token)


def test_experts_touched():
    assert work.experts_touched(MOE, 1) == pytest.approx(8)
    assert work.experts_touched(MOE, 2) == pytest.approx(
        32 * (1 - 0.75 ** 2))
    assert work.experts_touched(MOE, 64) == pytest.approx(32, rel=1e-6)
    assert work.experts_touched(G8, 64) == 0


def test_decode_step_by_hand():
    # two live rows with 100 and 200 cache rows after their step: their KV
    # read once (live contexts only, whatever the buffer), weights once
    b, f = work.iteration_work(G8, None, [100, 200])
    kv = 2 * 36 * 8 * 128 * 2
    assert b == work.weight_bytes(G8, 2) + 300 * kv
    per_tok = 2 * 36 * (2 * 4096 ** 2 + 2 * 1024 * 4096 + 3 * 14336 * 4096)
    head = 2 * 4096 * 49152
    attn = 4 * 36 * 32 * 128 * 300
    assert f == 2 * (per_tok + head) + attn
    # decode at this size is bound by bytes
    assert work.iteration_bound_s(G8, None, [100, 200]) == pytest.approx(
        b / HBM)


def test_prefill_chunk_by_hand():
    # a last chunk of 4 tokens after 8: KV of 12 rows, causal pairs
    # 4·8 + 4·5/2, and the head once
    b, f = work.iteration_work(MOE, (8, 4, True), [])
    kv = 2 * 24 * 8 * 64 * 2
    assert b == work.weight_bytes(MOE, 4) + 12 * kv
    per_tok = 2 * 24 * (2 * 1024 ** 2 + 2 * 512 * 1024) \
        + 2 * 24 * (1024 * 32 + 8 * 3 * 1024 * 512)
    assert f == pytest.approx(4 * per_tok + 4 * 24 * 16 * 64 * (32 + 10)
                              + 2 * 1024 * 49155)
    b2, f2 = work.iteration_work(MOE, (8, 4, False), [])
    assert f - f2 == pytest.approx(2 * 1024 * 49155)
