"""A benchmark root in a temporary directory with the cells' configurations
cut to a size the CPU runs in seconds (``tiny.closed`` on granite-8b's
layout, ``tiny.open`` on granite-moe-1b-a400m's), for driving the harness
on the plain path.  The cuts are the port's ``reduced_config`` sizes in
float32."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_DENSE = {
    "model": dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
                  num_key_value_heads=1, head_dim=16, intermediate_size=128,
                  vocab_size=512),
    "port": {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 1,
             "d_ff": 128, "vocab_size": 512, "attn_chunk": 16,
             "dtype": "float32"},
}
TINY_MOE = {
    "model": dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=16, intermediate_size=32,
                  num_local_experts=8, num_experts_per_tok=2,
                  vocab_size=512),
    "port": {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
             "d_ff": 32, "vocab_size": 512, "attn_chunk": 16,
             "dtype": "float32", "moe.n_experts": 8, "moe.top_k": 2,
             "moe.capacity_factor": 4.0},
}
TINY_TRAFFIC = {
    "tiny-closed": {"kind": "closed_loop", "clients": 4,
                    "prompt": {"dist": "uniform", "lo": 4, "hi": 20},
                    "output": {"dist": "uniform", "lo": 8, "hi": 24},
                    "first_output": {"dist": "uniform", "lo": 1, "hi": 24},
                    "slots": 4, "prefill_chunk": 8, "prefill_lanes": 1,
                    "sequence_seed": 1, "blocks": 4},
    "tiny-poisson": {"kind": "poisson", "rate": 100.0,
                     "prompt": {"dist": "lognormal", "median": 12,
                                "sigma": 0.8, "lo": 2, "hi": 40},
                     "output": {"dist": "uniform", "lo": 4, "hi": 16},
                     "slots": 6, "prefill_chunk": 8, "prefill_lanes": 1,
                     "sequence_seed": 1},
}
# tiny cell -> (cut configuration, its source file, traffic, the cell whose
# metrics and limit it takes)
TINY_CELLS = {
    "tiny.closed": ("tiny-dense", "granite-8b", "tiny-closed",
                    "granite-8b.q4.long-decode"),
    "tiny.open": ("tiny-moe", "granite-moe-1b-a400m", "tiny-poisson",
                  "granite-moe-1b-a400m.q4.chat-short"),
}


def make_tiny_root(dest: Path) -> Path:
    """Copy the benchmark into ``dest`` and add the tiny cells to it."""
    shutil.copytree(ROOT / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cuts = {"tiny-dense": TINY_DENSE, "tiny-moe": TINY_MOE}
    for cell, (name, src, traffic, like) in TINY_CELLS.items():
        config = json.loads((ROOT / f"perfbench/configs/{src}.json")
                            .read_text())
        config["name"] = name
        config["model"].update(cuts[name]["model"])
        config["port"] = {**config["port"], **cuts[name]["port"]}
        (dest / f"perfbench/configs/{name}.json").write_text(
            json.dumps(config))
        (dest / f"perfbench/traffic/{traffic}.json").write_text(
            json.dumps(TINY_TRAFFIC[traffic]))
        check = json.loads((ROOT / f"perfbench/checks/{like}.json")
                           .read_text())
        check.update(requests=4)
        (dest / f"perfbench/checks/{cell}.json").write_text(
            json.dumps(check))
        bench["configs"].append({"name": name, "source": "tiny",
                                 "file": f"perfbench/configs/{name}.json",
                                 "reduced": [], "why": "CPU tests"})
        bench["workloads"].append({"name": cell, "config": name,
                                   "traffic": traffic, "chips": 1,
                                   "why": "CPU tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda", 0)
