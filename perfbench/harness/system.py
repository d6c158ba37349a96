"""The system under test: the port's serving entry, built as

    python -m repro_torch.launch.serve --preset full --balanced-trunk \\
        --trunk-quant q4 --batch <slots> --prefill-chunk <chunk> ...

builds it (``repro_torch.launch.serve.setup`` and ``build_engines``: one
``ContinuousBatchingEngine`` over a compiled balanced trunk on a virtual
hybrid-CPU dispatcher, its decode step captured as one CUDA graph on the
card), behind an ``InflightDispatcher`` of one replica, on the weights the
benchmark made.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

# the configuration file's model keys -> the port's configuration fields
_PORT_KEYS = {
    "num_hidden_layers": "n_layers",
    "hidden_size": "d_model",
    "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv_heads",
    "head_dim": "hd",
    "vocab_size": "vocab_size",
    "rope_theta": "rope_theta",
    "tie_word_embeddings": "tie_embeddings",
}
_MOE_KEYS = {"num_local_experts": "n_experts", "num_experts_per_tok": "top_k"}


def port_config(config: dict):
    """The port's configuration for a configuration file: the registry's
    ``arch`` with the file's ``port`` fields set (``moe.<field>`` for the
    MoE's), checked against the file's ``model`` numbers."""
    from repro_torch.configs import get_config

    cfg = get_config(config["arch"])
    over = dict(config.get("port", {}))
    moe = {k[4:]: over.pop(k) for k in list(over) if k.startswith("moe.")}
    if moe:
        over["moe"] = dataclasses.replace(cfg.moe, **moe)
    cfg = dataclasses.replace(cfg, **over)
    model = config["model"]
    seen = {v: getattr(cfg, v) for v in _PORT_KEYS.values()}
    if cfg.moe is not None:
        seen.update({v: getattr(cfg.moe, v) for v in _MOE_KEYS.values()})
        seen["moe_d_ff"] = cfg.moe.d_ff or cfg.d_ff
    else:
        seen["d_ff"] = cfg.d_ff
    want = {_PORT_KEYS[k]: v for k, v in model.items() if k in _PORT_KEYS}
    want.update({_MOE_KEYS[k]: v for k, v in model.items() if k in _MOE_KEYS})
    if "intermediate_size" in model:
        want["moe_d_ff" if cfg.moe is not None else "d_ff"] = \
            model["intermediate_size"]
    bad = {k: (v, seen[k]) for k, v in want.items() if seen[k] != v}
    if bad:
        raise ValueError(f"{config['name']}: the port runs other sizes "
                         f"than the file states (file, port): {bad}")
    return cfg


def weights_for(cfg, seed: int, device) -> dict:
    """The benchmark's weights for the port's configuration ``cfg``."""
    from perfbench.harness.weights import layout, make_params

    return make_params(layout(cfg), seed, device)


@dataclass
class System:
    cfg: object
    device: object
    params: dict
    engine: object        # ContinuousBatchingEngine
    inflight: object      # InflightDispatcher
    max_seq: int


def serve_argv(cell, cfg, seed: int) -> list:
    t, dep = cell.traffic, cell.config["deployment"]
    out_hi = max(int(t["output"]["hi"]),
                 int(t.get("first_output", t["output"])["hi"]))
    return ["--arch", cfg.name, "--preset", "full",
            "--balanced-trunk", "--trunk-quant", dep["trunk_quant"],
            "--machine", dep["machine"],
            "--batch", str(t["slots"]), "--replicas", "1",
            "--prefill-chunk", str(t["prefill_chunk"]),
            "--prefill-lanes", str(t["prefill_lanes"]),
            "--prompt-len", str(t["prompt"]["hi"]),
            "--steps", str(out_hi), "--seed", str(seed % (2 ** 31 - 1))]


def build(cell, cfg, params: dict, device, seed: int) -> System:
    """The port's engine and dispatcher for ``cell`` on ``params``."""
    from repro_torch.launch import serve
    from repro_torch.runtime import RatioTable
    from repro_torch.serving import InflightDispatcher

    args = serve.build_parser().parse_args(
        serve_argv(cell, cfg, seed) + ["--device", device.type])
    cfg, device, params = serve.setup(args, params=params, cfg=cfg)
    engines, _ = serve.build_engines(args, cfg, params, device)
    inflight = InflightDispatcher(engines, table=RatioTable(1, alpha=0.3))
    return System(cfg=cfg, device=device, params=params, engine=engines[0],
                  inflight=inflight, max_seq=engines[0].max_seq)


def warm_up(system: System, chunk: int, lanes: int, seed: int) -> None:
    """Run every prefill chunk length and the decode step once (the first
    decode step captures the graph; the first launch builds and loads the
    kernel library), then leave the engine idle.  A prompt of
    ``2 * chunk - 1`` tokens splits into every length the scheduler gives,
    chunk, chunk / 2, ..., 1; one per lane."""
    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    eng = system.engine
    for n in [2 * chunk - 1] * lanes:
        if n + 2 > system.max_seq:
            raise ValueError(f"warm-up prompt of {n} does not fit max_seq "
                             f"{system.max_seq}")
        system.inflight.submit(Request(
            prompt=rng.integers(0, system.cfg.vocab_size, n, dtype=np.int32),
            max_new_tokens=2, arrival_time=eng.now))
    system.inflight.run_until_idle()
    system.inflight.poll_finished()
