"""The weights both sides get: drawn from ``--seed`` on the device, one
call per stacked tensor, in the type they are served in.

The tree is the program's parameter layout (the shapes and types of its
``abstract_params``, written out here for the decoders the benchmark
runs: the port builds its own on meta tensors, whose first use costs a
process ~7 s); the values are the benchmark's own.  Norm scales are ones
and biases zeros; the token embedding is N(0, 1) times 0.02; every other
matrix N(0, 1) times ``d_in ** -0.5`` (its second-to-last dimension), as
the port's initialiser draws them.
"""

from __future__ import annotations

from typing import Tuple

import torch

Leaf = Tuple[tuple, torch.dtype]


def layout(cfg) -> dict:
    """(shape, dtype) of every parameter of the port's decoder ``cfg``
    (attention mixers, dense SwiGLU or MoE FFNs, RMSNorm)."""
    if cfg.norm != "rmsnorm" or cfg.mlp not in ("swiglu", "none"):
        raise NotImplementedError(f"no weight layout for {cfg.name}")
    f32, dt = torch.float32, cfg.cdtype
    d, hd, n = cfg.d_model, cfg.hd, cfg.n_periods
    period = []
    for mixer, ffn in cfg.period():
        if mixer != "attn":
            raise NotImplementedError(f"no weight layout for {mixer}")
        mix = {"wq": ((n, d, cfg.n_heads * hd), dt),
               "wk": ((n, d, cfg.n_kv_heads * hd), dt),
               "wv": ((n, d, cfg.n_kv_heads * hd), dt),
               "wo": ((n, cfg.n_heads * hd, d), dt)}
        if cfg.qkv_bias:
            mix.update(bq=((n, cfg.n_heads * hd), dt),
                       bk=((n, cfg.n_kv_heads * hd), dt),
                       bv=((n, cfg.n_kv_heads * hd), dt))
        p = {"norm1": {"w": ((n, d), f32)}, "mixer": mix}
        if ffn != "none":
            p["norm2"] = {"w": ((n, d), f32)}
            if ffn == "moe":
                m = cfg.moe
                e, f = m.n_experts, m.d_ff or cfg.d_ff
                if m.shared_expert:
                    raise NotImplementedError("no layout for shared experts")
                p["ffn"] = {"router": ((n, d, e), f32),
                            "wi": ((n, e, d, f), dt), "wg": ((n, e, d, f), dt),
                            "wo": ((n, e, f, d), dt)}
            else:
                p["ffn"] = {"wi": ((n, d, cfg.d_ff), dt),
                            "wg": ((n, d, cfg.d_ff), dt),
                            "wo": ((n, cfg.d_ff, d), dt)}
        period.append(p)
    embed = {"tok": ((cfg.vocab_size, d), dt)}
    if not cfg.tie_embeddings:
        embed["out"] = ((d, cfg.vocab_size), dt)
    return {"embed": embed, "period": period, "final_norm": {"w": ((d,), f32)}}


def _fill(path: str, leaf: Leaf, gen: torch.Generator,
          device) -> torch.Tensor:
    shape, dtype = leaf
    name = path.rsplit("/", 1)[-1]
    if "norm" in path:
        return torch.ones(shape, dtype=dtype, device=device)
    if name.startswith("b"):                  # qkv biases
        return torch.zeros(shape, dtype=dtype, device=device)
    scale = 0.02 if path.endswith("embed/tok") else shape[-2] ** -0.5
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device).mul_(scale)


def make_params(tree: dict, seed: int, device) -> dict:
    """Values for every leaf of a :func:`layout` tree, drawn in tree order
    from one generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(t)]
        return _fill(path, t, gen, device)

    return walk(tree, "")
