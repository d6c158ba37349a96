"""Analytic per-device FLOP / HBM-byte accounting for the roofline.

Why analytic: XLA's ``cost_analysis`` counts a while-loop body ONCE, not
times its trip count (verified: a 10-iteration scanned matmul reports the
flops of one matmul).  Our trunk is scan-over-periods and
scan-over-microbatches, with further chunk scans inside Mamba/xLSTM, so
HLO-reported flops/bytes understate real work by the product of trip
counts, with mixed attribution that cannot be recovered from the aggregate
scalar.  Collectives ARE recovered from HLO (with while-trip attribution,
see roofline.py); flops/bytes use the standard accounting below and the raw
HLO numbers are reported alongside as a lower-bound cross-check.

All results are per device: global work / mesh size.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig
from repro_torch.configs import ShapeSpec


@dataclass
class AnalyticCost:
    flops: float       # per device
    hbm_bytes: float   # per device


def _layer_fwd_flops_per_token(cfg: ModelConfig, mixer: str, ffn: str,
                               kv_len: float) -> float:
    """Forward matmul+mixer FLOPs for one token of one layer.

    ``kv_len``: average attention span (S/2 causal for train/prefill; the
    full cache length for decode)."""
    d, hd = cfg.d_model, cfg.hd
    f = 0.0
    if mixer == "attn":
        f += 2 * d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads)   # qkv proj
        f += 2 * cfg.n_heads * hd * d                          # out proj
        f += 2 * cfg.n_heads * hd * kv_len * 2                 # scores + AV
    elif mixer == "mamba":
        s = cfg.ssm
        di, n = s.expand * d, s.d_state
        dtr = math.ceil(d / 16)
        f += 2 * d * 2 * di                     # in_proj
        f += 2 * s.d_conv * di                  # depthwise conv
        f += 2 * di * (dtr + 2 * n)             # x_proj
        f += 2 * dtr * di                       # dt_proj
        f += 10 * di * n                        # discretize + scan + gather
        f += 2 * di * n                         # y = h . C
        f += 2 * di * d + 4 * di                # out proj + gate
    elif mixer == "mlstm":
        x = cfg.xlstm
        di = int(x.proj_factor * d)
        dv = di // cfg.n_heads
        dk = max(8, int(x.qk_dim_factor * dv))
        l = x.chunk
        f += 2 * d * di * 2                     # up + z
        f += 2 * x.conv_kernel * di             # conv
        f += 2 * di * (2 * dk + dv)             # blockdiag qkv
        f += 2 * cfg.n_heads * l * (dk + dv)    # intra-chunk scores + AV
        f += 4 * cfg.n_heads * dv * dk          # state update + inter read
        f += 2 * di * d + 4 * di                # down + gating
    elif mixer == "slstm":
        dh = d // cfg.n_heads
        f += 2 * d * 4 * d                      # w_x
        f += 2 * d * 4 * dh                     # recurrent blockdiag
        f += 30 * d                             # pointwise cell math
        f += 2 * d * d                          # out proj
    if ffn == "dense":
        f += (6 if cfg.mlp == "swiglu" else 4) * d * cfg.d_ff
    elif ffn == "moe":
        m = cfg.moe
        dff = m.d_ff or cfg.d_ff
        f += 2 * d * m.n_experts                # router
        f += m.top_k * 6 * d * dff              # routed experts (swiglu)
        if m.shared_expert:
            f += 6 * d * dff
    return f


def forward_flops(cfg: ModelConfig, tokens: float, kv_len: float,
                  logits_positions: float) -> float:
    """Global forward FLOPs for ``tokens`` processed tokens."""
    per_tok = sum(
        _layer_fwd_flops_per_token(cfg, mixer, ffn, kv_len)
        for mixer, ffn in cfg.layer_plan()
    )
    f = tokens * per_tok
    f += logits_positions * 2 * cfg.d_model * cfg.vocab_size  # lm head
    return f


def param_bytes(cfg: ModelConfig) -> float:
    return cfg.param_count() * 2.0  # bf16


def active_param_bytes(cfg: ModelConfig) -> float:
    return cfg.active_param_count() * 2.0


def state_bytes_per_seq(cfg: ModelConfig, seq: int) -> float:
    """KV cache + recurrent state bytes for one sequence of length seq."""
    total = 0.0
    d = cfg.d_model
    for mixer, _ in cfg.layer_plan():
        if mixer == "attn":
            total += 2 * cfg.n_kv_heads * seq * cfg.hd * 2          # bf16 KV
        elif mixer == "mamba":
            s = cfg.ssm
            total += s.expand * d * s.d_state * 4 + (s.d_conv - 1) * s.expand * d * 2
        elif mixer == "mlstm":
            x = cfg.xlstm
            di = int(x.proj_factor * d)
            dv = di // cfg.n_heads
            dk = max(8, int(x.qk_dim_factor * dv))
            total += cfg.n_heads * (dv * dk + dk + 1) * 4
        elif mixer == "slstm":
            total += 4 * d * 4
    return total


def analyze_cell(cfg: ModelConfig, shape: ShapeSpec, n_devices: int,
                 *, remat: bool = True) -> AnalyticCost:
    d = cfg.d_model
    n_layers = cfg.n_layers
    p_dev = param_bytes(cfg) / n_devices

    if shape.kind == "train":
        tokens = shape.batch * shape.seq
        fwd = forward_flops(cfg, tokens, kv_len=shape.seq / 2,
                            logits_positions=tokens)
        # fwd(1x) + bwd(2x) + remat re-forward(1x)
        flops = fwd * (4.0 if remat else 3.0)
        # params re-read per microbatch pass (fwd+bwd+remat ~ 3) + grads +
        # optimizer state traffic + activation carries (bf16 rw per layer)
        n_micro = 8
        act_rw = tokens * d * n_layers * 2 * 2 * 2   # save+read, bf16, x2 safety
        hbm = (3 * n_micro * p_dev * n_devices        # param reads
               + 8 * param_bytes(cfg)                 # grad f32 rw
               + 12 * param_bytes(cfg)                # adam moments rw (f32)
               + act_rw) / n_devices
        return AnalyticCost(flops=flops / n_devices, hbm_bytes=hbm)

    if shape.kind == "prefill":
        tokens = shape.batch * shape.seq
        fwd = forward_flops(cfg, tokens, kv_len=shape.seq / 2,
                            logits_positions=shape.batch)
        act_rw = tokens * d * n_layers * 2 * 2
        kv_w = shape.batch * state_bytes_per_seq(cfg, shape.seq)
        hbm = (param_bytes(cfg) + act_rw + kv_w) / n_devices
        return AnalyticCost(flops=fwd / n_devices, hbm_bytes=hbm)

    # decode: one token per sequence; reads active params + the whole state
    tokens = shape.batch
    fwd = forward_flops(cfg, tokens, kv_len=shape.seq,
                        logits_positions=shape.batch)
    kv_r = shape.batch * state_bytes_per_seq(cfg, shape.seq)
    act = tokens * d * n_layers * 2 * 4
    hbm = (active_param_bytes(cfg) + kv_r + act) / n_devices
    return AnalyticCost(flops=fwd / n_devices, hbm_bytes=hbm)
