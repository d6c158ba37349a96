"""Pipeline-parallel planning with the paper's proportional method.

At 512+ chips the cross-pod axis is DCN (~10x slower than ICI), so deep
models run pipeline stages across pods.  Two classic problems map directly
onto the paper's Eq. 3:

* **Stage balancing**: layers have unequal costs (jamba interleaves Mamba,
  attention and MoE layers) and stages may run on *heterogeneous* pods.
  The optimal contiguous split assigns each stage work proportional to its
  pod's measured throughput — exactly `s_i = pr_i / sum(pr) * s`, with a
  :class:`repro_torch.runtime.RatioTable` EMA feeding `pr` from observed stage
  times (pass it via ``plan_stages(..., table=..., key=...)``).
* **Schedule accounting**: 1F1B/GPipe bubble fraction = (S-1)/(M+S-1); the
  planner picks the microbatch count that keeps the bubble under a target,
  which trades against the per-microbatch weight-grad reduction traffic
  measured in EXPERIMENTS §Perf.

``plan_stages`` is exact for contiguous splits (DP over prefix sums) when
ratios are uniform, and proportional-greedy when they are not; both are
pure host-side planners (re-planned between steps, no recompilation
because stage assignment changes only which weights live where).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from . import ratio as R


@dataclass(frozen=True)
class PipelinePlan:
    boundaries: tuple      # stage s owns layers [boundaries[s], boundaries[s+1])
    stage_costs: tuple     # summed layer cost per stage (time units)
    stage_ratios: tuple    # pod throughput ratios used

    @property
    def n_stages(self) -> int:
        return len(self.stage_costs)

    @property
    def stage_times(self) -> tuple:
        return tuple(c / r for c, r in zip(self.stage_costs, self.stage_ratios))

    @property
    def makespan_per_microbatch(self) -> float:
        return max(self.stage_times)

    def bubble_fraction(self, n_microbatches: int) -> float:
        """1F1B bubble: (S-1) / (M + S-1)."""
        s = self.n_stages
        return (s - 1) / (n_microbatches + s - 1)

    def step_time(self, n_microbatches: int) -> float:
        """Ideal pipeline step time (ignoring comm): M*t_max + (S-1)*t_max."""
        return (n_microbatches + self.n_stages - 1) * self.makespan_per_microbatch


def _contiguous_split_dp(costs: np.ndarray, ratios: np.ndarray) -> list[int]:
    """Exact min-makespan contiguous split via DP over prefix sums.

    dp[s][i] = best makespan splitting layers[:i] into the first s stages;
    O(S * L^2) — fine for L <= a few hundred layers.
    """
    n_stages = len(ratios)
    n = len(costs)
    prefix = np.concatenate([[0.0], np.cumsum(costs)])
    inf = float("inf")
    dp = np.full((n_stages + 1, n + 1), inf)
    cut = np.zeros((n_stages + 1, n + 1), dtype=int)
    dp[0][0] = 0.0
    for s in range(1, n_stages + 1):
        for i in range(s, n + 1):
            # stage s-1 takes layers [j, i)
            for j in range(s - 1, i):
                t = (prefix[i] - prefix[j]) / ratios[s - 1]
                val = max(dp[s - 1][j], t)
                if val < dp[s][i]:
                    dp[s][i] = val
                    cut[s][i] = j
    bounds = [n]
    i = n
    for s in range(n_stages, 0, -1):
        i = cut[s][i]
        bounds.append(i)
    return list(reversed(bounds))


def plan_stages(
    layer_costs: Sequence[float],
    n_stages: int,
    stage_ratios: Optional[Sequence[float]] = None,
    *,
    table=None,
    key: str = "pipeline_stage",
) -> PipelinePlan:
    """Split layers into contiguous stages minimizing the pipeline makespan.

    ``stage_ratios``: per-stage pod throughput (repro_torch.runtime RatioTable
    EMAs at pod granularity); defaults to uniform.  Instead of a raw
    vector, a live ``table``/``key`` (:class:`repro_torch.runtime.RatioTable`)
    may be given and is read for the current ratios — replan between steps
    as stage-time feedback accumulates.  Stage s's ideal share of total
    work is ``ratios[s]/sum(ratios)`` (Eq. 3); the DP refines to the best
    layer-boundary realization.
    """
    costs = np.asarray(layer_costs, dtype=np.float64)
    if n_stages < 1 or n_stages > len(costs):
        raise ValueError("need 1 <= n_stages <= n_layers")
    if stage_ratios is None and table is not None:
        stage_ratios = table.ratios(key)
    ratios = (np.ones(n_stages) if stage_ratios is None
              else np.asarray(stage_ratios, dtype=np.float64))
    if len(ratios) != n_stages:
        raise ValueError("one ratio per stage")
    bounds = _contiguous_split_dp(costs, ratios)
    stage_costs = tuple(
        float(costs[bounds[s]: bounds[s + 1]].sum()) for s in range(n_stages)
    )
    return PipelinePlan(boundaries=tuple(bounds), stage_costs=stage_costs,
                        stage_ratios=tuple(float(r) for r in ratios))


def _layer_fwd_flops_per_token(cfg, mixer: str, ffn: str,
                               kv_len: float) -> float:
    """Forward matmul+mixer FLOPs for one token of one layer (a copy of
    the reference's analytic model, ``repro.launch.analytic``).

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


def layer_costs_from_config(cfg) -> list[float]:
    """Per-layer forward FLOPs (train-shape agnostic relative costs) from
    the analytic model — the planner's default cost vector."""
    return [
        _layer_fwd_flops_per_token(cfg, mixer, ffn, kv_len=2048.0)
        for mixer, ffn in cfg.layer_plan()
    ]


def choose_microbatches(plan: PipelinePlan, *, max_bubble: float = 0.1,
                        max_microbatches: int = 128) -> int:
    """Smallest microbatch count meeting the bubble target (fewer
    microbatches = fewer per-microbatch grad reductions — see §Perf)."""
    s = plan.n_stages
    if s == 1:
        return 1
    # (s-1)/(m+s-1) <= b  =>  m >= (s-1)(1-b)/b
    m = int(np.ceil((s - 1) * (1 - max_bubble) / max_bubble))
    return min(max(m, 1), max_microbatches)
