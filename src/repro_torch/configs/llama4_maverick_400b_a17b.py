"""llama4-maverick-400b-a17b [moe] — 48L d5120 40H (GQA kv=8) d_ff=8192,
vocab 202048, MoE 128 experts top-1 interleaved every other layer with a
shared expert (early-fusion backbone). [hf:meta-llama/Llama-4-*; unverified]"""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=128, top_k=1, every=2, capacity_factor=1.25,
                  shared_expert=True),
)
