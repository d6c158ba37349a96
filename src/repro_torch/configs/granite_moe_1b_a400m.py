"""granite-moe-1b-a400m [moe] — 24L d1024 16H (GQA kv=8) d_ff=512/expert,
vocab 49155, MoE 32 experts top-8, MoE on every layer (no dense MLP).
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    mlp="none",
    moe=MoEConfig(n_experts=32, top_k=8, every=1, capacity_factor=1.25),
)
