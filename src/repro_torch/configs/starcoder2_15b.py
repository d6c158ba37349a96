"""starcoder2-15b [dense] — 40L d6144 48H (GQA kv=4) d_ff=24576 vocab 49152,
LayerNorm + non-gated GeLU MLP, RoPE base 1e5. [arXiv:2402.19173; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    norm="layernorm",
    mlp="gelu",
    rope_theta=100_000.0,
)
