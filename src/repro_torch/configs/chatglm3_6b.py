"""chatglm3-6b [dense] — 28L d4096 32H (GQA kv=2) d_ff=13696 vocab 65024,
2D RoPE (rotary on half the head dims), QKV bias. [arXiv:2406.12793; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope_fraction=0.5,
    qkv_bias=True,
)
