"""llama2-7b — the paper's own evaluation model (Q4_0 weight-only quant):
32L d4096 32H (MHA) d_ff=11008 vocab 32000."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama2-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=32000,
)
