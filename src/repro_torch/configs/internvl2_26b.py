"""internvl2-26b [vlm] — InternLM2-20B backbone: 48L d6144 48H (GQA kv=8)
d_ff=16384 vocab 92553.  InternViT frontend is a STUB: input_specs provides
precomputed patch embeddings (n_prefix tokens). [arXiv:2404.16821; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    n_prefix=256,
)
