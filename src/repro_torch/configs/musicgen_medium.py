"""musicgen-medium [audio] — 48L d1536 24H (MHA kv=24) d_ff=6144 vocab 2048,
decoder-only over EnCodec tokens.  The EnCodec frontend is a STUB:
input_specs provides precomputed frame embeddings (embed_input=True).
[arXiv:2306.05284; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    norm="layernorm",
    mlp="gelu",
    embed_input=True,
)
