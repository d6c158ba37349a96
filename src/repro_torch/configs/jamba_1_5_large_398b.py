"""jamba-1.5-large-398b [hybrid] — 72L d8192 64H (GQA kv=8) d_ff=24576,
vocab 65536; Mamba:attention = 7:1 interleave, MoE (16e top-2) every other
layer.  Sub-quadratic (Mamba majority): eligible for long_500k.
[arXiv:2403.19887; hf]"""

from .base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    mixer_pattern=("mamba", "mamba", "mamba", "attn",
                   "mamba", "mamba", "mamba", "mamba"),
    moe=MoEConfig(n_experts=16, top_k=2, every=2, capacity_factor=1.25),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, chunk=32),
    sub_quadratic=True,
)
