"""xlstm-1.3b [ssm] — 48 blocks d2048 4H vocab 50304; mLSTM:sLSTM = 7:1,
no separate FFN (projections live inside the blocks).  Sub-quadratic:
eligible for long_500k. [arXiv:2405.04517; unverified]"""

from .base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    mlp="none",
    mixer_pattern=("mlstm",) * 7 + ("slstm",),
    xlstm=XLSTMConfig(conv_kernel=4, qk_dim_factor=0.5, proj_factor=2.0,
                      chunk=64, slstm_every=8),
    sub_quadratic=True,
)
