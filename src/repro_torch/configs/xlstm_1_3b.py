"""A copy of the JAX package's config of the same name (source in archs.py)."""

from .base import ModelConfig, MoEConfig, register

CONFIG = XLSTM_1_3B = register(ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=50304, ffn="none",
    pattern=("mlstm",) * 7 + ("slstm",),   # xLSTM[7:1]
    rope_theta=1e4,
))
