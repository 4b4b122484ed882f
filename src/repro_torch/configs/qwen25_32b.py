"""A copy of the JAX package's config of the same name (source in archs.py)."""

from .base import ModelConfig, MoEConfig, register

CONFIG = QWEN25_32B = register(ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=27648,
    vocab_size=152064, qkv_bias=True, rope_theta=1e6,
))
