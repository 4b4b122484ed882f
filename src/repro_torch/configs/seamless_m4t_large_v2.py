"""A copy of the JAX package's config of the same name (source in archs.py)."""

from .base import ModelConfig, MoEConfig, register

CONFIG = SEAMLESS_M4T = register(ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab_size=256206, ffn="relu", norm="ln", enc_dec=True, n_enc_layers=24,
    rope_theta=1e4,
))
