"""A copy of the JAX package's config of the same name (source in archs.py)."""

from .base import ModelConfig, MoEConfig, register

CONFIG = GRANITE_MOE_1B = register(ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
    vocab_size=49155, ffn="moe", moe=MoEConfig(n_experts=32, top_k=8),
    tie_embeddings=True, rope_theta=1e4,
))
