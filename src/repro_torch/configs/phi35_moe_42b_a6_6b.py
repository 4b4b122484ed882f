"""A copy of the JAX package's config of the same name (source in archs.py)."""

from .base import ModelConfig, MoEConfig, register

CONFIG = PHI35_MOE = register(ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
    vocab_size=32064, ffn="moe", moe=MoEConfig(n_experts=16, top_k=2),
    rope_theta=1e4,
))
