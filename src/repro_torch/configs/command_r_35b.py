"""A copy of the JAX package's config of the same name (source in archs.py)."""

from .base import ModelConfig, MoEConfig, register

CONFIG = COMMAND_R_35B = register(ModelConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22528,
    vocab_size=256000, rope_theta=8e6, tie_embeddings=True,
))
