"""granite-8b [arXiv:2405.04324] — the same fields as the JAX package's."""

from .base import ModelConfig, register

CONFIG = GRANITE_8B = register(ModelConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=49152, rope_theta=1e4,
))
