"""A copy of the JAX package's config of the same name (source in archs.py)."""

from .base import ModelConfig, MoEConfig, register

CONFIG = RECURRENTGEMMA_9B = register(ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_ff=12288,
    vocab_size=256000, head_dim=256,
    pattern=("rglru", "rglru", "attn_local"), window=2048,
    rnn_width=4096, tie_embeddings=True, rope_theta=1e4,
))
