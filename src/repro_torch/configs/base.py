"""Model configuration (a copy of ``repro.configs.base``'s dataclasses).

``ModelConfig``, ``MoEConfig`` and ``smoke()`` are kept verbatim so that a
config built here describes exactly the model the JAX package builds from
the same fields; the port imports nothing of that package.  ``register`` /
``get_config`` form the ``--arch`` registry.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    moe: MoEConfig | None = None
    qkv_bias: bool = False
    norm: str = "rms"                 # rms | ln
    norm_eps: float = 1e-5
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    # layer pattern: repeating unit of mixer kinds; padded/truncated to n_layers.
    # kinds: attn | attn_local | rglru | mlstm | slstm
    pattern: tuple[str, ...] = ("attn",)
    window: int = 0                   # local-attention window (attn_local)
    ffn: str = "swiglu"               # swiglu | gelu | relu | moe | none(xlstm)
    # enc-dec (audio)
    enc_dec: bool = False
    n_enc_layers: int = 0
    # vlm
    mrope_sections: tuple[int, int, int] | None = None
    # ssm
    rnn_width: int = 0                # rglru recurrence width (0 -> d_model)
    conv_width: int = 4

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_kinds(self) -> tuple[str, ...]:
        reps = -(-self.n_layers // len(self.pattern))
        return (self.pattern * reps)[: self.n_layers]

    def smoke(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        changes = dict(
            n_layers=max(2, len(self.pattern)) if len(self.pattern) > 1 else 2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=16,
            d_ff=96 if self.d_ff else 0,
            vocab_size=128,
            window=min(self.window, 16) if self.window else 0,
            rnn_width=64 if self.rnn_width else 0,
        )
        if self.moe is not None:
            # drop-free capacity so prefill/decode consistency is exact
            changes["moe"] = MoEConfig(n_experts=4, top_k=min(self.moe.top_k, 2),
                                       capacity_factor=8.0)
        if self.enc_dec:
            changes["n_enc_layers"] = 2
        if self.mrope_sections:
            changes["mrope_sections"] = (2, 3, 3)
        return dataclasses.replace(self, **changes)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        d, dh, h, kvh = self.d_model, self.dh, self.n_heads, self.n_kv_heads
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        kinds = self.layer_kinds()
        for kind in kinds:
            if kind in ("attn", "attn_local"):
                total += d * dh * (h + 2 * kvh) + h * dh * d      # qkvo
                if self.qkv_bias:
                    total += dh * (h + 2 * kvh)
            elif kind == "rglru":
                w = self.rnn_width or d
                total += 2 * d * w + w * d + self.conv_width * w + 3 * w
            elif kind == "mlstm":
                up = 2 * d
                total += (2 * d * up                      # up + gate proj
                          + 3 * up * up // self.n_heads   # block-diag qkv
                          + up * 2 * self.n_heads         # i/f gates
                          + up * d)                       # down proj
            elif kind == "slstm":
                dh_s = d // self.n_heads
                total += d * 4 * d + self.n_heads * dh_s * 4 * dh_s + d * d
            # ffn
            if self.ffn == "moe":
                e = self.moe.n_experts
                total += d * e + e * (3 * d * self.d_ff)
            elif self.ffn == "swiglu":
                total += 3 * d * self.d_ff
            elif self.ffn in ("gelu", "relu"):
                total += 2 * d * self.d_ff
            total += 2 * d                                         # norms
        if self.enc_dec:
            # encoder layers: self-attn + ffn; decoder adds cross-attn
            total += self.n_enc_layers * (d * dh * (h + 2 * kvh) + h * dh * d
                                          + 2 * d * self.d_ff + 2 * d)
            total += self.n_layers * (d * dh * (h + 2 * kvh) + h * dh * d)
        return total

    def active_param_count(self) -> int:
        """Per-token active params (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.param_count()
        dense = dataclasses.replace(self, moe=None, ffn="swiglu")
        per_expert = 3 * self.d_model * self.d_ff
        return (dense.param_count() - self.n_layers * 3 * self.d_model * self.d_ff
                + self.n_layers * (self.moe.top_k * per_expert
                                   + self.d_model * self.moe.n_experts))


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from . import granite_8b  # noqa: F401  (populates the registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port has {sorted(_REGISTRY)} "
                       "(other archs: ROADMAP Queue 1 item 5)")
    return _REGISTRY[name]


def all_configs() -> dict[str, ModelConfig]:
    from . import granite_8b  # noqa: F401
    return dict(_REGISTRY)
