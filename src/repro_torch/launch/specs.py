"""Input specs for every (arch x shape) dry-run cell, as tensors on the
``meta`` device: shapes and dtypes, no storage (a port of
``repro.launch.specs``, whose ``jax.ShapeDtypeStruct`` trees they mirror
leaf for leaf).  Every tree is the whole one, as JAX's; a rank's blocks
come from the partition, batch and cache rules of
``repro_torch.distributed.sharding`` (``launch/dryrun.py``)."""

from __future__ import annotations

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.distributed import sharding
from repro_torch.models import lm
from repro_torch.train import optimizer as opt
from repro_torch.train._tree import map_with_path

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Training / prefill batch input specs."""
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": _sds((b, s), torch.int32)}
    if cfg.enc_dec:
        # stub audio frontend: precomputed frame embeddings, ~s/8 frames
        batch["src_embeds"] = _sds((b, max(s // 8, 16), cfg.d_model),
                                   torch.float32)
    if cfg.mrope_sections is not None:
        n_patch = min(256, s // 4)
        batch["patch_embeds"] = _sds((b, n_patch, cfg.d_model),
                                     torch.float32)
        batch["patch_pos"] = _sds((b, n_patch), torch.int32)
        batch["pos_ids"] = _sds((3, b, s), torch.int32)
    return batch


def decode_specs(cfg: ModelConfig, shape: ShapeConfig,
                 kv_dtype=torch.bfloat16) -> dict:
    """Decode-step input specs: one new token and a ``seq_len`` KV / state
    cache, whole (``kv_dtype=torch.float8_e4m3fn`` models a quantized KV
    cache for cells whose bf16 cache exceeds a card)."""
    b, s = shape.global_batch, shape.seq_len
    cross = max(s // 8, 16) if cfg.enc_dec else 0
    with sharding.use_sharding(sharding.ShardingCtx()):
        caches = lm.init_caches(cfg, b, max_len=s, device=META,
                                dtype=kv_dtype, cross_len=cross)
    return {"tokens_t": _sds((b, 1), torch.int32), "caches": caches,
            "pos": _sds((), torch.int32)}


def params_specs(cfg: ModelConfig, dtype=None):
    """Abstract params; ``dtype=torch.bfloat16`` models serving weights (no
    float32 master copies at inference): every >=2-D float32 leaf."""
    tree = lm.init_params(cfg, torch.Generator(), META)
    if dtype is None:
        return tree
    return map_with_path(
        lambda _, x: _sds(x.shape, dtype)
        if x.dtype == torch.float32 and x.ndim >= 2 else x, tree)


def opt_specs(params_shape) -> dict:
    return opt.init_opt_state(params_shape)


def shape_of(shape) -> ShapeConfig:
    """A ``ShapeConfig``, or the one of ``SHAPES`` so named."""
    return SHAPES[shape] if isinstance(shape, str) else shape


def input_specs(cfg: ModelConfig, shape_name) -> dict:
    """All abstract inputs for the step function of this cell
    (``shape_name``: a name of ``SHAPES``, or a ``ShapeConfig``)."""
    shape = shape_of(shape_name)
    if shape.kind == "train":
        params = params_specs(cfg)
        return {"params": params, "opt_state": opt_specs(params),
                "batch": batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"params": params_specs(cfg, torch.bfloat16),
                "batch": batch_specs(cfg, shape)}
    return {"params": params_specs(cfg, torch.bfloat16),
            **decode_specs(cfg, shape,
                           kv_dtype=kv_dtype_for(cfg, shape_name))}


def kv_dtype_for(cfg: ModelConfig, shape_name):
    """bf16 cache where it fits 256 cards; float8 where it does not (the
    big dense decode cells)."""
    shape = shape_of(shape_name)
    kinds = cfg.layer_kinds()
    attn_layers = sum(k in ("attn", "attn_local") for k in kinds)
    slots = min(cfg.window, shape.seq_len) if cfg.window else shape.seq_len
    bytes_bf16 = (2 * attn_layers * shape.global_batch * cfg.n_kv_heads
                  * slots * cfg.dh * 2)
    if cfg.enc_dec:
        bytes_bf16 *= 2
    per_chip = bytes_bf16 / 256
    return torch.bfloat16 if per_chip < 8e9 else torch.float8_e4m3fn
