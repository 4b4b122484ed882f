"""Dense-decoder layers (a port of the attention / norm / rope / dense-FFN
part of ``repro.models.layers``).

Pure functions on tensors: ``init_*`` builds parameter dicts that mirror
the JAX pytree one to one, ``apply_*`` / ``*_fwd`` / ``*_step`` consume
them.  Parameters stay float32 and are cast to ``COMPUTE_DTYPE``
(bfloat16) where they are used, at the JAX package's casting points
(``compute_view`` casts every >=2-D float32 weight per block).  The
sharding constraints of the JAX package are dropped (distribution is
ROADMAP Queue 1 item 10).  The other mixers (RG-LRU, mLSTM, sLSTM, cross
attention) and FFNs (MoE, GELU/ReLU) wait for ROADMAP Queue 1 item 5.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

Params = dict
COMPUTE_DTYPE = torch.bfloat16

_LATER = "waits for ROADMAP Queue 1 item 5 (other mixers and FFNs)"


def _dense_init(shape, generator: torch.Generator, device, scale=None,
                reps: int | None = None):
    """Truncated normal on (-2, 2) times ``scale`` (default fan-in^-1/2),
    float32 — the distribution of the JAX ``_dense_init``.  ``reps`` adds
    a leading axis of independent draws (the stacked-layer layout)."""
    fan_in = shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    full = shape if reps is None else (reps, *shape)
    w = torch.empty(full, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(scale)


def compute_view(p, dtype=COMPUTE_DTYPE):
    """Cast every >=2-D float32 weight of a param tree to ``dtype`` (the
    JAX ``compute_view`` without its sharding constraints)."""
    if isinstance(p, dict):
        return {k: compute_view(v, dtype) for k, v in p.items()}
    if isinstance(p, (list, tuple)):
        return type(p)(compute_view(v, dtype) for v in p)
    if p.ndim >= 2 and p.dtype == torch.float32:
        return p.to(dtype)
    return p


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def _lead(reps, *shape):
    return shape if reps is None else (reps, *shape)


def init_norm(cfg: ModelConfig, d: int, device, reps=None) -> Params:
    p = {"scale": torch.ones(_lead(reps, d), dtype=torch.float32,
                             device=device)}
    if cfg.norm == "ln":
        p["bias"] = torch.zeros(_lead(reps, d), dtype=torch.float32,
                                device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    if "bias" in p:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        out = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps) \
            * p["scale"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def _rope_angles(positions: torch.Tensor, dh: int, theta: float):
    """positions (..., S) -> cos/sin (..., S, dh//2), float32."""
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections=None):
    """x: (B, S, H, dh); positions: (B, S).  Angles in float32, the
    rotation in the stream dtype."""
    if mrope_sections is not None:
        raise NotImplementedError(f"M-RoPE {_LATER}")
    cos, sin = _rope_angles(positions, x.shape[-1], theta)
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


# ---------------------------------------------------------------------------
# attention (GQA, global causal; local windows wait for Queue 1 item 5)
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, generator, device,
                   reps=None) -> Params:
    d, dh, h, kvh = cfg.d_model, cfg.dh, cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": _dense_init((d, h * dh), generator, device, reps=reps),
        "wk": _dense_init((d, kvh * dh), generator, device, reps=reps),
        "wv": _dense_init((d, kvh * dh), generator, device, reps=reps),
        "wo": _dense_init((h * dh, d), generator, device,
                          scale=1.0 / math.sqrt(h * dh), reps=reps),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", h * dh), ("bk", kvh * dh),
                            ("bv", kvh * dh)):
            p[name] = torch.zeros(_lead(reps, width), dtype=torch.float32,
                                  device=device)
    return p


def _project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    dh, h, kvh = cfg.dh, cfg.n_heads, cfg.n_kv_heads
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return (q.reshape(b, s, h, dh), k.reshape(b, s, kvh, dh),
            v.reshape(b, s, kvh, dh))


def attention_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, positions,
                  *, causal=True, with_cache=False):
    """Full-sequence global self-attention.  Returns y or (y, cache)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    q = q.transpose(1, 2)                                # (B, H, S, dh)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    o = ops.attention(q, k, v, causal=causal)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.dh)
    y = o @ p["wo"].to(x.dtype)
    if not with_cache:
        return y
    cache = {"k": k, "v": v,
             "len": torch.tensor(s, dtype=torch.int32, device=x.device)}
    return y, cache


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                    dtype=COMPUTE_DTYPE) -> Params:
    """Global-attention decode cache of ``max_len`` slots."""
    slots = max_len
    kvh, dh = cfg.n_kv_heads, cfg.dh
    return {
        "k": torch.zeros((batch, kvh, slots, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, kvh, slots, dh), dtype=dtype, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def attention_step(p: Params, x_t: torch.Tensor, cache: Params,
                   cfg: ModelConfig, pos):
    """One-token global-attention decode.  x_t: (B, 1, d); pos: scalar or
    (B,) int32.

    The new k/v are written into ``cache["k"]`` / ``cache["v"]`` in place
    (the JAX version returns updated copies); the returned cache holds the
    same storage with ``len = pos + 1``."""
    b = x_t.shape[0]
    dh, h = cfg.dh, cfg.n_heads
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x_t.device)
    per_row = pos.ndim == 1
    posb = pos[:, None] if per_row else pos.expand(b, 1)
    q, k, v = _project_qkv(p, x_t, cfg)
    q = apply_rope(q, posb, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, posb, cfg.rope_theta, cfg.mrope_sections)
    q = q.transpose(1, 2)                                # (B, H, 1, dh)
    k = k.transpose(1, 2)                                # (B, KVH, 1, dh)
    v = v.transpose(1, 2)
    ck, cv = cache["k"], cache["v"]
    slots = ck.shape[2]
    slot = (pos % slots).long()
    rows = torch.arange(b, device=x_t.device)
    slot_b = slot if per_row else slot.expand(b)
    ck[rows, :, slot_b] = k[:, :, 0].to(ck.dtype)
    cv[rows, :, slot_b] = v[:, :, 0].to(cv.dtype)
    o = ops.decode_attention(q, ck, cv, cache_len=pos + 1)
    o = o.transpose(1, 2).reshape(b, 1, h * dh)
    y = o @ p["wo"].to(x_t.dtype)
    return y, {"k": ck, "v": cv, "len": pos + 1}


# ---------------------------------------------------------------------------
# dense FFN
# ---------------------------------------------------------------------------

def init_ffn(cfg: ModelConfig, generator, device, reps=None) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.ffn != "swiglu":
        raise NotImplementedError(f"ffn={cfg.ffn!r} {_LATER}")
    return {"w_gate": _dense_init((d, f), generator, device, reps=reps),
            "w_in": _dense_init((d, f), generator, device, reps=reps),
            "w_out": _dense_init((f, d), generator, device, reps=reps)}


def apply_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    if "w_gate" not in p:
        raise NotImplementedError(f"ffn={cfg.ffn!r} {_LATER}")
    h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_in"].to(dt))
    return h @ p["w_out"].to(dt)
