"""Decoder-LM assembly with prefill / decode entry points (a port of the
pure-attention part of ``repro.models.lm``).

The JAX package scans its repeating layer unit over stacked parameters;
here the stacked layout stays (every leaf of ``params["blocks"][u]``
carries a leading repeat axis) and the scan becomes a Python loop over
the repeats.  Only the ``attn`` mixer kind is ported; the other kinds,
encoder-decoder and M-RoPE configs wait for ROADMAP Queue 1 item 5.

Decode writes K/V into the stacked cache buffers in place (one
``index_put_`` per layer) instead of returning copies; the returned cache
trees share that storage.
"""

from __future__ import annotations

import math

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from . import layers as L

Params = dict

_LATER = "waits for ROADMAP Queue 1 item 5 (other mixers and configs)"


def _tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _layout(cfg: ModelConfig) -> tuple[tuple[str, ...], int, tuple[str, ...]]:
    """(unit, n_repeats, tail_kinds) — the JAX package's layer layout."""
    if cfg.enc_dec or cfg.mrope_sections is not None or cfg.ffn == "moe":
        raise NotImplementedError(f"{cfg.name}: {_LATER}")
    kinds = cfg.layer_kinds()
    bad = sorted(set(kinds) - {"attn"})
    if bad:
        raise NotImplementedError(f"mixer kinds {bad} {_LATER}")
    unit = tuple(cfg.pattern)
    n_rep = len(kinds) // len(unit)
    if n_rep == 0:
        return tuple(kinds), 1, ()
    return unit, n_rep, kinds[n_rep * len(unit):]


def padded_vocab(cfg: ModelConfig) -> int:
    """Embedding rows padded to a multiple of 512; padded logits are
    masked to -1e30."""
    return -(-cfg.vocab_size // 512) * 512


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_block(cfg: ModelConfig, kind: str, generator, device,
               reps: int | None = None) -> Params:
    if kind != "attn":
        raise NotImplementedError(f"mixer {kind!r} {_LATER}")
    p: Params = {"norm1": L.init_norm(cfg, cfg.d_model, device, reps),
                 "attn": L.init_attention(cfg, generator, device, reps)}
    if cfg.ffn != "none":
        p["norm2"] = L.init_norm(cfg, cfg.d_model, device, reps)
        p["ffn"] = L.init_ffn(cfg, generator, device, reps)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None) -> Params:
    """Random parameters with the JAX pytree's structure, shapes and
    distributions (truncated-normal dense weights, N(0, 0.02²)
    embeddings), drawn from ``generator`` on ``device`` (``cuda`` unless
    asked otherwise).  The numbers differ from ``jax.random``'s."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    unit, n_rep, tail = _layout(cfg)
    vp = padded_vocab(cfg)

    def emb():
        w = torch.empty((vp, cfg.d_model), dtype=torch.float32, device=dev)
        return w.normal_(0.0, 1.0, generator=generator).mul_(0.02)

    p: Params = {"emb": emb()}
    if not cfg.tie_embeddings:
        p["unemb"] = emb()
    p["final_norm"] = L.init_norm(cfg, cfg.d_model, dev)
    p["blocks"] = [init_block(cfg, kind, generator, dev, reps=n_rep)
                   for kind in unit]
    p["tail"] = [init_block(cfg, kind, generator, dev) for kind in tail]
    return p


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def block_fwd(p: Params, x, kind: str, cfg: ModelConfig, positions, *,
              with_cache=False):
    """Full-sequence block.  Returns (x, cache)."""
    p = L.compute_view(p)
    h = L.apply_norm(p["norm1"], x, cfg.norm_eps)
    out = L.attention_fwd(p["attn"], h, cfg, positions,
                          with_cache=with_cache)
    cache = {}
    if with_cache:
        out, c = out
        cache = {"attn": c}
    x = x + out
    if "ffn" in p:
        h = L.apply_norm(p["norm2"], x, cfg.norm_eps)
        x = x + L.apply_ffn(p["ffn"], h, cfg)
    return x, cache


def block_step(p: Params, x_t, cache: Params, kind: str, cfg: ModelConfig,
               pos):
    """One-token decode.  Returns (x_t, cache)."""
    p = L.compute_view(p)
    h = L.apply_norm(p["norm1"], x_t, cfg.norm_eps)
    out, c = L.attention_step(p["attn"], h, cache["attn"], cfg, pos)
    cache = dict(cache, attn=c)
    x_t = x_t + out
    if "ffn" in p:
        h = L.apply_norm(p["norm2"], x_t, cfg.norm_eps)
        x_t = x_t + L.apply_ffn(p["ffn"], h, cfg)
    return x_t, cache


def _rep(tree, r: int):
    return _tree_map(lambda a: a[r], tree)


# ---------------------------------------------------------------------------
# embeddings and logits
# ---------------------------------------------------------------------------

def _embed(params: Params, cfg: ModelConfig, tokens):
    # gather, then cast: elementwise identical to casting the table first
    emb = params["emb"][tokens.long()].to(L.COMPUTE_DTYPE)
    return emb * math.sqrt(cfg.d_model)


def _mask_pad(logits, cfg: ModelConfig):
    vp = logits.shape[-1]
    if vp == cfg.vocab_size:
        return logits
    pad = torch.arange(vp, device=logits.device) >= cfg.vocab_size
    return logits.masked_fill(pad, -1e30)


def _logits(params: Params, cfg: ModelConfig, x):
    name = "emb" if cfg.tie_embeddings else "unemb"
    w = params[name].to(L.COMPUTE_DTYPE)
    return _mask_pad(x @ w.to(x.dtype).T, cfg)


def _positions(s: int, b: int, device):
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def prefill(params: Params, cfg: ModelConfig, batch: dict, max_len: int = 0):
    """Full-sequence forward returning the last position's logits and the
    per-layer decode caches, padded to ``max_len`` slots."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = _positions(s, b, tokens.device)
    unit, n_rep, tail = _layout(cfg)
    per_unit = [[] for _ in unit]
    for r in range(n_rep):
        for u, kind in enumerate(unit):
            x, c = block_fwd(_rep(params["blocks"][u], r), x, kind, cfg,
                             positions, with_cache=True)
            per_unit[u].append(c)
    stacked = [_tree_map(lambda *xs: torch.stack(xs), *cs)
               for cs in per_unit]
    tail_caches = []
    for blk, kind in zip(params["tail"], tail):
        x, c = block_fwd(blk, x, kind, cfg, positions, with_cache=True)
        tail_caches.append(c)
    x = L.apply_norm(params["final_norm"], x, cfg.norm_eps)
    logits = _logits(params, cfg, x[:, -1:])
    caches = {"blocks": stacked, "tail": tail_caches}
    return logits, _finalize_caches(cfg, caches, s, max(max_len, s))


def _finalize_caches(cfg: ModelConfig, caches, s: int, max_len: int):
    """Prefill attn caches come back prompt-length; global-attn caches are
    padded with zeros to ``max_len`` slots for decode."""
    def pad(node):
        k, v = node["attn"]["k"], node["attn"]["v"]
        if k.shape[-2] < max_len:
            extra = (0, 0, 0, max_len - k.shape[-2])
            k = torch.nn.functional.pad(k, extra)
            v = torch.nn.functional.pad(v, extra)
        return dict(node, attn={"k": k, "v": v, "len": node["attn"]["len"]})

    return {"blocks": [pad(c) for c in caches["blocks"]],
            "tail": [pad(c) for c in caches["tail"]]}


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device=None,
                dtype=L.COMPUTE_DTYPE) -> dict:
    """Zero caches shaped for decode."""
    dev = resolve_device(device)
    unit, n_rep, tail = _layout(cfg)
    blocks = []
    for _ in unit:
        one = L.init_attn_cache(cfg, batch, max_len, dev, dtype)
        blocks.append({"attn": _tree_map(
            lambda a: a[None].expand((n_rep,) + a.shape).clone(), one)})
    tails = [{"attn": L.init_attn_cache(cfg, batch, max_len, dev, dtype)}
             for _ in tail]
    return {"blocks": blocks, "tail": tails}


def decode_step(params: Params, cfg: ModelConfig, tokens_t, caches: dict,
                pos):
    """One decode step.  tokens_t: (B, 1); pos: scalar or (B,) int32.
    Returns (logits (B, 1, V), caches); K/V and ``len`` are written into
    the given cache buffers in place."""
    x = _embed(params, cfg, tokens_t)
    unit, n_rep, tail = _layout(cfg)
    for r in range(n_rep):
        for u, kind in enumerate(unit):
            node = caches["blocks"][u]
            x, new = block_step(_rep(params["blocks"][u], r), x,
                                _rep(node, r), kind, cfg, pos)
            node["attn"]["len"][r] = new["attn"]["len"]
    new_tail = []
    for blk, c, kind in zip(params["tail"], caches["tail"], tail):
        x, c = block_step(blk, x, c, kind, cfg, pos)
        new_tail.append(c)
    x = L.apply_norm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x), {"blocks": list(caches["blocks"]),
                                     "tail": new_tail}


# ---------------------------------------------------------------------------
# serving: teacher-forced multi-token decode (draft verification)
# ---------------------------------------------------------------------------

def _snapshot_caches(cfg: ModelConfig, caches: dict) -> dict:
    """Per-step rollback snapshot: everything but global-attention K/V
    (append-only at slot == pos, rolled back by a length truncation).
    What remains is copied, since decode updates caches in place."""
    def strip(c, kind):
        out = {kk: vv for kk, vv in c.items() if kk != "cross_kv"}
        if kind == "attn":
            out.pop("attn", None)
        return _tree_map(torch.clone, out)

    unit, _, tail = _layout(cfg)
    return {"blocks": [strip(c, k) for c, k in zip(caches["blocks"], unit)],
            "tail": [strip(c, k) for c, k in zip(caches["tail"], tail)]}


def decode_multi(params: Params, cfg: ModelConfig, tokens, caches: dict,
                 pos):
    """Teacher-forced decode over ``T`` tokens: token t is fed at position
    ``pos + t`` per row.  Returns ``(logits (B, T, V), caches, snaps)``
    with per-step rollback snapshots stacked on a leading T axis."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
    if pos.ndim == 0:
        pos = pos.expand(tokens.shape[0])
    logits, snaps = [], []
    for t in range(tokens.shape[1]):
        lg, caches = decode_step(params, cfg, tokens[:, t:t + 1], caches,
                                 pos + t)
        logits.append(lg[:, 0])
        snaps.append(_snapshot_caches(cfg, caches))
    snaps = _tree_map(lambda *xs: torch.stack(xs), *snaps)
    return torch.stack(logits, dim=1), caches, snaps


def rollback_caches(cfg: ModelConfig, caches: dict, snaps: dict, idx) -> dict:
    """Roll a ``decode_multi`` result back to ``idx[b] + 1`` committed
    steps per row: snapshotted leaves are gathered at each row's step,
    global-attn K/V keep their buffers (a later ``kv_cache.truncate``
    masks the rejected slots)."""
    unit, _, tail = _layout(cfg)
    idx = torch.as_tensor(idx, dtype=torch.long)

    def sel(leaf, baxis):
        moved = torch.movedim(leaf, baxis, 0)            # (B, T, ...)
        out = moved[torch.arange(moved.shape[0], device=leaf.device),
                    idx.to(leaf.device)]
        return torch.movedim(out, 0, baxis - 1)

    def merge(final_c, snap_c, kind, baxis):
        out = {}
        for kk, vv in final_c.items():
            if kk == "cross_kv" or (kind == "attn" and kk == "attn"):
                out[kk] = vv
            else:
                out[kk] = _tree_map(lambda s: sel(s, baxis), snap_c[kk])
        return out

    return {"blocks": [merge(c, sc, k, 2) for c, sc, k in
                       zip(caches["blocks"], snaps["blocks"], unit)],
            "tail": [merge(c, sc, k, 1) for c, sc, k in
                     zip(caches["tail"], snaps["tail"], tail)]}
