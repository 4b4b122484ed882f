"""Model assembly with forward / loss / prefill / decode entry points (a
port of ``repro.models.lm``): decoder LMs of global and local-window
attention, the RG-LRU and the xLSTM mixers (mLSTM, sLSTM), dense and MoE
FFNs, RoPE and M-RoPE, and the encoder-decoder (audio) variant, whose
bidirectional encoder runs over ``batch["src_embeds"]`` and whose
decoder blocks add cross attention to the encoder output.

The JAX package scans its repeating layer unit over stacked parameters;
here the stacked layout stays (every leaf of ``params["blocks"][u]``
carries a leading repeat axis, as do those of the encoder's
``params["encoder"]["blocks"]``) and the scan becomes a Python loop over
the repeats; remainder layers (recurrentgemma's 38 = 12 x 3 + 2) are
applied unstacked from ``params["tail"]``.

Decode writes the stacked cache buffers in place (K/V and ring slots by
one ``index_put_`` per layer, recurrent states and lengths by a copy into
the repeat's row) instead of returning copies; the returned cache trees
share that storage.

Under a sharding context the params are ``DTensor``s
(``sharding.distribute_params``) and each rank runs its own batch rows:
every weight is used through ``L.compute_view`` (the blocks, the
embedding, the unembedding, the final norm), which gathers it whole on
the data axes; ``shard`` stands at JAX's constraints.  Under a "model"
axis the blocks run tensor and expert parallel (``layers``), the
embedding is vocabulary-parallel (each rank looks up the tokens in its
rows, the rows summed over the axis) and so is the loss (the
log-sum-exp and the gold logit of each position combined over the axis,
:class:`_VocabLSE`); norms outside the blocks are gathered whole.

Serving runs under the same context, its weights plain tensors or
``DTensor``s (``make_ctx(mesh, fsdp=False)``: whole on the data axes,
split over "model", as JAX's dry run stores them).  Each rank runs its
own batch rows and holds its block of every cache leaf on the model axis
(``sharding.cache_spec``): its KV heads, or its slots of every KV head
(split-KV) where the axis does not divide them, its channels or heads of
a recurrent state.  The logits come back whole on every model rank (the
rank's vocabulary block gathered over the axis), so every model rank
samples the same tokens.  Where the axis does not divide the KV heads,
``decode_step`` needs the whole cache's ``max_len`` (and ``cross_len``)
to tell a split slot axis from a whole one: a block's slot count alone
does not say (at m = 4, 2 slots are a block of 8 or a whole cache of 2),
and the cache keeps JAX's tree (``k``, ``v``, ``len``), arrays only,
with no room for the count.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import shard
from . import layers as L

Params = dict

class _Recurrent(NamedTuple):
    init: Callable
    fwd: Callable
    step: Callable
    cache: Callable


#: the recurrent mixers' layer functions, by kind
_RECURRENT = {
    "rglru": _Recurrent(L.init_rglru, L.rglru_fwd, L.rglru_step,
                        L.init_rglru_cache),
    "mlstm": _Recurrent(L.init_mlstm, L.mlstm_fwd, L.mlstm_step,
                        L.init_mlstm_cache),
    "slstm": _Recurrent(L.init_slstm, L.slstm_fwd, L.slstm_step,
                        L.init_slstm_cache)}


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts, lists and tuples of
    tensors (params and caches), several trees of one structure at once."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _layout(cfg: ModelConfig) -> tuple[tuple[str, ...], int, tuple[str, ...]]:
    """(unit, n_repeats, tail_kinds) — the JAX package's layer layout."""
    kinds = cfg.layer_kinds()
    unit = tuple(cfg.pattern)
    n_rep = len(kinds) // len(unit)
    if n_rep == 0:                     # fewer layers than one unit (smoke)
        return tuple(kinds), 1, ()
    return unit, n_rep, kinds[n_rep * len(unit):]


def padded_vocab(cfg: ModelConfig) -> int:
    """Embedding rows padded to a multiple of 512; padded logits are
    masked to -1e30."""
    return -(-cfg.vocab_size // 512) * 512


def _window(cfg: ModelConfig, kind: str):
    return cfg.window if kind == "attn_local" else None


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _mixer(kind: str) -> str:
    """The block's param / cache key of its mixer."""
    return "attn" if kind in ("attn", "attn_local") else kind


def init_block(cfg: ModelConfig, kind: str, generator, device,
               reps: int | None = None, cross: bool = False) -> Params:
    """A block: norm and mixer, with ``cross`` a norm and cross attention
    (the decoder of an encoder-decoder), and the FFN except in the xLSTM
    blocks."""
    name = _mixer(kind)
    if name == "attn":
        init = L.init_attention
    elif kind in _RECURRENT:
        init = _RECURRENT[kind].init
    else:
        raise ValueError(kind)
    p: Params = {"norm1": L.init_norm(cfg, cfg.d_model, device, reps),
                 name: init(cfg, generator, device, reps)}
    if cross:
        p["norm_cross"] = L.init_norm(cfg, cfg.d_model, device, reps)
        p["cross"] = L.init_attention(cfg, generator, device, reps)
    if cfg.ffn != "none" and kind not in ("mlstm", "slstm"):
        p["norm2"] = L.init_norm(cfg, cfg.d_model, device, reps)
        init = L.init_moe if cfg.ffn == "moe" else L.init_ffn
        p["ffn"] = init(cfg, generator, device, reps)
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

    def emb(name):
        w = torch.empty((vp, cfg.d_model), dtype=torch.float32, device=dev)
        return L._keep(name, w.normal_(0.0, 1.0, generator=generator)
                       .mul_(0.02))

    p: Params = {"emb": emb("emb")}
    if not cfg.tie_embeddings:
        p["unemb"] = emb("unemb")
    p["final_norm"] = L.init_norm(cfg, cfg.d_model, dev)
    cross = cfg.enc_dec
    p["blocks"] = [init_block(cfg, kind, generator, dev, reps=n_rep,
                              cross=cross) for kind in unit]
    p["tail"] = [init_block(cfg, kind, generator, dev, cross=cross)
                 for kind in tail]
    if cfg.enc_dec:
        p["encoder"] = {"blocks": init_block(cfg, "attn", generator, dev,
                                             reps=cfg.n_enc_layers),
                        "norm": L.init_norm(cfg, cfg.d_model, dev)}
    return p


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _ffn(p: Params, x, cfg: ModelConfig):
    """The block's FFN half: (x, aux)."""
    h = L.apply_norm(p["norm2"], x, cfg.norm_eps)
    if cfg.ffn == "moe":
        out, aux = L.apply_moe(p["ffn"], h, cfg)
        return x + out, aux
    return x + L.apply_ffn(p["ffn"], h, cfg), None


def block_fwd(p: Params, x, kind: str, cfg: ModelConfig, positions, *,
              causal=True, enc_out=None, with_cache=False):
    """Full-sequence block (``enc_out``: the encoder output its cross
    attention reads).  Returns (x, aux, cache)."""
    p = L.compute_view(p, rule=L.model_rule(cfg))
    h = L.apply_norm(p["norm1"], x, cfg.norm_eps)
    cache = {}
    name = _mixer(kind)
    if name == "attn":
        out = L.attention_fwd(p["attn"], h, cfg, positions, causal=causal,
                              window=_window(cfg, kind),
                              with_cache=with_cache)
    else:
        out = _RECURRENT[kind].fwd(p[name], h, cfg, with_cache=with_cache)
    if with_cache:
        out, c = out
        cache = {name: c}
    x = x + out
    if "cross" in p:
        h = L.apply_norm(p["norm_cross"], x, cfg.norm_eps)
        out = L.attention_fwd(p["cross"], h, cfg, positions, causal=False,
                              kv_input=enc_out, rope=False)
        if with_cache:
            # projected again, as in JAX, for the decode cache: the rank's
            # KV heads, or its block of encoder positions (split-KV)
            ck, cv = _cross_kv(p["cross"], enc_out, cfg)
            if L.kv_split_dim(cfg, ck.shape[2]) == 2:
                n = ck.shape[2] // sharding.model_size()
                lo = sharding.model_rank() * n
                ck, cv = ck.narrow(2, lo, n), cv.narrow(2, lo, n)
            cache["cross_kv"] = {
                "k": ck, "v": cv,
                "len": torch.tensor(enc_out.shape[1], dtype=torch.int32,
                                    device=x.device)}
        x = x + out
    aux = None
    if "ffn" in p:
        x, aux = _ffn(p, x, cfg)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return shard(x, "btd"), aux, cache


def _cross_kv(p: Params, enc_out, cfg: ModelConfig):
    """The encoder output's cross-attention K/V, (B, KVH, Ts, dh) each, of
    the KV heads whose columns ``wk`` / ``wv`` hold."""
    b, ts, _ = enc_out.shape
    dh = cfg.dh
    dt = enc_out.dtype
    k = (enc_out @ p["wk"].to(dt)).reshape(b, ts, -1, dh).transpose(1, 2)
    v = (enc_out @ p["wv"].to(dt)).reshape(b, ts, -1, dh).transpose(1, 2)
    return k, v


def _slots(cfg: ModelConfig, kind: str, max_len: int | None):
    """The whole slot count of a ``kind`` layer's cache (None: unknown)."""
    if max_len is None:
        return None
    return min(cfg.window, max_len) if kind == "attn_local" else max_len


def _page(kind: str, page_size: int | None) -> int | None:
    """The page size of a ``kind`` layer's cache where a session pool
    pages it (its global-attention layers'), else None."""
    return page_size if kind == "attn" else None


def block_step(p: Params, x_t, cache: Params, kind: str, cfg: ModelConfig,
               pos, *, max_len: int | None = None,
               cross_len: int | None = None, page_size: int | None = None):
    """One-token decode.  Returns (x_t, cache).  ``max_len``,
    ``cross_len`` and ``page_size``: :func:`decode_step`."""
    p = L.compute_view(p, rule=L.model_rule(cfg, step=True))
    h = L.apply_norm(p["norm1"], x_t, cfg.norm_eps)
    name = _mixer(kind)
    if name == "attn":
        out, c = L.attention_step(p["attn"], h, cache["attn"], cfg, pos,
                                  window=_window(cfg, kind),
                                  slots=_slots(cfg, kind, max_len),
                                  page=_page(kind, page_size))
    else:
        out, c = _RECURRENT[kind].step(p[name], h, cache[name], cfg)
    cache = dict(cache, **{name: c})
    x_t = x_t + out
    if "cross" in p:
        h = L.apply_norm(p["norm_cross"], x_t, cfg.norm_eps)
        out, _ = L.attention_step(p["cross"], h, {}, cfg, pos,
                                  cross_kv=cache["cross_kv"],
                                  slots=cross_len)
        x_t = x_t + out
    if "ffn" in p:
        x_t, _ = _ffn(p, x_t, cfg)
    return x_t, cache


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     device, dtype=L.COMPUTE_DTYPE,
                     cross_len: int = 0) -> Params:
    """A block's zero decode cache; ``cross_len`` adds the cross-attention
    K/V of that many encoder positions."""
    if _mixer(kind) == "attn":
        c = {"attn": L.init_attn_cache(cfg, batch, max_len, device, dtype,
                                       window=_window(cfg, kind))}
    else:
        c = {kind: _RECURRENT[kind].cache(cfg, batch, device)}
    if cross_len:
        shape = sharding.cache_block_shape(
            "k", (batch, cfg.n_kv_heads, cross_len, cfg.dh))
        c["cross_kv"] = {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.tensor(cross_len, dtype=torch.int32,
                                device=device)}
    return c


def _rep(tree, r: int):
    return tree_map(lambda a: a[r], tree)


def _write_back(stacked: dict, views: dict, new: dict, r: int) -> None:
    """Store a block_step result at repeat ``r`` of the stacked cache:
    leaves the step wrote in place (the ``views`` it was given) stay, the
    others are copied into row ``r``."""
    for key, leaf in new.items():
        if isinstance(leaf, dict):
            _write_back(stacked[key], views[key], leaf, r)
        elif leaf is not views[key]:
            stacked[key][r] = leaf


# ---------------------------------------------------------------------------
# embeddings, positions and logits
# ---------------------------------------------------------------------------

def _embed(params: Params, cfg: ModelConfig, tokens,
           batch: dict | None = None):
    # gather, then cast: elementwise identical to casting the table first
    # (a distributed table: its bf16 cast gathered whole, the rows'
    # gradients accumulated in float32 all the same)
    emb = params["emb"]
    if sharding.is_distributed(emb):
        rows = sharding.embed_rows(emb, tokens.long(), L.COMPUTE_DTYPE)
    else:
        rows = emb[tokens.long()].to(L.COMPUTE_DTYPE)
    x = rows * math.sqrt(cfg.d_model)
    if (cfg.mrope_sections is not None and batch is not None
            and "patch_embeds" in batch):
        # vision patches replace the token embeddings at patch_pos
        pe = torch.as_tensor(batch["patch_embeds"]).to(x.device, x.dtype)
        pp = torch.as_tensor(batch["patch_pos"]).to(x.device).long()
        x[torch.arange(x.shape[0], device=x.device)[:, None], pp] = pe
    return shard(x, "btd")


def _mask_pad(logits, cfg: ModelConfig, lo: int = 0):
    """Padded vocabulary entries to -1e30; ``logits`` hold entries ``lo``
    onward (a model rank's block)."""
    vp = logits.shape[-1]
    if lo + vp <= cfg.vocab_size:
        return logits
    pad = torch.arange(lo, lo + vp, device=logits.device) >= cfg.vocab_size
    return logits.masked_fill(pad, -1e30)


def _norm(p: Params, cfg: ModelConfig, x):
    """A norm outside the blocks (final, encoder), through its view."""
    return L.apply_norm(L.compute_view(p), x, cfg.norm_eps)


def _logits(params: Params, cfg: ModelConfig, x):
    """The logits of ``x``, whole on every rank: under a model axis that
    divides the padded vocabulary each rank computes its block, gathered
    over the axis (JAX's ``out_shardings`` leave "model" off them)."""
    name = "emb" if cfg.tie_embeddings else "unemb"
    vocab = sharding.model_splits(padded_vocab(cfg))
    w = L.compute_view({name: params[name]},
                       rule=lambda _: 0 if vocab else None)[name]
    lo = sharding.model_rank() * w.shape[0] if vocab else 0
    logits = _mask_pad(shard(x @ w.to(x.dtype).T, "btv"), cfg, lo)
    return sharding.gather_model(logits, -1, partial=False) if vocab \
        else logits


def _positions(cfg: ModelConfig, batch: dict, s: int, b: int, device):
    """(B, S) positions, or (3, B, S) for M-RoPE (``batch["pos_ids"]``
    where given, else the text positions on all three axes)."""
    if cfg.mrope_sections is not None:
        if "pos_ids" in batch:
            return torch.as_tensor(batch["pos_ids"]).to(device, torch.int32)
        return torch.arange(s, dtype=torch.int32,
                            device=device)[None, None].expand(3, b, s)
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def _run_encoder(params: Params, cfg: ModelConfig, src_embeds, device):
    """The encoder stack over ``src_embeds`` (B, Ts, d), cast to
    ``COMPUTE_DTYPE``: bidirectional attention blocks at positions
    ``0 .. Ts-1``, then the encoder norm."""
    x = shard(torch.as_tensor(src_embeds).to(device, L.COMPUTE_DTYPE),
              "btd")
    b, ts, _ = x.shape
    pos = torch.arange(ts, dtype=torch.int32, device=device)[None].expand(
        b, ts)
    enc = params["encoder"]
    for blk in _split(enc["blocks"], cfg.n_enc_layers):
        x, _, _ = block_fwd(blk, x, "attn", cfg, pos, causal=False)
    return _norm(enc["norm"], cfg, x)


def _encode(params: Params, cfg: ModelConfig, batch: dict, device):
    """The encoder output of an encoder-decoder's batch, else None."""
    if not cfg.enc_dec:
        return None
    return _run_encoder(params, cfg, batch["src_embeds"], device)


# ---------------------------------------------------------------------------
# training-shaped forward and loss (differentiated by autograd; on the card
# attention runs the forward kernel under ops.attention's autograd Function)
# ---------------------------------------------------------------------------

def _split(tree, n: int) -> list:
    """The ``n`` repeats of a stacked tree, each leaf split once by
    ``unbind``: under autograd one node a leaf stacks the repeats'
    gradients, where indexing every repeat would give each its own
    zero-filled gradient of the whole stacked leaf."""
    if isinstance(tree, dict):
        parts = {k: _split(v, n) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [_split(v, n) for v in tree]
        return [type(tree)(p[r] for p in parts) for r in range(n)]
    if sharding.is_distributed(tree):
        return sharding.unbind_leading(tree)
    return list(tree.unbind(0))


def forward(params: Params, cfg: ModelConfig, batch: dict, *,
            remat: bool = True):
    """Full-sequence forward.  Returns (x_final, aux_loss).

    ``remat`` runs each repeat of the layer unit under
    ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, as
    JAX wraps its scanned unit in ``jax.checkpoint``: only the unit's
    input is kept, and the backward runs the unit's forward again (bit
    for bit the first: the flash kernel uses no atomics).  The tail
    layers and the encoder are not rematerialized, as in JAX.  JAX's
    ``REPRO_REMAT_POLICY`` (a ``jax.checkpoint_policies`` name) has no
    counterpart: the whole unit is recomputed."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed(params, cfg, tokens, batch)
    positions = _positions(cfg, batch, s, b, tokens.device)
    enc_out = _encode(params, cfg, batch, tokens.device)
    unit, n_rep, tail = _layout(cfg)

    def unit_body(x, aux, blks):
        for u, kind in enumerate(unit):
            x, a, _ = block_fwd(blks[u], x, kind, cfg, positions,
                                enc_out=enc_out)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for blks in zip(*(_split(blk, n_rep) for blk in params["blocks"])):
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                unit_body, x, aux, blks, use_reentrant=False,
                preserve_rng_state=False)
        else:
            x, aux = unit_body(x, aux, blks)
    for blk, kind in zip(params["tail"], tail):
        x, a, _ = block_fwd(blk, x, kind, cfg, positions, enc_out=enc_out)
        aux = aux + a
    return _norm(params["final_norm"], cfg, x), aux


class _VocabLSE(torch.autograd.Function):
    """``torch.logsumexp`` over the last dim of logits split over the
    model axis (each rank holds its vocabulary block), in its operations
    and order: the maximum (combined over the axis, infinities to 0), the
    sum of ``exp(x - max)`` (summed over the axis), its log plus the
    maximum; the backward ``grad * exp(x - lse)``, as torch's.  So at one
    model rank it equals ``torch.logsumexp`` bit for bit."""

    @staticmethod
    def forward(ctx, x):
        mx = sharding.model_max(torch.amax(x, -1, keepdim=True))
        mx.masked_fill_(mx.abs() == math.inf, 0)
        tot = sharding.model_sum((x - mx).exp_().sum(-1))
        lse = tot.log_().add_(mx.squeeze(-1))
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, grad):
        x, lse = ctx.saved_tensors
        return grad.unsqueeze(-1) * (x - lse.unsqueeze(-1)).exp()


def _vocab_gold(logits, labels, lo: int):
    """Each position's logit of its label from vocabulary-parallel logits
    (entries ``lo`` onward): the rank's own labels' logits, 0 elsewhere,
    summed over the model axis."""
    idx = labels - lo
    own = (idx >= 0) & (idx < logits.shape[-1])
    gold = logits.gather(-1, idx.clamp(0, logits.shape[-1] - 1)[..., None])
    gold = torch.where(own, gold[..., 0], 0.0)
    return sharding.leave_model(gold)


def loss_fn(params: Params, cfg: ModelConfig, batch: dict, *,
            remat: bool = True, loss_chunk: int = 1024):
    """Next-token cross entropy with sequence-chunked logits (never
    materializes (B, S, V): a chunk is (B, C, V)) plus the MoE aux loss.
    Returns (loss, {"ce", "aux"}).  Under a model axis that divides the
    padded vocabulary each rank computes its block of every chunk's
    logits, and the cross entropy combines over the axis."""
    x, aux = forward(params, cfg, batch, remat=remat)
    tokens = batch["tokens"]
    xs = x[:, :-1]
    labels = tokens[:, 1:].long()
    n = tokens.shape[1] - 1
    chunk = min(loss_chunk, n)
    while n % chunk:
        chunk -= 1
    name = "emb" if cfg.tie_embeddings else "unemb"
    vocab = sharding.model_splits(padded_vocab(cfg))
    w = L.compute_view({name: params[name]},
                       rule=lambda _: 0 if vocab else None)[name]
    lo = 0
    if vocab:
        xs = sharding.enter_model(xs)
        lo = sharding.model_rank() * w.shape[0]
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = 0
    for i in range(n // chunk):                          # ce_chunk
        sl = slice(i * chunk, (i + 1) * chunk)
        logits = _mask_pad(shard(xs[:, sl] @ w.to(xs.dtype).T, "btv")
                           .float(), cfg, lo)
        if vocab:
            lse = _VocabLSE.apply(logits)
            gold = _vocab_gold(logits, labels[:, sl], lo)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, labels[:, sl, None])[..., 0]
        tot = tot + torch.sum(lse - gold)
        cnt += gold.numel()
    ce = tot / cnt
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def prefill(params: Params, cfg: ModelConfig, batch: dict, max_len: int = 0,
            page_size: int | None = None):
    """Full-sequence forward returning the last position's logits and the
    per-layer decode caches: global-attn caches padded to ``max_len``
    slots, local-window caches laid out as rings, recurrent states after
    the last position, and an encoder-decoder's cross-attention K/V.
    Under a model axis, each leaf the rank's block (module docstring),
    taken as each layer's cache is made; ``page_size``: a session pool's,
    whose split-KV global-attn blocks hold the rank's slots of every
    page (``sharding.split_kv_slots``), ready to seat without a
    collective."""
    sharding.check_data_only(what="prefill")
    tokens = batch["tokens"]
    b, s = tokens.shape
    max_len = max(max_len, s)
    x = _embed(params, cfg, tokens, batch)
    positions = _positions(cfg, batch, s, b, tokens.device)
    enc_out = _encode(params, cfg, batch, tokens.device)
    unit, n_rep, tail = _layout(cfg)
    per_unit = [[] for _ in unit]
    for blks in zip(*(_split(blk, n_rep) for blk in params["blocks"])):
        for u, kind in enumerate(unit):
            x, _, c = block_fwd(blks[u], x, kind, cfg, positions,
                                enc_out=enc_out, with_cache=True)
            per_unit[u].append(_decode_layout(cfg, c, kind, s, max_len,
                                              _page(kind, page_size)))
    stacked = [tree_map(lambda *xs: torch.stack(xs), *cs)
               for cs in per_unit]
    tail_caches = []
    for blk, kind in zip(params["tail"], tail):
        x, _, c = block_fwd(blk, x, kind, cfg, positions, enc_out=enc_out,
                            with_cache=True)
        tail_caches.append(_decode_layout(cfg, c, kind, s, max_len,
                                          _page(kind, page_size)))
    x = _norm(params["final_norm"], cfg, x)
    logits = _logits(params, cfg, x[:, -1:])
    return logits, {"blocks": stacked, "tail": tail_caches}


def _decode_layout(cfg: ModelConfig, cache: dict, kind: str, s: int,
                   max_len: int, page: int | None = None) -> dict:
    """A layer's prefill cache re-laid out for decode (its attention K/V
    come back prompt-length): a global-attn cache padded with zeros to
    ``max_len`` slots, a local-window cache to a ``W = min(window,
    max_len)``-slot ring that holds position p at slot ``p % W`` (the last
    W positions, rolled into place; shorter prompts padded).  Under
    split-KV the rank takes its slots ``j`` of those
    (``sharding.split_kv_slots``: its block, or with ``page`` its part of
    every page): slot ``j`` holds position ``j`` (zero past the prompt),
    or on a ring shorter than the prompt ``s - W + (j - s + W) mod W``,
    JAX's whole-cache roll read at the rank's slots."""
    if "attn" not in cache:
        return cache
    k, v = cache["attn"]["k"], cache["attn"]["v"]       # slot axis -2
    whole = _slots(cfg, kind, max_len)
    if L.kv_split_dim(cfg, whole) == 2:
        j = sharding.split_kv_slots(whole, page, device=k.device)
    elif s == whole:
        return cache
    else:
        j = torch.arange(whole, device=k.device)
    if s > whole:
        src, keep = s - whole + (j - s + whole) % whole, None
    else:
        src, keep = j.clamp(max=s - 1), (j < s)[:, None]

    def lay(t):
        out = t.index_select(-2, src)
        return out if keep is None else torch.where(keep, out, 0)

    return dict(cache, attn={"k": lay(k), "v": lay(v),
                             "len": cache["attn"]["len"]})


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device=None,
                dtype=L.COMPUTE_DTYPE, cross_len: int = 0) -> dict:
    """Zero caches shaped for decode (``cross_len``: encoder positions of
    the cross-attention K/V); under a model axis the rank's blocks."""
    dev = resolve_device(device)
    unit, n_rep, tail = _layout(cfg)
    blocks = []
    for kind in unit:
        one = init_block_cache(cfg, kind, batch, max_len, dev, dtype,
                               cross_len)
        blocks.append(tree_map(
            lambda a: a[None].expand((n_rep,) + a.shape).clone(), one))
    tails = [init_block_cache(cfg, kind, batch, max_len, dev, dtype,
                              cross_len) for kind in tail]
    return {"blocks": blocks, "tail": tails}


def decode_step(params: Params, cfg: ModelConfig, tokens_t, caches: dict,
                pos, *, max_len: int | None = None,
                cross_len: int | None = None, page_size: int | None = None):
    """One decode step.  tokens_t: (B, 1); pos: scalar or (B,) int32.
    Returns (logits (B, 1, V), caches); the stacked cache buffers are
    written in place.  ``max_len`` (the prefill's, or ``init_caches``')
    and ``cross_len``: the whole caches' slots, needed only under a model
    axis that does not divide the KV heads; ``page_size``: a session
    pool's, where ``caches`` is its logical view (its split-KV
    global-attn slots interleaved by page)."""
    sharding.check_data_only(what="decode_step")
    x = _embed(params, cfg, tokens_t)
    unit, n_rep, tail = _layout(cfg)
    lens = dict(max_len=max_len, cross_len=cross_len, page_size=page_size)
    for r, blks in enumerate(zip(*(_split(blk, n_rep)
                                   for blk in params["blocks"]))):
        for u, kind in enumerate(unit):
            node = caches["blocks"][u]
            views = _rep(node, r)
            x, new = block_step(blks[u], x, views, kind, cfg, pos, **lens)
            _write_back(node, views, new, r)
    new_tail = []
    for blk, c, kind in zip(params["tail"], caches["tail"], tail):
        x, c = block_step(blk, x, c, kind, cfg, pos, **lens)
        new_tail.append(c)
    x = _norm(params["final_norm"], cfg, x)
    return _logits(params, cfg, x), {"blocks": list(caches["blocks"]),
                                     "tail": new_tail}


# ---------------------------------------------------------------------------
# serving: teacher-forced multi-token decode (draft verification)
# ---------------------------------------------------------------------------

def _snapshot_caches(cfg: ModelConfig, caches: dict) -> dict:
    """Per-step rollback snapshot: everything but global-attention K/V
    (append-only at slot == pos, rolled back by a length truncation) and
    cross-attention K/V (static during decode), so recurrent states,
    local-window rings and their lengths.  Views of the live caches,
    which decode updates in place: the caller copies them."""
    def strip(c, kind):
        out = {kk: vv for kk, vv in c.items() if kk != "cross_kv"}
        if kind == "attn":
            out.pop("attn", None)
        return out

    unit, _, tail = _layout(cfg)
    return {"blocks": [strip(c, k) for c, k in zip(caches["blocks"], unit)],
            "tail": [strip(c, k) for c, k in zip(caches["tail"], tail)]}


def decode_multi(params: Params, cfg: ModelConfig, tokens, caches: dict,
                 pos, *, max_len: int | None = None,
                 cross_len: int | None = None):
    """Teacher-forced decode over ``T`` tokens: token t is fed at position
    ``pos + t`` per row.  Returns ``(logits (B, T, V), caches, snaps)``
    with per-step rollback snapshots stacked on a leading T axis (each
    step copied straight into its slot: an xLSTM's matrix states are
    held T + 1 times, not 2T + 1).  Snapshots and rollback work on the
    rank's cache blocks as they are (``max_len`` / ``cross_len``:
    :func:`decode_step`)."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
    if pos.ndim == 0:
        pos = pos.expand(tokens.shape[0])
    n = tokens.shape[1]
    logits, snaps = [], None
    for t in range(n):
        lg, caches = decode_step(params, cfg, tokens[:, t:t + 1], caches,
                                 pos + t, max_len=max_len,
                                 cross_len=cross_len)
        logits.append(lg[:, 0])
        live = _snapshot_caches(cfg, caches)
        if snaps is None:
            snaps = tree_map(lambda a: a.new_empty((n, *a.shape)), live)
        tree_map(lambda buf, a: buf[t].copy_(a), snaps, live)
    return torch.stack(logits, dim=1), caches, snaps


def rollback_caches(cfg: ModelConfig, caches: dict, snaps: dict, idx) -> dict:
    """Roll a ``decode_multi`` result back to ``idx[b] + 1`` committed
    steps per row: snapshotted leaves (recurrent states, rings, their
    lengths) are gathered at each row's step on the device, global-attn
    K/V keep their buffers (a later ``kv_cache.truncate`` masks the
    rejected slots) and cross-attention K/V never changed."""
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
                out[kk] = tree_map(lambda s: sel(s, baxis), snap_c[kk])
        return out

    return {"blocks": [merge(c, sc, k, 2) for c, sc, k in
                       zip(caches["blocks"], snaps["blocks"], unit)],
            "tail": [merge(c, sc, k, 1) for c, sc, k in
                     zip(caches["tail"], snaps["tail"], tail)]}
