"""Model layers (a port of ``repro.models.layers``): GQA attention
(global, local-window, bidirectional and cross), RMS / layer norm, RoPE
and M-RoPE, the SwiGLU / GELU / ReLU FFNs, MoE with comparable-memory
top-k routing, the RG-LRU recurrent block (Griffin / RecurrentGemma) and
the xLSTM mixers: the mLSTM (chunkwise-parallel matrix memory) and the
sLSTM (stabilized scalar memory, a loop over time).

Pure functions on tensors: ``init_*`` builds parameter dicts that mirror
the JAX pytree one to one, ``apply_*`` / ``*_fwd`` / ``*_step`` consume
them.  Parameters stay float32 and are cast to ``COMPUTE_DTYPE``
(bfloat16) where they are used, at the JAX package's casting points
(``compute_view`` casts every >=2-D float32 weight per block).

Under a sharding context (``repro_torch.distributed.sharding``) each rank
runs its own batch rows: ``compute_view`` turns the params' ``DTensor``
blocks into weights whole on the data axes (the ZeRO-3 all-gather,
reduce-scattered in the backward), ``shard`` stands where JAX constrains
activations, and the MoE routes the global batch (capacity from the
global token count, queue positions after the lower ranks' tokens, the
dispatch buffer summed over the data ranks, load and importance averaged
over them).  Under a "model" axis (of any size) each rank computes the
part of every activation that JAX's ``act_spec`` gives it, between the
model axis's region operators: attention on its heads (its KV heads too
where the model axis divides them, else every KV head, from ``wk`` /
``wv`` gathered whole, narrowed to those its q heads read), the MLP on
its ``d_ff`` columns, the MoE on its experts (every rank routes every
token; each dispatches to and combines from its own experts), the RG-LRU
on its channels, the mLSTM on its heads; each ends in a row-parallel
product summed over the model axis.  The sLSTM, a ``shard_map`` over the
batch in JAX with every head on each device, runs its time loop on the
rank's own rows with every head and no collective inside.
:func:`model_rule` tells ``compute_view`` which block of each leaf a
layer reads.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.cpm.reference import comparable
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import shard
from repro_torch.kernels import ops, ref

Params = dict
COMPUTE_DTYPE = torch.bfloat16

#: where set (:func:`leaf_hook`), every parameter leaf passes through it
_LEAF_HOOK = None


@contextlib.contextmanager
def leaf_hook(fn):
    """Within the block, every parameter leaf the ``init_*`` functions draw
    goes through ``fn(name, tensor)`` as soon as it is drawn (``name`` its
    dict key, which is all ``param_spec`` reads of a path), and ``fn``'s
    result takes its place: a rank keeps its block of each leaf before the
    next is drawn, in the generator's order."""
    global _LEAF_HOOK
    prev, _LEAF_HOOK = _LEAF_HOOK, fn
    try:
        yield
    finally:
        _LEAF_HOOK = prev


def _keep(name: str, t: torch.Tensor):
    return t if _LEAF_HOOK is None else _LEAF_HOOK(name, t)



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


def _dense_leaves(generator, device, reps, leaves) -> Params:
    """``{name: _dense_init(shape, scale=scale)}`` of ``(name, shape,
    scale)`` triples, drawn in order, each through the leaf hook."""
    return {name: _keep(name, _dense_init(shape, generator, device,
                                          scale=scale, reps=reps))
            for name, shape, scale in leaves}


def compute_view(p, dtype=None, rule=None):
    """Cast every >=2-D float32 weight of a param tree to ``dtype``
    (default ``COMPUTE_DTYPE``, read at the call as the JAX callers pass
    ``L.COMPUTE_DTYPE``) and make every leaf whole on the data axes, and
    on the model axis as ``rule`` says: ``sharding.compute_view``."""
    return sharding.compute_view(p, COMPUTE_DTYPE if dtype is None
                                 else dtype, rule=rule)


def model_rule(cfg: ModelConfig, step: bool = False):
    """``compute_view``'s rule for a block of ``cfg``: the dim along which
    a layer reads the rank's block of each leaf (a column block feeding a
    split kind, a row block consuming one, the experts, the RG-LRU's
    channels, the mLSTM's heads), ``"partial"`` for ``wk`` / ``wv`` where
    the q heads are split and the KV heads are not, None for a leaf read
    whole (norms, the router, the sLSTM's ``rec_w``, every leaf of a
    layer whose kind the divisibility fallback replicates).  A decode
    ``step`` reads the column blocks of ``wk`` / ``wv`` wherever the axis
    divides their columns: the new token's k / v are gathered whole
    (``_project_qkv``), a token's worth, not the weights."""
    sp = sharding.model_splits
    heads, kv = sp(cfg.n_heads), sp(cfg.n_kv_heads)
    kv_rule = -1 if heads and kv else "partial" if heads else None
    if step and sp(cfg.n_kv_heads * cfg.dh):
        kv_rule = -1
    width = cfg.rnn_width or cfg.d_model
    table = {
        "attn": {"wq": -1, "bq": -1, "wo": -2} if heads else {},
        "ffn": {**({"w_gate": -1, "w_in": -1, "w_out": -2}
                   if cfg.d_ff and sp(cfg.d_ff) else {}),
                **({"expert_gate": -3, "expert_in": -3, "expert_out": -3}
                   if cfg.moe is not None and sp(cfg.moe.n_experts)
                   else {})},
        "rglru": dict.fromkeys(("wx", "wg", "conv_w", "a_param",
                                "w_input_gate"), -1) | {"wy": -2}
        if sp(width) else {},
        "mlstm": {"w_up": -1, "w_up_gate": -1, "wq": -3, "wk": -3,
                  "wv": -3, "w_if": -2, "w_down": -2} if heads else {},
        "slstm": {**({"wx": -1} if sp(4 * cfg.d_model) else {}),
                  **({"w_down": -2} if sp(cfg.d_model) else {})},
    }
    for name in ("wk", "wv", "bk", "bv"):
        table["attn"][name] = kv_rule
    table["cross"] = table["attn"]

    def rule(path: str):
        parent, name = path.split("/")[-2:]
        return table.get(parent, {}).get(name)

    return rule


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def _lead(reps, *shape):
    return shape if reps is None else (reps, *shape)


def init_norm(cfg: ModelConfig, d: int, device, reps=None) -> Params:
    p = {"scale": _keep("scale", torch.ones(_lead(reps, d),
                                            dtype=torch.float32,
                                            device=device))}
    if cfg.norm == "ln":
        p["bias"] = _keep("bias", torch.zeros(_lead(reps, d),
                                              dtype=torch.float32,
                                              device=device))
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
    """x: (B, S, H, dh); positions: (B, S), or (3, B, S) for M-RoPE (the
    three position axes each rotate their own section of the dh/2
    frequencies).  Angles in float32, the rotation in the stream dtype."""
    dh = x.shape[-1]
    if mrope_sections is None:
        cos, sin = _rope_angles(positions, dh, theta)    # (B, S, dh/2)
    else:
        cos3, sin3 = _rope_angles(positions, dh, theta)  # (3, B, S, dh/2)
        parts_c, parts_s, off = [], [], 0
        for i, sec in enumerate(mrope_sections):
            parts_c.append(cos3[i, ..., off:off + sec])
            parts_s.append(sin3[i, ..., off:off + sec])
            off += sec
        cos = torch.cat(parts_c, -1)
        sin = torch.cat(parts_s, -1)
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


# ---------------------------------------------------------------------------
# attention (GQA; global causal / local window / bidirectional / cross)
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, generator, device,
                   reps=None) -> Params:
    d, dh, h, kvh = cfg.d_model, cfg.dh, cfg.n_heads, cfg.n_kv_heads
    p = _dense_leaves(generator, device, reps, (
        ("wq", (d, h * dh), None), ("wk", (d, kvh * dh), None),
        ("wv", (d, kvh * dh), None),
        ("wo", (h * dh, d), 1.0 / math.sqrt(h * dh))))
    if cfg.qkv_bias:
        for name, width in (("bq", h * dh), ("bk", kvh * dh),
                            ("bv", kvh * dh)):
            p[name] = _keep(name, torch.zeros(_lead(reps, width),
                                              dtype=torch.float32,
                                              device=device))
    return p


def _project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 kv_input: torch.Tensor | None = None):
    """q from ``x``, k and v from ``kv_input`` (cross attention) or ``x``:
    (B, S, H, dh) and (B, Skv, KVH, dh), of the heads whose columns the
    weights hold (the rank's block under a model axis; k and v of every
    KV head where the weights hold a column block of KV heads the axis
    does not divide, gathered whole: ``model_rule(step=True)``)."""
    b, s, _ = x.shape
    dh = cfg.dh
    kv_x = x if kv_input is None else kv_input
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = kv_x @ p["wk"].to(dt)
    v = kv_x @ p["wv"].to(dt)
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if not sharding.model_splits(cfg.n_kv_heads) and \
            k.shape[-1] != cfg.n_kv_heads * dh:
        k = sharding.gather_model(k, -1, partial=False)
        v = sharding.gather_model(v, -1, partial=False)
    skv = kv_x.shape[1]
    return (q.reshape(b, s, -1, dh), k.reshape(b, skv, -1, dh),
            v.reshape(b, skv, -1, dh))


def _rank_kv_heads(t: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Of every KV head ``t`` (B, KVH, S, dh), those this model rank's q
    heads read (GQA: q head ``i`` reads KV head ``i // (H / KVH)``): a
    run of heads where the rank's q heads fall on them in equal groups,
    else one KV head for each q head."""
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    hl = h // sharding.model_size()
    lo = sharding.model_rank() * hl
    want = [(lo + i) // (h // kvh) for i in range(hl)]
    first, n = want[0], want[-1] - want[0] + 1
    if hl % n == 0 and want == [first + i // (hl // n) for i in range(hl)]:
        return t.narrow(1, first, n)
    return t.index_select(1, torch.tensor(want, device=t.device))


def attention_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, positions,
                  *, causal=True, window=None, kv_input=None,
                  kv_positions=None, rope=True, with_cache=False):
    """Full-sequence attention: self-attention over ``x`` (``window``:
    local, keys within ``window`` positions of the query; ``causal=False``:
    bidirectional), or cross attention from ``x`` to ``kv_input`` (keys at
    ``kv_positions`` where RoPE applies; the decoder's cross attention
    runs with ``causal=False, rope=False``).  Returns y or (y, cache).

    Under a model axis that divides the q heads, the rank runs its heads
    (``p`` holds their columns of ``wq`` and rows of ``wo``,
    :func:`model_rule`) and ``wo``'s partial sums are summed over the
    axis; its KV heads are its block where the axis divides them too,
    else those its q heads read of every KV head.  The cache holds the
    rank's KV heads where the axis divides them, else every KV head over
    the whole sequence (``lm.prefill`` keeps the rank's slots)."""
    b, s, _ = x.shape
    split = sharding.model_splits(cfg.n_heads)
    if split:
        x = sharding.enter_model(x)
        if kv_input is not None:
            kv_input = sharding.enter_model(kv_input)
    q, k, v = _project_qkv(p, x, cfg, kv_input)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        kpos = positions if kv_positions is None else kv_positions
        k = apply_rope(k, kpos, cfg.rope_theta, cfg.mrope_sections)
    q = shard(q.transpose(1, 2), "bhsd")                 # (B, H, S, dh)
    k, v = k.transpose(1, 2), v.transpose(1, 2)
    cache_kv = k, v
    if split and not sharding.model_splits(cfg.n_kv_heads):
        k, v = _rank_kv_heads(k, cfg), _rank_kv_heads(v, cfg)
    k, v = shard(k, "bhsd"), shard(v, "bhsd")
    o = ops.attention(q, k, v, causal=causal, window=window)
    o = shard(o, "bhsd").transpose(1, 2).reshape(b, s, -1)
    y = o @ p["wo"].to(x.dtype)
    if split:
        y = sharding.leave_model(y)
    y = shard(y, "btd")
    if not with_cache:
        return y
    cache = {"k": cache_kv[0], "v": cache_kv[1],
             "len": torch.tensor(s, dtype=torch.int32, device=x.device)}
    return y, cache


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                    dtype=COMPUTE_DTYPE, window: int | None = None) -> Params:
    """Decode cache of ``max_len`` slots; a local-window layer keeps a ring
    of ``min(window, max_len)`` slots, its oldest entry overwritten in
    place (``attention_step``).  Under a model axis, the rank's block
    (``sharding.cache_spec``): its KV heads, or its slots of every KV
    head."""
    slots = min(window, max_len) if window else max_len
    shape = sharding.cache_block_shape(
        "k", (batch, cfg.n_kv_heads, slots, cfg.dh))
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def kv_split_dim(cfg: ModelConfig, slots: int | None,
                 block_slots: int | None = None) -> int | None:
    """The dim of an attention cache (B, KVH, S, dh) of ``slots`` whole
    slots that the model axis splits (``sharding.cache_spec``): 1 where
    the axis divides the KV heads, else 2 where it divides the slots
    (split-KV), else None (every rank holds it whole; also without a
    model axis).  ``slots`` may be None where the axis divides the KV
    heads; ``block_slots``, a rank's block's, is checked against it."""
    if not sharding.model_parallel():
        return None
    if sharding.model_splits(cfg.n_kv_heads):
        return 1
    if slots is None:
        raise ValueError(
            f"{cfg.n_kv_heads} KV heads do not split over a model axis of "
            f"{sharding.model_size()}: the cache's whole slot count (the "
            f"decode step's max_len, cross_len) says whether its slots do")
    dim = sharding.cache_model_dim("k", (1, cfg.n_kv_heads, slots, cfg.dh))
    want = slots // sharding.model_size() if dim == 2 else slots
    if block_slots is not None and block_slots != want:
        raise ValueError(f"a cache block of {block_slots} slots is not the "
                         f"rank's {want} of {slots}")
    return dim


def _split_kv_attention(q, k, v, live, held):
    """Decode attention of q (B, H, 1, D), every q head, against the
    rank's block of a (B, KVH, S / m, D) cache, its slots the whole
    cache's slots ``held`` (``sharding.split_kv_slots``), the whole
    cache's first ``live`` slots (a scalar or (B,)) live: each rank
    takes its block's maximum, sum of exponentials and weighted V, the
    maxima combined with ``sharding.model_max``, the sums in one
    ``sharding.model_sum``.  ``ref.decode_attention_ref``'s operations
    otherwise, so float32 results agree to rounding."""
    b, h, _, d = q.shape
    kvh = k.shape[1]
    ct = torch.float32 if q.dtype == torch.float32 else torch.bfloat16
    qf = (q[:, :, 0].reshape(b, kvh, h // kvh, d)
          * ref._in_dtype(d ** -0.5, q.dtype)).to(ct)
    s = qf.float() @ k.to(ct).float().transpose(-1, -2)   # (B, KVH, G, sl)
    cl = torch.as_tensor(live, device=q.device)
    lim = cl if cl.ndim == 0 else cl[:, None, None, None]
    s = torch.where(held < lim, s, ref.NEG_INF)
    mx = sharding.model_max(s.amax(-1, keepdim=True))
    e = torch.exp(s - mx)
    part = sharding.model_sum(torch.cat(
        [e.to(ct).float() @ v.to(ct).float(), e.sum(-1, keepdim=True)], -1))
    out = part[..., :d] / part[..., d:]
    return out.reshape(b, h, 1, d).to(q.dtype)


def _attend_cache(q, ck, cv, live, cfg: ModelConfig, kdim, held=None):
    """Decode attention of the rank's q heads (every q head where the
    model axis does not split them) against a cache block split on
    ``kdim`` (:func:`kv_split_dim`; ``held``: the whole cache's slots
    that a split-KV block holds).  Split-KV gathers the q heads,
    combines every head's partial results over the axis and keeps the
    rank's; a cache whole on every rank is read at the KV heads the
    rank's q heads use."""
    split = sharding.model_splits(cfg.n_heads)
    if kdim == 2:
        if split:
            q = sharding.gather_model(q, 1, partial=False)
        o = _split_kv_attention(q, ck, cv, live, held)
        if split:
            hl = cfg.n_heads // sharding.model_size()
            o = o.narrow(1, sharding.model_rank() * hl, hl)
        return o
    if split and kdim is None:
        ck, cv = _rank_kv_heads(ck, cfg), _rank_kv_heads(cv, cfg)
    return ops.decode_attention(q, ck, cv, cache_len=live)


def attention_step(p: Params, x_t: torch.Tensor, cache: Params,
                   cfg: ModelConfig, pos, *, window=None, cross_kv=None,
                   slots: int | None = None, page: int | None = None):
    """One-token decode.  x_t: (B, 1, d); pos: scalar or (B,) int32.

    The new k/v are written into ``cache["k"]`` / ``cache["v"]`` at slot
    ``pos % slots`` in place (the JAX version returns updated copies); a
    ring's live slots are ``min(pos + 1, slots)``, in any order, since
    softmax does not care.  The returned cache holds the same storage
    with ``len = pos + 1``.

    With ``cross_kv`` (the encoder's K/V and its length) the step is cross
    attention: the query attends to the first ``cross_kv["len"]`` encoder
    positions, without RoPE, and ``cache`` comes back untouched.

    Under a model axis the rank runs its q heads where the axis divides
    them (``wo``'s partial sums summed over it) against its cache block
    (:func:`kv_split_dim`; ``slots``: the whole cache's slot count, or
    the cross length; ``page``: the page size where the cache is a paged
    pool's logical view, whose split-KV slots interleave by page,
    ``sharding.split_kv_slots``); under split-KV only the rank holding
    slot ``pos % slots`` writes the new k/v."""
    b = x_t.shape[0]
    dh, dt = cfg.dh, x_t.dtype
    split = sharding.model_splits(cfg.n_heads)
    if cross_kv is not None:
        ck, cv = cross_kv["k"], cross_kv["v"]
        q = x_t @ p["wq"].to(dt)
        if "bq" in p:
            q = q + p["bq"].to(dt)
        q = q.reshape(b, 1, -1, dh).transpose(1, 2)
        kdim = kv_split_dim(cfg, slots, ck.shape[2])
        held = (sharding.split_kv_slots(slots, device=x_t.device)
                if kdim == 2 else None)
        o = _attend_cache(q, ck, cv, cross_kv["len"], cfg, kdim, held)
        y = o.transpose(1, 2).reshape(b, 1, -1) @ p["wo"].to(dt)
        return shard(sharding.leave_model(y) if split else y, "btd"), cache
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x_t.device)
    per_row = pos.ndim == 1
    posb = pos[:, None] if per_row else pos.expand(b, 1)
    q, k, v = _project_qkv(p, x_t, cfg)
    if cfg.mrope_sections is not None:
        posb = posb.expand(3, b, 1)
    q = apply_rope(q, posb, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, posb, cfg.rope_theta, cfg.mrope_sections)
    q = q.transpose(1, 2)                                # (B, H, 1, dh)
    k = k.transpose(1, 2)                                # (B, KVH, 1, dh)
    v = v.transpose(1, 2)
    ck, cv = cache["k"], cache["v"]
    kdim = kv_split_dim(cfg, slots, ck.shape[2])
    whole = ck.shape[2] * (sharding.model_size() if kdim == 2 else 1)
    slot = (pos % whole).long()                          # the ring write
    rows = torch.arange(b, device=x_t.device)
    slot_b = slot if per_row else slot.expand(b)
    k_new, v_new = k[:, :, 0].to(ck.dtype), v[:, :, 0].to(cv.dtype)
    held = None
    if kdim == 2:
        # split-KV: the rank holding the slot writes it, the others write
        # back what they hold
        held = sharding.split_kv_slots(whole, page, device=x_t.device)
        local = torch.searchsorted(held, slot_b).clamp(max=ck.shape[2] - 1)
        own = (held[local] == slot_b)[:, None, None]
        slot_b = local
        k_new = torch.where(own, k_new, ck[rows, :, slot_b])
        v_new = torch.where(own, v_new, cv[rows, :, slot_b])
    ck[rows, :, slot_b] = k_new
    cv[rows, :, slot_b] = v_new
    live = pos + 1 if window is None else torch.clamp(pos + 1, max=whole)
    o = _attend_cache(q, ck, cv, live, cfg, kdim, held)
    y = o.transpose(1, 2).reshape(b, 1, -1) @ p["wo"].to(dt)
    y = shard(sharding.leave_model(y) if split else y, "btd")
    return y, {"k": ck, "v": cv, "len": pos + 1}


# ---------------------------------------------------------------------------
# dense FFNs
# ---------------------------------------------------------------------------

def init_ffn(cfg: ModelConfig, generator, device, reps=None) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    gate = (("w_gate", (d, f), None),) if cfg.ffn == "swiglu" else ()
    return _dense_leaves(generator, device, reps, gate + (
        ("w_in", (d, f), None), ("w_out", (f, d), None)))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def apply_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The dense FFN; under a model axis that divides ``d_ff``, on the
    rank's columns of ``w_gate`` / ``w_in`` and rows of ``w_out``, its
    partial sums summed over the axis."""
    dt = x.dtype
    split = sharding.model_splits(cfg.d_ff)
    if split:
        x = sharding.enter_model(x)
    if "w_gate" in p:
        h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_in"].to(dt))
    else:
        act = _gelu if cfg.ffn == "gelu" else F.relu
        h = act(x @ p["w_in"].to(dt))
    h = shard(h, "btf")
    y = h @ p["w_out"].to(dt)
    return shard(sharding.leave_model(y) if split else y, "btd")


# ---------------------------------------------------------------------------
# MoE with CPM comparable-memory routing
# ---------------------------------------------------------------------------

def init_moe(cfg: ModelConfig, generator, device, reps=None) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    return _dense_leaves(generator, device, reps, (
        ("router", (d, e), 0.02), ("expert_gate", (e, d, f), None),
        ("expert_in", (e, d, f), None), ("expert_out", (e, f, d), None)))


def moe_route(probs: torch.Tensor, k: int, cap: int):
    """Top-k capacity routing of (T, E) router probabilities: the
    comparable-memory mask, each token's k expert ids (highest probability
    first, ties by expert index: a stable sort, as ``jnp.argsort``), each
    (token, slot)'s queue position inside its expert in token order (an
    exact int32 prefix sum, as JAX's ``associative_scan`` of ``add``) and
    whether it fits the expert's ``cap`` slots.  Returns
    ``(mask, eidx, pos, keep)``.

    Over several data ranks the tokens are the rank's block of the global
    batch, which lists the ranks' blocks in coordinate order: each queue
    position counts the lower ranks' (token, slot)s of its expert first
    (one all-gather of the per-expert counts)."""
    t, e = probs.shape
    mask = comparable.topk_mask(probs, k)                # (T, E)
    masked = torch.where(mask, -probs, torch.inf)
    eidx = torch.argsort(masked, dim=-1, stable=True)[:, :k]
    flat = eidx.reshape(t * k)
    oh = F.one_hot(flat, e).to(torch.int32)              # (T*k, E)
    pos_flat = torch.cumsum(oh, dim=0, dtype=torch.int32) - 1
    pos = pos_flat.gather(1, flat[:, None])[:, 0].reshape(t, k)
    if sharding.dp_size() > 1:
        every = sharding.dp_gather(oh.sum(0, dtype=torch.int32))  # (n, E)
        lower = every[:sharding.dp_rank()].sum(0, dtype=torch.int32)
        pos = pos + lower[eidx]
    return mask, eidx, pos, pos < cap


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """Top-k capacity routing, dispatch into ``(E, cap, d)`` expert
    queues, SwiGLU experts and a gate-weighted combine.  Tokens past an
    expert's capacity are dropped: their (zero) values are added at
    ``(E-1, cap-1)``, exactly as JAX's ``.at[].add``.  Returns
    ``(y, aux_loss)``.

    Over several data ranks the routing is the global batch's, as JAX's
    (the dispatch is replicated over dp there): ``cap`` from the global
    token count, queue positions after the lower ranks' (``moe_route``),
    every rank's dispatch summed before the experts run (each slot holds
    one rank's token, so the sum is exact), and load and importance the
    means over the ranks before their product.

    Under a model axis that divides the experts (expert parallelism:
    ``p`` holds the rank's ``E / m`` experts, :func:`model_rule`) every
    model rank routes every token as above (the router and the aux loss
    are replicated over the axis), keeps the slots of its own experts, so
    no all-to-all is needed, combines their outputs only and sums the
    combine over the axis."""
    b, s, d = x.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    t = b * s
    dt = x.dtype
    n = sharding.dp_size()
    xt = x.reshape(t, d)
    scores = xt.float() @ p["router"].float()
    probs = torch.softmax(scores, dim=-1)                # (T, E)
    cap = max(int(cfg.moe.capacity_factor * t * n * k / e), 4)
    mask, eidx, pos, keep = moe_route(probs, k, cap)

    # load-balance loss: the fraction routed to each expert times its mean
    # probability, each over the global batch (equal blocks a rank)
    load = mask.float().mean(0)
    importance = probs.mean(0)
    if n > 1:
        load, importance = sharding.dp_mean(load), sharding.dp_mean(importance)
    aux = cfg.moe.router_aux_weight * e * torch.sum(load * importance)

    gates_k = probs.gather(1, eidx)                      # (T, k)
    gates_k = gates_k / torch.clamp(gates_k.sum(-1, keepdim=True), min=1e-9)

    zero = torch.zeros((), dtype=dt, device=x.device)
    split = sharding.model_splits(e)
    if split:
        # each rank dispatches its experts' tokens: their gradients, and
        # the gates', are the rank's part of every token's
        xt, gates_k = sharding.enter_model(xt), sharding.enter_model(gates_k)
    vals = torch.where(keep[..., None], xt[:, None, :], zero)
    sc_e = torch.where(keep, eidx, e - 1)
    sc_c = torch.where(keep, pos.long(), cap - 1)
    own, el = keep, e
    if split:
        el = e // sharding.model_size()
        sc_e = sc_e - sharding.model_rank() * el
        mine = (sc_e >= 0) & (sc_e < el)
        own = own & mine
        sc_e = torch.where(mine, sc_e, 0)
        vals = torch.where(mine[..., None], vals, zero)
    expert_x = torch.zeros((el, cap, d), dtype=dt, device=x.device)
    expert_x.index_put_((sc_e, sc_c), vals, accumulate=True)
    if n > 1:
        expert_x = sharding.dp_sum(expert_x)
    expert_x = shard(expert_x, "ecd")

    hg = torch.bmm(expert_x, p["expert_gate"].to(dt))
    hi = torch.bmm(expert_x, p["expert_in"].to(dt))
    h = shard(F.silu(hg) * hi, "ecf")
    eo = shard(torch.bmm(h, p["expert_out"].to(dt)), "ecd")  # (E, cap, d)

    gathered = eo[sc_e, sc_c]                            # (T, k, d)
    w = torch.where(own, gates_k, 0.0).to(dt)
    out = torch.einsum("tkd,tk->td", gathered, w)
    if split:
        out = sharding.leave_model(out)
    return shard(out.reshape(b, s, d), "btd"), aux


# ---------------------------------------------------------------------------
# RG-LRU (Griffin / RecurrentGemma recurrent block)
# ---------------------------------------------------------------------------

def init_rglru(cfg: ModelConfig, generator, device, reps=None) -> Params:
    d = cfg.d_model
    w = cfg.rnn_width or d
    # a_param set so that a = sigmoid(a_param) lies in [0.9, 0.999]
    u = torch.empty(_lead(reps, w), dtype=torch.float32, device=device)
    u.uniform_(0.9, 0.999, generator=generator)
    return {
        **_dense_leaves(generator, device, reps, (
            ("wx", (d, w), None), ("wg", (d, w), None), ("wy", (w, d), None),
            ("conv_w", (cfg.conv_width, w), 0.1))),
        "a_param": _keep("a_param", torch.log(u / (1 - u))),
        # [input gate, recurrence gate], diagonal
        "w_input_gate": _keep("w_input_gate", torch.zeros(
            _lead(reps, 2, w), dtype=torch.float32, device=device)),
    }


_RGLRU_C = 8.0


def _rglru_coeffs(x, a_param, gate_x, rec_x):
    """(a_t, b_t) of h_t = a_t h_{t-1} + b_t, float32."""
    log_a = -_RGLRU_C * F.softplus(a_param) * torch.sigmoid(rec_x)
    a = torch.exp(log_a)
    gated = x * torch.sigmoid(gate_x)
    b = torch.sqrt(torch.clamp(1 - torch.exp(2 * log_a), min=1e-12)) * gated
    return a, b


def _rglru_scan(x: torch.Tensor, a_param, gate_x, rec_x, h0=None):
    """h_t = a_t*h_{t-1} + sqrt(1-a_t^2)*(i_t*x_t) over the time axis (1)
    of (B, S, W) inputs, by a log-depth scan: at strides 1, 2, 4, ...
    each step t >= stride combines the pair ending at t - stride into its
    own, ``(a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2)`` (the paper's §8
    super-connectivity along the sequence).  JAX's ``associative_scan``
    combines in another order, so float32 results agree to rounding, not
    bit for bit."""
    a, b = _rglru_coeffs(x, a_param, gate_x, rec_x)
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], 1)
    s, stride = x.shape[1], 1
    while stride < s:
        b = torch.cat([b[:, :stride],
                       b[:, :-stride] * a[:, stride:] + b[:, stride:]], 1)
        a = torch.cat([a[:, :stride], a[:, :-stride] * a[:, stride:]], 1)
        stride *= 2
    return b


def rglru_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig,
              with_cache=False):
    """The RG-LRU block; under a model axis that divides its width, on
    the rank's channels (``p`` holds their columns of ``wx`` / ``wg`` /
    ``conv_w``, their gates and rows of ``wy``, :func:`model_rule`): the
    scan is channel-wise, so it runs on the rank's alone, and ``wy``'s
    partial sums are summed over the axis."""
    b, s, _ = x.shape
    dt = x.dtype
    split = sharding.model_splits(cfg.rnn_width or cfg.d_model)
    if split:
        x = sharding.enter_model(x)
    branch = (x @ p["wx"].to(dt)).float()                # (B, S, W)
    gate = _gelu((x @ p["wg"].to(dt)).float())
    # short depthwise causal conv (Griffin's temporal conv, width 4);
    # compute_view made conv_w and the gates bf16, promoted to float32 here
    # as in JAX
    conv = torch.zeros_like(branch)
    for i in range(cfg.conv_width):
        shifted = F.pad(branch, (0, 0, i, 0))[:, :s]
        conv = conv + shifted * p["conv_w"][i]
    ig = conv * torch.sigmoid(p["w_input_gate"][0])
    rg = conv * torch.sigmoid(p["w_input_gate"][1])
    h = _rglru_scan(conv, p["a_param"], ig, rg)
    y = (h.to(dt) * gate.to(dt)) @ p["wy"].to(dt)
    y = shard(sharding.leave_model(y) if split else y, "btd")
    if not with_cache:
        return y
    cw = cfg.conv_width
    if s >= cw - 1:
        buf = branch[:, s - (cw - 1):]
    else:
        buf = F.pad(branch, (0, 0, cw - 1 - s, 0))
    return y, {"h": h[:, -1].float(), "conv_buf": buf}


def _zero_blocks(shapes: dict, device, fill: dict | None = None) -> Params:
    """float32 state leaves of whole ``shapes`` (by cache key), each the
    rank's block on the model axis (``sharding.cache_block_shape``),
    zero or ``fill[key]``."""
    fill = fill or {}
    return {k: torch.full(sharding.cache_block_shape(k, shape),
                          fill.get(k, 0.0), dtype=torch.float32,
                          device=device)
            for k, shape in shapes.items()}


def _state_blocks(state: Params) -> Params:
    """Whole state leaves cut to the rank's blocks on the model axis."""
    out = {}
    for k, x in state.items():
        d = sharding.cache_model_dim(k, tuple(x.shape))
        if d is not None:
            n = x.shape[d] // sharding.model_size()
            x = x.narrow(d, sharding.model_rank() * n, n)
        out[k] = x
    return out


def _state_whole(state: Params, shapes: dict) -> Params:
    """The model ranks' blocks of state leaves of whole ``shapes``,
    gathered whole (the inverse of :func:`_state_blocks`)."""
    out = {}
    for k, x in state.items():
        d = sharding.cache_model_dim(k, shapes[k])
        out[k] = x if d is None else sharding.gather_model(x, d,
                                                           partial=False)
    return out


def init_rglru_cache(cfg: ModelConfig, batch: int, device) -> Params:
    w = cfg.rnn_width or cfg.d_model
    return _zero_blocks({"h": (batch, w),
                         "conv_buf": (batch, cfg.conv_width - 1, w)}, device)


def rglru_step(p: Params, x_t: torch.Tensor, cache: Params,
               cfg: ModelConfig):
    """One step; under a model axis that divides the width, on the rank's
    channels (its block of the state), ``wy``'s partial sums summed."""
    dt = x_t.dtype
    branch = (x_t[:, 0] @ p["wx"].to(dt)).float()       # (B, W)
    gate = _gelu((x_t[:, 0] @ p["wg"].to(dt)).float())
    hist = torch.cat([cache["conv_buf"], branch[:, None]], dim=1)
    # conv_w[i] multiplies the value i steps in the past; hist is oldest first
    conv = torch.einsum("bcw,cw->bw", hist.flip(1), p["conv_w"].float())
    ig = conv * torch.sigmoid(p["w_input_gate"][0])
    rg = conv * torch.sigmoid(p["w_input_gate"][1])
    a, bterm = _rglru_coeffs(conv, p["a_param"], ig, rg)
    h = a * cache["h"] + bterm
    y = ((h * gate).to(dt) @ p["wy"].to(dt))[:, None]
    if sharding.model_splits(cfg.rnn_width or cfg.d_model):
        y = sharding.leave_model(y)
    return shard(y, "btd"), {"h": h, "conv_buf": hist[:, 1:]}


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix memory): chunkwise-parallel prefill, O(1) decode
# ---------------------------------------------------------------------------

def init_mlstm(cfg: ModelConfig, generator, device, reps=None) -> Params:
    d = cfg.d_model
    up = 2 * d
    h = cfg.n_heads
    dh = up // h
    hs = 1 / math.sqrt(dh)
    # head-block-diagonal q/k/v (xLSTM's per-head projections), then the
    # input and forget gates
    return _dense_leaves(generator, device, reps, (
        ("w_up", (d, up), None), ("w_up_gate", (d, up), None),
        ("wq", (h, dh, dh), hs), ("wk", (h, dh, dh), hs),
        ("wv", (h, dh, dh), hs), ("w_if", (up, 2 * h), 0.02),
        ("w_down", (up, d), None)))


def _mlstm_chunk_scan(q, k, v, log_f, log_i, chunk: int):
    """Chunkwise-parallel mLSTM.  q, k, v: (B, H, S, dh) float32; gates:
    (B, H, S) logs <= 0 (a sigmoid input gate keeps every decay factor
    <= 1, so the form is stable in float32 without the m-stabilizer).

    Within a chunk, position i reads position j <= i through the decay
    ``exp(cum_f_i - cum_f_j + log_i_j)``; across chunks the state
    ``C_n = exp(total_f_n) C_{n-1} + dC_n`` (and its normalizer) is
    carried by a loop over the chunks, where JAX runs an associative scan:
    float32 results agree to rounding.  Returns (out (B, H, S, dh),
    (C (B, H, dh, dh), n (B, H, dh)) after the last position)."""
    b, h, s, dh = q.shape
    assert s % chunk == 0
    n = s // chunk
    q = q.reshape(b, h, n, chunk, dh)
    k = k.reshape(b, h, n, chunk, dh)
    v = v.reshape(b, h, n, chunk, dh)
    log_f = log_f.reshape(b, h, n, chunk)
    log_i = log_i.reshape(b, h, n, chunk)
    cum_f = torch.cumsum(log_f, dim=-1)                  # (B, H, N, C)
    total_f = cum_f[..., -1:]

    di = cum_f[..., :, None] - cum_f[..., None, :] + log_i[..., None, :]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=q.device))
    dmat = torch.where(mask, torch.exp(di), 0.0)

    wk = torch.exp(total_f - cum_f + log_i)[..., None] * k   # (B,H,N,C,dh)
    dC = torch.einsum("bhncd,bhnce->bhnde", wk, v)       # (B,H,N,dh,dh)
    dnorm = wk.sum(dim=-2)                               # (B,H,N,dh)
    decay = torch.exp(total_f[..., 0])                   # (B,H,N)

    # the state before each chunk, then the final one
    C = torch.zeros_like(dC[:, :, 0])
    nrm = torch.zeros_like(dnorm[:, :, 0])
    c_prev, n_prev = [], []
    for i in range(n):
        c_prev.append(C)
        n_prev.append(nrm)
        C = C * decay[:, :, i, None, None] + dC[:, :, i]
        nrm = nrm * decay[:, :, i, None] + dnorm[:, :, i]
    Cprev = torch.stack(c_prev, dim=2)
    nprev = torch.stack(n_prev, dim=2)

    qs = q * torch.exp(cum_f)[..., None]
    inter = torch.einsum("bhncd,bhnde->bhnce", qs, Cprev)
    inter_n = torch.einsum("bhncd,bhnd->bhnc", qs, nprev)
    intra = torch.einsum("bhncd,bhnjd->bhncj", q, k) * dmat
    out = inter + torch.einsum("bhncj,bhnjd->bhncd", intra, v)
    norm = inter_n + intra.sum(-1)
    out = out / torch.clamp(norm.abs(), min=1.0)[..., None]
    return out.reshape(b, h, s, dh), (C, nrm)


def _mlstm_qkv(p: Params, z: torch.Tensor, dh: int):
    """Per-head q, k / sqrt(dh) and v of (..., H, dh) inputs, in the
    stream dtype."""
    dt = z.dtype
    q = torch.einsum("...hd,hde->...he", z, p["wq"].to(dt))
    k = torch.einsum("...hd,hde->...he", z, p["wk"].to(dt)) / math.sqrt(dh)
    v = torch.einsum("...hd,hde->...he", z, p["wv"].to(dt))
    return q, k, v


def mlstm_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig,
              with_cache=False, chunk: int = 256):
    """The mLSTM over a sequence, chunks of ``min(chunk, S)`` positions:
    S must be a multiple of it (as in JAX; nothing is padded).  Under a
    model axis that divides the heads, on the rank's heads (``p`` holds
    their columns of ``w_up`` / ``w_up_gate``, their blocks of ``wq`` /
    ``wk`` / ``wv``, their rows of ``w_if`` and ``w_down``,
    :func:`model_rule`): the gates' pre-activations and ``w_down``'s
    products are partial sums, summed over the axis."""
    b, s, _ = x.shape
    dt = x.dtype
    h = cfg.n_heads
    dh = 2 * cfg.d_model // h
    split = sharding.model_splits(h)
    if split:
        x = sharding.enter_model(x)
    z = shard(x @ p["w_up"].to(dt), "btf")              # (B, S, up)
    gate = F.silu(x @ p["w_up_gate"].to(dt))
    q, k, v = (shard(t, "bthd") for t in                 # (B, S, H, dh)
               _mlstm_qkv(p, z.reshape(b, s, -1, dh), dh))
    gif = z @ p["w_if"].to(dt)                           # (B, S, 2H)
    if split:
        gif = sharding.leave_model(gif)
    gif = gif.float()
    gi, gf = gif[..., :h], gif[..., h:]
    if split:
        gi, gf = sharding.slice_model(gi, -1), sharding.slice_model(gf, -1)
    log_i = F.logsigmoid(gi).transpose(1, 2)
    log_f = F.logsigmoid(gf).transpose(1, 2)
    out, (C, nrm) = _mlstm_chunk_scan(
        q.transpose(1, 2).float(), k.transpose(1, 2).float(),
        v.transpose(1, 2).float(), log_f, log_i, min(chunk, s))
    out = out.transpose(1, 2).reshape(b, s, -1).to(dt)
    y = (out * gate) @ p["w_down"].to(dt)
    y = shard(sharding.leave_model(y) if split else y, "btd")
    if not with_cache:
        return y
    return y, {"C": C, "n": nrm,
               "len": torch.tensor(s, dtype=torch.int32, device=x.device)}


def init_mlstm_cache(cfg: ModelConfig, batch: int, device) -> Params:
    h = cfg.n_heads
    dh = 2 * cfg.d_model // h
    return {**_zero_blocks({"C": (batch, h, dh, dh), "n": (batch, h, dh)},
                           device),
            "len": torch.zeros((), dtype=torch.int32, device=device)}


def mlstm_step(p: Params, x_t: torch.Tensor, cache: Params,
               cfg: ModelConfig):
    """One step; under a model axis that divides the heads, on the rank's
    heads (its block of ``C`` and ``n``), as :func:`mlstm_fwd`."""
    b = x_t.shape[0]
    dt = x_t.dtype
    h = cfg.n_heads
    dh = 2 * cfg.d_model // h
    split = sharding.model_splits(h)
    z = x_t[:, 0] @ p["w_up"].to(dt)
    hl = z.shape[-1] // dh
    gate = F.silu(x_t[:, 0] @ p["w_up_gate"].to(dt))
    q, k, v = (t.float() for t in _mlstm_qkv(p, z.reshape(b, hl, dh), dh))
    gif = z @ p["w_if"].to(dt)
    if split:
        gif = sharding.leave_model(gif)
    gif = gif.float()
    gi, gf = gif[..., :h], gif[..., h:]
    if split:
        gi, gf = sharding.slice_model(gi, -1), sharding.slice_model(gf, -1)
    i_g = torch.exp(F.logsigmoid(gi))[..., None]         # (B, H, 1)
    f_g = torch.exp(F.logsigmoid(gf))[..., None]
    C = f_g[..., None] * cache["C"] \
        + i_g[..., None] * k[..., :, None] * v[..., None, :]
    nrm = f_g * cache["n"] + i_g * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.clamp(torch.einsum("bhd,bhd->bh", q, nrm).abs(), min=1.0)
    out = (num / den[..., None]).reshape(b, hl * dh).to(dt)
    y = ((out * gate) @ p["w_down"].to(dt))[:, None]
    if split:
        y = sharding.leave_model(y)
    return shard(y, "btd"), {"C": C, "n": nrm, "len": cache["len"] + 1}


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar memory, stabilized exponential gating)
# ---------------------------------------------------------------------------

def init_slstm(cfg: ModelConfig, generator, device, reps=None) -> Params:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    return _dense_leaves(generator, device, reps, (
        ("wx", (d, 4 * d), None),                        # z i f o
        ("rec_w", (h, dh, 4 * dh), 0.02), ("w_down", (d, d), None)))


def _slstm_cell(p, cfg: ModelConfig, x_pre, state):
    """x_pre: (B, 4D) input pre-activations; state: (c, n, h, m), each
    (B, H, dh) float32.  ``m`` starts at -1e30, so the first step's
    forget factor ``exp(f_l + m - m_new)`` is exactly 0."""
    b = x_pre.shape[0]
    hh = cfg.n_heads
    dh = cfg.d_model // hh
    c, n, hprev, m = state
    rec = torch.einsum("bhd,hdk->bhk", hprev, p["rec_w"].to(hprev.dtype))
    pre = x_pre.reshape(b, hh, 4 * dh) + rec
    z = torch.tanh(pre[..., :dh])
    i_l = pre[..., dh:2 * dh]                            # log input gate
    f_l = F.logsigmoid(pre[..., 2 * dh:3 * dh])          # log forget gate
    o = torch.sigmoid(pre[..., 3 * dh:])
    m_new = torch.maximum(f_l + m, i_l)
    i_g = torch.exp(i_l - m_new)
    f_g = torch.exp(f_l + m - m_new)
    c_new = f_g * c + i_g * z
    n_new = f_g * n + i_g
    h_new = o * c_new / torch.clamp(n_new, min=1.0)
    return c_new, n_new, h_new, m_new


def _slstm_shapes(cfg: ModelConfig, batch: int) -> dict:
    """The whole sLSTM state's shapes, by cache key."""
    hh = cfg.n_heads
    return dict.fromkeys(("c", "n", "h", "m"),
                         (batch, hh, cfg.d_model // hh))


def init_slstm_cache(cfg: ModelConfig, batch: int, device) -> Params:
    """The zero state (``m`` at -1e30); under a model axis the rank's
    blocks (``c``, ``n``, ``m`` over heads, ``h`` over the head dim, by
    the cache rules)."""
    return _zero_blocks(_slstm_shapes(cfg, batch), device, {"m": -1e30})


def slstm_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig,
              with_cache=False):
    """The sLSTM over a sequence: one cell step a position, in order, on
    the rank's own batch rows (JAX's ``shard_map`` over the data axes)
    with every head (its ``in_specs`` replicate ``rec_w``): no collective
    runs inside the time loop.  Under a model axis the rank computes its
    columns of the pre-activations (``wx``'s block, :func:`model_rule`),
    gathered whole before the loop, and its rows' part of ``w_down``'s
    product, summed over the axis after it."""
    b, s, d = x.shape
    dt = x.dtype
    wide = sharding.model_splits(4 * d)
    rows = sharding.model_splits(d)
    if wide:
        x = sharding.enter_model(x)
    x_pre = x @ p["wx"].to(dt)                           # (B, S, 4D)
    if wide:
        x_pre = sharding.gather_model(x_pre, -1, partial=False)
    x_pre = x_pre.float()
    pp = {"rec_w": p["rec_w"].float()}
    with sharding.use_sharding(sharding.ShardingCtx()):
        z = init_slstm_cache(cfg, b, x.device)           # whole
    state = (z["c"], z["n"], z["h"], z["m"])
    hs = []
    for t in range(s):
        state = _slstm_cell(pp, cfg, x_pre[:, t], state)
        hs.append(state[2])
    out = torch.stack(hs, dim=1).reshape(b, s, d).to(dt)
    if rows:
        out = sharding.slice_model(out, -1)
    y = out @ p["w_down"].to(dt)
    y = shard(sharding.leave_model(y) if rows else y, "btd")
    if not with_cache:
        return y
    return y, _state_blocks(dict(zip(("c", "n", "h", "m"), state)))


def slstm_step(p: Params, x_t: torch.Tensor, cache: Params,
               cfg: ModelConfig):
    """One step.  Under a model axis the state's blocks are gathered
    whole, every rank runs the cell on every head (as
    :func:`slstm_fwd`'s loop) and keeps its blocks of the new state; the
    pre-activations and ``w_down``'s product split as there."""
    b, _, d = x_t.shape
    dt = x_t.dtype
    wide = sharding.model_splits(4 * d)
    rows = sharding.model_splits(d)
    x_pre = x_t[:, 0] @ p["wx"].to(dt)
    if wide:
        x_pre = sharding.gather_model(x_pre, -1, partial=False)
    x_pre = x_pre.float()
    whole = _state_whole(cache, _slstm_shapes(cfg, b))
    state = (whole["c"], whole["n"], whole["h"], whole["m"])
    new = dict(zip(("c", "n", "h", "m"), _slstm_cell(p, cfg, x_pre, state)))
    out = new["h"].reshape(b, -1).to(dt)
    if rows:
        out = sharding.slice_model(out, -1)
    y = (out @ p["w_down"].to(dt))[:, None]
    y = shard(sharding.leave_model(y) if rows else y, "btd")
    return y, _state_blocks(new)
