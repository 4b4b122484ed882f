"""KV-cache management as content-movable memory (paper §4) — a port of
``repro.serve.kv_cache``: ``truncate``, ``broadcast_lens``, the
paged-pool helpers, and ``compact_slots`` / ``splice_prefix`` /
``evict_by_score``.

Paged residency (the serving pool's vLLM-style layout): every
*global*-attention k/v leaf is stored as a pool of fixed-size sub-pages
instead of one ``max_len`` row per session, and a per-slot page table
``(B, C)`` (``C = max_len // page_size``; entries ``>= n_pages`` are
sentinels) maps each session's logical row onto its page list.  The
port's cache tree stacks ``blocks`` per repeat, so a block leaf
``(R, B, KVH, max_len, dh)`` becomes ``(R, n_pages + 1, KVH, page_size,
dh)`` and a tail leaf ``(B, KVH, max_len, dh)`` becomes ``(n_pages + 1,
KVH, page_size, dh)``.  Local-window rings, recurrent states and ``len``
leaves stay per slot (rows of the batch axis: 1 in ``blocks``, 0 in
``tail``); only the worst-case-sized global caches are paged.

Page ``n_pages`` is a sink, the one layout change from the JAX package:
JAX scatters drop sentinel entries (``mode="drop"``), while torch's
``index_put_`` raises on them, and masking them on the device would need
a host sync.  So sentinel entries write into the sink page, which no
gather ever reads: gathers clamp to ``n_pages - 1`` as in JAX, and the
per-row ``len`` masks whatever a clamped page holds.  Scatters and seats
write the pool in place (the JAX helpers return copies) to keep one pool
on the card, not two.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import sharding
from repro_torch.models.lm import tree_map


def truncate(caches, new_len):
    """Speculative-decode rollback: every attention ``len`` leaf becomes
    ``min(len, new_len)`` (a range delete at the tail: lengths only, the
    entries stay put and the ``len`` mask excludes them).  ``new_len`` is
    a scalar or a per-row ``(B,)`` tensor; cross-attention caches are
    never truncated."""
    def walk(node):
        if isinstance(node, dict):
            if "len" in node and "k" in node:
                nl = torch.as_tensor(new_len, dtype=torch.int32,
                                     device=node["len"].device)
                return dict(node, len=torch.minimum(node["len"], nl))
            return {kk: vv if kk == "cross_kv" else walk(vv)
                    for kk, vv in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(x) for x in node)
        return node
    return walk(caches)


def broadcast_lens(caches, batch: int):
    """Give every ``len`` leaf a trailing per-row ``(batch,)`` axis (a
    scalar becomes ``(B,)``, a stacked ``(R,)`` becomes ``(R, B)``).
    Idempotent: the sibling ``k`` (or ``C``) leaf has three trailing
    content dims, so a broadcast length has ``sib.ndim - 3`` dims."""
    def walk(node):
        if isinstance(node, dict):
            out = {}
            sib = node.get("k", node.get("C"))
            for kk, vv in node.items():
                if kk == "len":
                    lv = vv.to(torch.int32)
                    if sib is not None:
                        done = lv.ndim == sib.ndim - 3
                    else:
                        done = lv.ndim >= 1 and lv.shape[-1] == batch
                    out[kk] = lv if done else \
                        lv[..., None].expand(*lv.shape, batch).contiguous()
                else:
                    out[kk] = walk(vv)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(x) for x in node)
        return node
    return walk(caches)


# ---------------------------------------------------------------------------
# paged pools
# ---------------------------------------------------------------------------

def attn_sites(cfg) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Positions of the *global*-attention cache nodes in a pool tree —
    (unit indices into ``blocks``, indices into ``tail``)."""
    from repro_torch.models import lm
    unit, _, tail = lm._layout(cfg)
    return (tuple(u for u, kind in enumerate(unit) if kind == "attn"),
            tuple(t for t, kind in enumerate(tail) if kind == "attn"))


def _map_attn_nodes(caches, cfg, site_fn):
    """Rebuild a cache tree with ``site_fn(attn_node, stacked)`` applied to
    every global-attention node; other nodes pass through."""
    ub, ut = attn_sites(cfg)
    blocks = [dict(node, attn=site_fn(node["attn"], True))
              if u in ub else node
              for u, node in enumerate(caches["blocks"])]
    tail = [dict(node, attn=site_fn(node["attn"], False))
            if t in ut else node
            for t, node in enumerate(caches["tail"])]
    return {"blocks": blocks, "tail": tail}


def page_slots(cfg, page_size: int) -> int:
    """The slots of a page that a rank's block of a global-attn pool leaf
    holds: every slot where the model axis divides the KV heads (the
    rank's KV heads of every page) or there is none, else (split-KV)
    ``page_size / m``, the rank's part of every page
    (``sharding.split_kv_slots``).  Raises ``ValueError`` where split-KV
    needs the axis to divide the page and it does not (a model without
    global attention pages nothing)."""
    m = sharding.model_size()
    if not sharding.model_parallel() or sharding.model_splits(
            cfg.n_kv_heads) or not any(attn_sites(cfg)):
        return page_size
    if page_size % m:
        raise ValueError(
            f"page_size ({page_size}) must be a multiple of the model axis "
            f"({m}): its {cfg.n_kv_heads} KV heads do not split over the "
            f"axis, so each rank holds page_size / {m} slots of every page")
    return page_size // m


def paged_pool(caches, cfg, n_pages: int, page_size: int):
    """Re-layout zero-initialized decode caches for paged serving: every
    global-attn k/v leaf becomes a pool of ``n_pages`` sub-pages plus the
    sink page; ``len`` leaves keep their per-slot shapes.  Under a model
    axis, the rank's block: ``(n_pages + 1, KVH / m, page_size, dh)``
    where the axis divides the KV heads, else (split-KV) ``(n_pages + 1,
    KVH, page_size / m, dh)`` (:func:`page_slots`).  The gathers, scatters
    and seats below work on either block as it is: a logical row is the
    rank's slots of each page in page order."""
    pg = page_slots(cfg, page_size)

    def site(a, stacked):
        k = a["k"]
        kvh, dh = k.shape[-3], k.shape[-1]
        shp = (n_pages + 1, kvh, pg, dh)
        if stacked:
            shp = (k.shape[0],) + shp
        return dict(a, k=torch.zeros(shp, dtype=k.dtype, device=k.device),
                    v=torch.zeros(shp, dtype=k.dtype, device=k.device))
    return _map_attn_nodes(caches, cfg, site)


def _gather_leaf(pool_leaf, pt, stacked: bool):
    """Pool pages -> logical rows: gathered at ``pt (B, C)`` and flattened
    to ``(..., B, KVH, C*pg, dh)``.  Sentinel entries clamp to the last
    real page; the per-row ``len`` masks their content."""
    n_pages = pool_leaf.shape[1 if stacked else 0] - 1   # minus the sink
    ptc = pt.to(torch.long).clamp(0, n_pages - 1)
    if stacked:
        g = pool_leaf[:, ptc].movedim(3, 2)   # (R, B, KVH, C, pg, dh)
        r, b, kvh, c, pg, dh = g.shape
        return g.reshape(r, b, kvh, c * pg, dh)
    g = pool_leaf[ptc].movedim(2, 1)          # (B, KVH, C, pg, dh)
    b, kvh, c, pg, dh = g.shape
    return g.reshape(b, kvh, c * pg, dh)


def _scatter_leaf(pool_leaf, rows_leaf, pt, stacked: bool):
    """Logical rows -> pool pages, in place: the inverse of
    :func:`_gather_leaf`; sentinel entries (``>= n_pages``: clean pages)
    land in the sink page.  Returns ``pool_leaf``."""
    n_pages = pool_leaf.shape[1 if stacked else 0] - 1
    ptl = pt.to(torch.long).clamp(0, n_pages)
    c = ptl.shape[-1]
    if stacked:
        r, b, kvh, w, dh = rows_leaf.shape
        vals = rows_leaf.reshape(r, b, kvh, c, w // c, dh).movedim(2, 3)
        pool_leaf[:, ptl] = vals.to(pool_leaf.dtype)
    else:
        b, kvh, w, dh = rows_leaf.shape
        vals = rows_leaf.reshape(b, kvh, c, w // c, dh).movedim(1, 2)
        pool_leaf[ptl] = vals.to(pool_leaf.dtype)
    return pool_leaf


def logical_view(pool_caches, cfg, pt):
    """The decode-facing view of a paged pool: global-attn k/v gathered
    through the page table ``pt (B, C)`` into full-width logical rows —
    the un-paged layout, so ``lm.decode_step`` runs unchanged.  Other
    leaves (rings, recurrent states, ``len``) are the pool's own
    tensors."""
    def site(a, stacked):
        return dict(a, k=_gather_leaf(a["k"], pt, stacked),
                    v=_gather_leaf(a["v"], pt, stacked))
    return _map_attn_nodes(pool_caches, cfg, site)


def merge_paged(pool_caches, slot_caches, cfg, pt):
    """Fold a post-decode logical tree back into the pool: global-attn k/v
    scattered through ``pt`` (dirty-masked: sentinel entries go to the
    sink, so clean pages are not rewritten); every other leaf (rings,
    recurrent states, ``len``) is taken from ``slot_caches``."""
    def site(logical, pool, stacked):
        return dict(logical,
                    k=_scatter_leaf(pool["k"], logical["k"], pt, stacked),
                    v=_scatter_leaf(pool["v"], logical["v"], pt, stacked))
    return _zip_attn_nodes(slot_caches, pool_caches, cfg, site)


def _zip_attn_nodes(base, other, cfg, site_fn):
    """``base``'s tree with ``site_fn(base_attn, other_attn, stacked)`` at
    every global-attention node."""
    ub, ut = attn_sites(cfg)
    blocks = [dict(b, attn=site_fn(b["attn"], o["attn"], True))
              if u in ub else b
              for u, (b, o) in enumerate(zip(base["blocks"],
                                             other["blocks"]))]
    tail = [dict(b, attn=site_fn(b["attn"], o["attn"], False))
            if t in ut else b
            for t, (b, o) in enumerate(zip(base["tail"], other["tail"]))]
    return {"blocks": blocks, "tail": tail}


def _rows_write(pool_leaf, new_leaf, idx, stacked: bool):
    """``new_leaf``'s rows into ``pool_leaf`` at slots ``idx``, in place."""
    if stacked:
        pool_leaf[:, idx] = new_leaf.to(pool_leaf.dtype)
    else:
        pool_leaf[idx] = new_leaf.to(pool_leaf.dtype)
    return pool_leaf


def seat_caches(pool_caches, new_caches, cfg, idx, pt):
    """Check ``k`` sessions' slot-form caches into the pool, in place:
    global-attn k/v page-chunked and scattered through ``pt (k, C')``
    (sentinel-padded past each session's grant), every other leaf (rings,
    recurrent states, ``len``) written at rows ``idx`` (blocks batch axis
    1, tail axis 0).  Serves admission (``C' = C`` prefill rows) and
    restore (``C' = n_live`` saved sub-pages)."""
    idx = idx.to(torch.long)
    ub, ut = attn_sites(cfg)

    def node_out(pnode, nnode, site, stacked):
        out = {}
        for kk, vv in pnode.items():
            if site and kk == "attn":
                na = nnode["attn"]
                out[kk] = dict(
                    vv, k=_scatter_leaf(vv["k"], na["k"], pt, stacked),
                    v=_scatter_leaf(vv["v"], na["v"], pt, stacked),
                    len=_rows_write(vv["len"], na["len"], idx, stacked))
            else:
                out[kk] = tree_map(
                    lambda p, n: _rows_write(p, n, idx, stacked), vv,
                    nnode[kk])
        return out

    return {
        "blocks": [node_out(p, n, u in ub, True) for u, (p, n)
                   in enumerate(zip(pool_caches["blocks"],
                                    new_caches["blocks"]))],
        "tail": [node_out(p, n, t in ut, False) for t, (p, n)
                 in enumerate(zip(pool_caches["tail"],
                                  new_caches["tail"]))],
    }


def lift_slot(pool_caches, cfg, slot: int, pt1):
    """One session's park image out of the pool: global-attn k/v gathered
    at ``pt1 (1, n_live)`` — only its live sub-pages travel — flattened
    to a logical ``n_live * page_size`` row; every other leaf copied at
    ``slot``."""
    ub, ut = attn_sites(cfg)

    def node_out(node, site, stacked):
        sl = ((lambda a: a[:, slot].clone()) if stacked
              else (lambda a: a[slot].clone()))
        out = {}
        for kk, vv in node.items():
            if site and kk == "attn":
                k = _gather_leaf(vv["k"], pt1, stacked)
                v = _gather_leaf(vv["v"], pt1, stacked)
                out[kk] = {"k": k[:, 0] if stacked else k[0],
                           "v": v[:, 0] if stacked else v[0],
                           "len": sl(vv["len"])}
            else:
                out[kk] = tree_map(sl, vv)
        return out

    return {
        "blocks": [node_out(n, u in ub, True)
                   for u, n in enumerate(pool_caches["blocks"])],
        "tail": [node_out(n, t in ut, False)
                 for t, n in enumerate(pool_caches["tail"])],
    }


# ---------------------------------------------------------------------------
# slot-axis moves: compaction, prefix splice, eviction by score
# ---------------------------------------------------------------------------

def compact_slots(k: torch.Tensor, v: torch.Tensor, keep: torch.Tensor):
    """Remove evicted slots (``keep`` False) and pack the survivors to the
    front in order — stable compaction (paper §4.2) along the slot axis.

    k, v: (B, KVH, S, dh); keep: (B, S) bool.  Returns (k, v, new_len
    (B,) int32)."""
    order = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)
    idx = order[:, None, :, None].expand(k.shape)
    new_len = keep.sum(-1, dtype=torch.int32)
    return k.gather(2, idx), v.gather(2, idx), new_len


def splice_prefix(k: torch.Tensor, v: torch.Tensor, pk: torch.Tensor,
                  pv: torch.Tensor, used_len):
    """Prefix-cache splice: insert a cached prefix (pk, pv) of ``plen``
    slots before the current content — a content-movable range insert on
    the slot axis of every (row, head, feature) column, on the CPM
    reference backend; content pushed past the last slot drops.  Returns
    (k, v, used_len + plen)."""
    from repro_torch.cpm.array import CPMArray

    plen = pk.shape[2]
    ul = torch.as_tensor(used_len, dtype=torch.int32, device=k.device)

    def ins(x, px):
        cols = x.movedim(2, -1)                          # (B, KVH, dh, S)
        arr = CPMArray(cols, ul, backend="reference")
        return arr.insert(0, px.movedim(2, -1)).data.movedim(-1, 2)

    return ins(k, pk), ins(v, pv), ul + plen


def evict_by_score(k, v, scores, keep_count: int):
    """Importance-based eviction (H2O-style): keep the ``keep_count`` slots
    of highest score per row (the comparable-memory top-k mask, ties by
    address), then compact.  Returns (k, v, new_len)."""
    from repro_torch.cpm.reference import comparable
    keep = comparable.topk_mask(scores, keep_count)      # (B, S)
    return compact_slots(k, v, keep)
