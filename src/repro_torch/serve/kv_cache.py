"""KV-cache management as content-movable memory (paper §4) — a port of
the parts of ``repro.serve.kv_cache`` that the engine and the session
pool use: ``truncate``, ``broadcast_lens`` and the paged-pool helpers.

Paged residency (the serving pool's vLLM-style layout): every
*global*-attention k/v leaf is stored as a pool of fixed-size sub-pages
instead of one ``max_len`` row per session, and a per-slot page table
``(B, C)`` (``C = max_len // page_size``; entries ``>= n_pages`` are
sentinels) maps each session's logical row onto its page list.  The
port's cache tree stacks ``blocks`` per repeat, so a block leaf
``(R, B, KVH, max_len, dh)`` becomes ``(R, n_pages + 1, KVH, page_size,
dh)`` and a tail leaf ``(B, KVH, max_len, dh)`` becomes ``(n_pages + 1,
KVH, page_size, dh)``; ``len`` leaves keep their per-slot shapes.

Page ``n_pages`` is a sink, the one layout change from the JAX package:
JAX scatters drop sentinel entries (``mode="drop"``), while torch's
``index_put_`` raises on them, and masking them on the device would need
a host sync.  So sentinel entries write into the sink page, which no
gather ever reads: gathers clamp to ``n_pages - 1`` as in JAX, and the
per-row ``len`` masks whatever a clamped page holds.  Scatters write the
pool in place (the JAX helpers return copies) to keep one pool on the
card, not two.
"""

from __future__ import annotations

import torch


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


def paged_pool(caches, cfg, n_pages: int, page_size: int):
    """Re-layout zero-initialized decode caches for paged serving: every
    global-attn k/v leaf becomes a pool of ``n_pages`` sub-pages plus the
    sink page; ``len`` leaves keep their per-slot shapes."""
    def site(a, stacked):
        k = a["k"]
        kvh, dh = k.shape[-3], k.shape[-1]
        shp = (n_pages + 1, kvh, page_size, dh)
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
    leaves (``len``) are the pool's own tensors."""
    def site(a, stacked):
        return dict(a, k=_gather_leaf(a["k"], pt, stacked),
                    v=_gather_leaf(a["v"], pt, stacked))
    return _map_attn_nodes(pool_caches, cfg, site)


def merge_paged(pool_caches, slot_caches, cfg, pt):
    """Fold a post-decode logical tree back into the pool: global-attn k/v
    scattered through ``pt`` (dirty-masked: sentinel entries go to the
    sink, so clean pages are not rewritten); every other leaf (``len``)
    is taken from ``slot_caches``."""
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


def seat_caches(pool_caches, new_caches, cfg, idx, pt):
    """Check ``k`` sessions' slot-form caches into the pool, in place:
    global-attn k/v page-chunked and scattered through ``pt (k, C')``
    (sentinel-padded past each session's grant), ``len`` written at rows
    ``idx`` (blocks batch axis 1, tail axis 0).  Serves admission
    (``C' = C`` prefill rows) and restore (``C' = n_live`` saved
    sub-pages)."""
    idx = idx.to(torch.long)

    def site(pool_node, new_node, stacked):
        ln = pool_node["len"]
        if stacked:
            ln[:, idx] = new_node["len"].to(ln.dtype)
        else:
            ln[idx] = new_node["len"].to(ln.dtype)
        return dict(pool_node,
                    k=_scatter_leaf(pool_node["k"], new_node["k"], pt,
                                    stacked),
                    v=_scatter_leaf(pool_node["v"], new_node["v"], pt,
                                    stacked))

    return _zip_attn_nodes(pool_caches, new_caches, cfg, site)


def lift_slot(pool_caches, cfg, slot: int, pt1):
    """One session's park image out of the pool: global-attn k/v gathered
    at ``pt1 (1, n_live)`` — only its live sub-pages travel — flattened
    to a logical ``n_live * page_size`` row; ``len`` sliced at ``slot``."""
    def site(a, stacked):
        if stacked:
            return {"k": _gather_leaf(a["k"], pt1, True)[:, 0],
                    "v": _gather_leaf(a["v"], pt1, True)[:, 0],
                    "len": a["len"][:, slot].clone()}
        return {"k": _gather_leaf(a["k"], pt1, False)[0],
                "v": _gather_leaf(a["v"], pt1, False)[0],
                "len": a["len"][slot].clone()}
    return _map_attn_nodes(pool_caches, cfg, site)
