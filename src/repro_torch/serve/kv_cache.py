"""KV-cache management as content-movable memory (paper §4) — the
``truncate`` and ``broadcast_lens`` helpers of ``repro.serve.kv_cache``
that the engine uses.  The paged-pool helpers wait for ROADMAP Queue 1
item 7."""

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
