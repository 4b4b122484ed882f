"""The port's slot-axis cache moves and the per-slot leaves of the paged
pool against ``repro.serve.kv_cache``, on the same NumPy inputs: data
moves, so every result is exact.

  * ``compact_slots`` (stable compaction), ``splice_prefix`` (a range
    insert on the CPM reference backend) and ``evict_by_score`` (the
    comparable-memory top-k mask, then compaction);
  * ``seat_caches`` / ``lift_slot`` / ``merge_paged`` on a hybrid tree
    (recurrentgemma's rings, ``h``, ``conv_buf`` and ``len`` leaves, which
    stay per slot) and on a mixed tree with a paged global-attention
    site.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import all_configs as jall_configs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import kv_cache  # noqa: E402


def _flat(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _flat(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in _flat(v)]
    return [t]


def _equal_trees(jt, tt):
    jl, tl = _flat(jt), _flat(tt)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(jnp.asarray(a, jnp.float32)) if a.dtype == \
            jnp.bfloat16 else np.asarray(a)
        np.testing.assert_array_equal(a, b.float().numpy()
                                      if b.dtype == torch.bfloat16
                                      else b.numpy())


def _kv(rng, b=2, h=2, s=8, d=3):
    return (rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, h, s, d)).astype(np.float32))


@pytest.mark.parametrize("seed", range(3))
def test_compact_slots(seed):
    rng = np.random.default_rng(seed)
    k, v = _kv(rng)
    keep = rng.random((2, 8)) < 0.5
    want = jkv.compact_slots(jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(keep))
    got = kv_cache.compact_slots(torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(keep))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert got[2].dtype == torch.int32


@pytest.mark.parametrize("used,plen", [(3, 2), (6, 3), (8, 1), (0, 4)])
def test_splice_prefix(used, plen):
    rng = np.random.default_rng(used * 7 + plen)
    k, v = _kv(rng)
    pk, pv = _kv(rng, s=plen)
    want = jkv.splice_prefix(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pk),
                             jnp.asarray(pv), jnp.asarray(used, jnp.int32))
    got = kv_cache.splice_prefix(*(torch.from_numpy(a)
                                   for a in (k, v, pk, pv)),
                                 torch.tensor(used, dtype=torch.int32))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("keep_count", [1, 4, 7])
def test_evict_by_score(keep_count):
    rng = np.random.default_rng(keep_count)
    k, v = _kv(rng)
    scores = (rng.integers(0, 5, (2, 8)) / 4.0).astype(np.float32)  # ties
    want = jkv.evict_by_score(jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(scores), keep_count)
    got = kv_cache.evict_by_score(torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(scores), keep_count)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert (got[2] == keep_count).all()


def _random_tree(jtree, rng):
    """A NumPy tree of the JAX tree's shapes and dtypes, random values."""
    def leaf(a):
        if jnp.issubdtype(a.dtype, jnp.integer):
            return rng.integers(0, 50, a.shape).astype(np.int32)
        return rng.standard_normal(a.shape).astype(np.float32)
    return jax.tree.map(leaf, jtree)


def _both(tree_np):
    """(JAX tree in bf16 where the cache holds bf16, port tree)."""
    return (jax.tree.map(jnp.asarray, tree_np),
            lm.tree_map(torch.from_numpy,
                         jax.tree.map(lambda a: a.copy(), tree_np)))


@pytest.mark.parametrize("name,n_layers", [("recurrentgemma-9b", 8),
                                           ("granite-8b", 2)])
def test_seat_lift_merge_every_leaf(name, n_layers):
    """Sessions seated into a pool land at their slots in every leaf;
    the pool's other rows stay; a lifted slot is the seated image; a
    merge takes every non-global leaf from the slot tree."""
    jcfg = dataclasses.replace(jall_configs()[name].smoke(),
                               n_layers=n_layers)
    cfg = dataclasses.replace(get_config(name).smoke(), n_layers=n_layers)
    slots, max_len, page, n_pages = 4, 16, 8, 6
    rng = np.random.default_rng(9)
    shapes = jkv.broadcast_lens(jlm.init_caches(jcfg, slots, max_len,
                                                dtype=jnp.float32), slots)
    # random per-slot leaves, zero page pools (the port's with its sink)
    jpool, tpool = _both(_random_tree(shapes, rng))
    jpool = jkv.paged_pool(jpool, jcfg, n_pages, page)
    tpool = kv_cache.paged_pool(tpool, cfg, n_pages, page)
    new_np = _random_tree(jkv.broadcast_lens(
        jlm.init_caches(jcfg, 2, max_len, dtype=jnp.float32), 2), rng)
    jnew, tnew = _both(new_np)
    idx = np.array([3, 1])
    pt = np.array([[0, 2], [5, 6]], np.int32)            # 6: a sentinel
    jseated = jkv.seat_caches(jpool, jnew, jcfg, jnp.asarray(idx),
                              jnp.asarray(pt))
    tseated = kv_cache.seat_caches(tpool, tnew, cfg, torch.from_numpy(idx),
                                   torch.from_numpy(pt))
    ub, ut = kv_cache.attn_sites(cfg)
    strip = (lambda t: {"blocks": [n for u, n in enumerate(t["blocks"])
                                   if u not in ub],
                        "tail": [n for i, n in enumerate(t["tail"])
                                 if i not in ut]})
    _equal_trees(strip(jseated), strip(tseated))
    lifted = kv_cache.lift_slot(tseated, cfg, 3, torch.tensor([[0, 2]]))
    jlifted = jkv.lift_slot(jseated, jcfg, 3, jnp.asarray([[0, 2]]))
    _equal_trees(jlifted, lifted)
    # a merge: non-global leaves come from the slot tree
    slot_np = _random_tree(shapes, rng)
    jslot, tslot = _both(slot_np)
    logical_pt = np.zeros((slots, max_len // page), np.int32)
    jm = jkv.merge_paged(jseated, jslot, jcfg, jnp.asarray(logical_pt))
    tm = kv_cache.merge_paged(tseated, tslot, cfg,
                              torch.from_numpy(logical_pt))
    _equal_trees(strip(jm), strip(tm))
    _equal_trees(strip(jslot), strip(tm))
