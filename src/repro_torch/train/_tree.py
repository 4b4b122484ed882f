"""Leaves of nested dicts / lists / tuples of tensors with their paths,
in ``jax.tree``'s order (dict keys sorted, sequences in order) and in
``jax.tree_util.keystr``'s format (``['blocks'][0]['attn']['wq']``), so
that the optimizer's decay mask and the checkpoint's file names pick the
same leaves as the JAX package's."""

from __future__ import annotations


def leaves_with_path(tree, prefix: str = "") -> list:
    """``[(keystr path, leaf), ...]`` in ``jax.tree_util``'s order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves_with_path(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaves_with_path(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def map_with_path(fn, tree, prefix: str = ""):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)
