"""Content comparable memory (paper §6): concurrent value comparison (a
port of ``repro.cpm.reference.comparable``): broadcast compares, the §6.1
multi-word carry chain, the §6.3 M-bin histogram, and the compare-and-count
thresholds that sampling uses."""

from __future__ import annotations

import torch

from .pe_array import count_matches
from .trips import trip

_OPS = {
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "lt": lambda a, b: a < b,
    "gt": lambda a, b: a > b,
    "le": lambda a, b: a <= b,
    "ge": lambda a, b: a >= b,
}


def compare(x: torch.Tensor, datum, op: str = "eq",
            mask=None) -> torch.Tensor:
    """One concurrent compare of every item against a broadcast datum."""
    if mask is not None:
        x = x & mask
        datum = datum & mask
    return _OPS[op](x, datum)


def lex_compare_lt(words: torch.Tensor, datum: torch.Tensor) -> torch.Tensor:
    """Multi-word ``<`` by the §6.1 carry chain: ``words`` is ``(...,
    n_items, n_words)`` with the most significant word first, ``datum``
    ``(n_words,)``; least to most significant, one step a word:
    ``lt = (w < d) | ((w == d) & lt)``."""
    out = torch.zeros(words.shape[:-1], dtype=torch.bool,
                      device=words.device)
    for j in range(words.shape[-1] - 1, -1, -1):
        trip()
        w, d = words[..., j], datum[j]
        out = (w < d) | ((w == d) & out)
    return out


def histogram(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Paper §6.3: per-row counts ``(..., M)`` of ``(..., N)`` rows in the
    ``M`` bins ``[edges[i], edges[i+1])``, as ``M + 1`` broadcast compares
    each followed by a Rule-6 count over the address axis, then the
    differences of the counts (so NaN values and edges out of order give
    what the JAX reference gives).  Rows and edges promote to one dtype,
    as ``jnp`` promotes two arrays."""
    ct = torch.promote_types(x.dtype, edges.dtype)
    x, edges = x.to(ct), edges.to(ct)
    cum = []
    for e in edges:
        trip()
        cum.append((x < e).sum(dim=-1, dtype=torch.int32))
    return torch.movedim(torch.diff(torch.stack(cum), dim=0), 0, -1)


def quantile_threshold(x: torch.Tensor, k, lo, hi,
                       iters: int = 24) -> torch.Tensor:
    """Smallest ``t`` with ``count(x > t) < k`` by bisection over
    ``[lo, hi]``: each of the ``iters`` steps is one compare and one
    parallel count over all of ``x`` (float ``x``; the bounds take its
    dtype)."""
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    for _ in range(iters):
        trip()
        mid = (lo + hi) / 2
        keep_hi = count_matches(compare(x, mid, "gt")) >= k
        lo, hi = torch.where(keep_hi, mid, lo), torch.where(keep_hi, hi, mid)
    return hi


def topk_mask(x: torch.Tensor, k: int, dim: int = -1) -> torch.Tensor:
    """Boolean mask of the k largest entries along ``dim``: one threshold
    lookup + one compare; ties at the threshold break by address (R6)."""
    x = torch.movedim(x.detach(), dim, -1)
    kth = torch.sort(x, dim=-1, descending=True).values[..., k - 1:k]
    gt = x > kth
    eq = x == kth
    need = k - gt.sum(dim=-1, keepdim=True, dtype=torch.int32)
    tie_rank = torch.cumsum(eq.to(torch.int32), dim=-1, dtype=torch.int32)
    mask = gt | (eq & (tie_rank <= need))
    return torch.movedim(mask, -1, dim)
