"""Content searchable memory (paper §5): streaming substring match (a
port of ``repro.cpm.reference.searchable``).

Each PE compares its register against a broadcast datum and ANDs the
result with its right neighbour's storage bit, so an M-item needle takes
M concurrent steps.  ``needle`` may carry leading batch axes matching
``hay``'s (one needle per row), which replaces the JAX package's
``vmap`` over rows.
"""

from __future__ import annotations

import torch

from .pe_array import enumerate_matches


def masked_eq(hay: torch.Tensor, datum, mask=None) -> torch.Tensor:
    if mask is None:
        return hay == datum
    return (hay & mask) == (datum & mask)


def substring_match(hay: torch.Tensor, needle: torch.Tensor,
                    needle_len=None, mask=None) -> torch.Tensor:
    """True at match *end* positions of ``needle`` in ``hay`` (§5.1)."""
    m = needle.shape[-1]
    if needle_len is None:
        needle_len = m
    state = torch.zeros(hay.shape, dtype=torch.bool, device=hay.device)
    for i in range(m):
        hit = masked_eq(hay, needle[..., i:i + 1], mask)
        shifted = torch.roll(state, 1, dims=-1)
        shifted[..., 0] = False
        new = hit if i == 0 else hit & shifted
        if isinstance(needle_len, int):
            state = new if i < needle_len else state
        else:       # a dynamic prefix length: steps past it keep the bits
            state = torch.where(i < needle_len, new, state)
    return state


def find_all(hay: torch.Tensor, needle: torch.Tensor, max_out: int):
    """Start addresses of every occurrence (ascending), via Rule 6.
    Returns ``(indices, valid)``; unused slots hold ``n``."""
    from ..semantics import ends_to_starts

    ends = substring_match(hay, needle)
    return enumerate_matches(ends_to_starts(ends, needle.shape[-1]),
                             max_out)


def verify_draft(draft: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Speculative-decode acceptance: longest matching prefix length."""
    ok = torch.cumprod((draft == target).to(torch.int32), dim=-1,
                       dtype=torch.int32)
    return ok.sum(dim=-1, dtype=torch.int32)


def ngram_lookup(context: torch.Tensor, ngram: torch.Tensor,
                 max_out: int = 8):
    """Continuation positions after each earlier occurrence of ``ngram``
    in ``context`` (prompt-lookup decoding).  Returns (starts, valid)."""
    n = context.shape[-1]
    ends = substring_match(context, ngram)
    idx = torch.arange(n, dtype=torch.int32, device=context.device)
    ends = ends & (idx < n - 1)
    starts, valid = enumerate_matches(ends, max_out)
    return torch.where(valid, starts + 1, starts), valid
