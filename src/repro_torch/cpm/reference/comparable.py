"""Content comparable memory (paper §6): concurrent value comparison (a
port of the parts of ``repro.cpm.reference.comparable`` that compare and
sampling use)."""

from __future__ import annotations

import torch

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
