"""Rules 4 & 6 of the CPM paper: PE activation and self-identification
(a port of ``repro.cpm.reference.pe_array``).

Rule 4's general decoder activates every address ``a`` with
``start <= a <= end`` and ``(a - start) % carry == 0`` in one vector
predicate; Rule 6 (match line -> priority encoder / parallel counter)
becomes reductions over the match flags.
"""

from __future__ import annotations

import torch

from .._tensor import asarray, device_of


def activation_mask(n: int, start, end, carry=1, *,
                    device: torch.device | str | None = None) -> torch.Tensor:
    """Fused general decoder: boolean activation mask of length ``n``.

    ``%`` is the floor modulo of both frameworks (``torch.remainder``)."""
    dev = device if device is not None else device_of(start, end, carry)
    addr = torch.arange(n, dtype=torch.int32, device=dev)
    start = asarray(start, device=dev)
    end = asarray(end, device=dev)
    carry = torch.clamp(asarray(carry, device=dev), min=1)
    return (addr >= start) & (addr <= end) & ((addr - start) % carry == 0)


def count_matches(match: torch.Tensor) -> torch.Tensor:
    """Parallel counter: number of asserted match lines (any shape)."""
    return match.to(torch.int32).sum(dtype=torch.int32)


def any_match(match: torch.Tensor) -> torch.Tensor:
    return match.any()


def enumerate_matches(match: torch.Tensor, max_out: int):
    """Up to ``max_out`` asserted addresses in ascending order along the
    address axis; unused slots hold ``n``.  Returns ``(indices, valid)``."""
    n = match.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=match.device)
    keyed = torch.where(match, idx, torch.full_like(idx, n))
    ordered = torch.sort(keyed, dim=-1).values[..., :max_out]
    return ordered, ordered < n
