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
from .trips import trip


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


def carry_pattern(n: int, carry, *,
                  device: torch.device | str | None = None) -> torch.Tensor:
    """Paper Eq. 3-1: every address that is a multiple of ``carry``
    (address 0 always)."""
    dev = device if device is not None else device_of(carry)
    addr = torch.arange(n, dtype=torch.int32, device=dev)
    return addr % torch.clamp(asarray(carry, device=dev), min=1) == 0


def parallel_shift(bits: torch.Tensor, shift) -> torch.Tensor:
    """Paper Eq. 3-2 / Fig. 2: ``H[a] = D[a - s]`` for ``a >= s``, else 0,
    as the paper's accumulative barrel shifter: stage ``j`` shifts by
    ``2**j`` when bit ``j`` of ``shift`` is set (``clog2(n)`` stages, at
    least one; higher bits of ``shift`` are not read)."""
    n = bits.shape[0]
    shift = asarray(shift, device=bits.device)
    low = torch.arange(n, dtype=torch.int32, device=bits.device)
    h = bits
    for j in range(max(1, (n - 1).bit_length())):
        trip()
        take = (shift >> j) & 1
        shifted = torch.roll(h, 1 << j)
        shifted = torch.where(low < (1 << j), False, shifted)
        h = torch.where(take == 1, shifted, h)
    return h


def all_line(n: int, end, *,
             device: torch.device | str | None = None) -> torch.Tensor:
    """Paper Eq. 3-3 / Fig. 3: every address ``<= end``."""
    dev = device if device is not None else device_of(end)
    return torch.arange(n, dtype=torch.int32, device=dev) <= asarray(
        end, device=dev)


def general_decoder(n: int, start, end, carry=1, *,
                    device: torch.device | str | None = None
                    ) -> torch.Tensor:
    """Paper §3.3 three-stage decoder: carry pattern -> parallel shift ->
    all-line AND (equal to :func:`activation_mask`)."""
    dev = device if device is not None else device_of(start, end, carry)
    return parallel_shift(carry_pattern(n, carry, device=dev), start) \
        & all_line(n, end, device=dev)


def count_matches(match: torch.Tensor) -> torch.Tensor:
    """Parallel counter: number of asserted match lines (any shape)."""
    return match.to(torch.int32).sum(dtype=torch.int32)


def any_match(match: torch.Tensor) -> torch.Tensor:
    return match.any()


def first_match(match: torch.Tensor) -> torch.Tensor:
    """Priority encoder: the lowest asserted address along the last axis,
    or ``n`` where none is asserted (int32)."""
    n = match.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=match.device)
    return torch.where(match, idx, n).amin(dim=-1)


def enumerate_matches(match: torch.Tensor, max_out: int):
    """Up to ``max_out`` asserted addresses in ascending order along the
    address axis; unused slots hold ``n``.  Returns ``(indices, valid)``."""
    n = match.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=match.device)
    keyed = torch.where(match, idx, torch.full_like(idx, n))
    ordered = torch.sort(keyed, dim=-1).values[..., :max_out]
    return ordered, ordered < n
