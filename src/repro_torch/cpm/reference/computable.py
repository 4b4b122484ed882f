"""The §7 row filters the fused stream covers and the §7.4/§7.5
two-phase reductions (a port of ``template_match_1d``, ``stencil_1d``,
``section_sum`` and ``section_limit`` of
``repro.cpm.reference.computable``; the sorts and §8 trees wait for
ROADMAP Queue 2)."""

from __future__ import annotations

import torch

from ..optable import optimal_section, two_phase_steps

_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32)


def sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of ``jnp.sum`` over ``dtype`` with 64-bit types off: bool
    and signed ints sum to int32, unsigned ints to uint32, floats keep
    their type."""
    if dtype.is_floating_point:
        return dtype
    return torch.uint32 if dtype in _UNSIGNED else torch.int32


def section_sum(x: torch.Tensor, section: int | None = None) -> torch.Tensor:
    """Paper §7.4 two-phase sum along the last axis: every M-item section
    reduces, then the N/M section sums combine.  Integer sums accumulate
    in 32 bits and wrap on overflow as ``jnp.sum`` does."""
    n = x.shape[-1]
    m = section or optimal_section(n)
    pad = (-n) % m
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    sec = x.reshape(*x.shape[:-1], -1, m)
    out = sum_dtype(x.dtype)
    acc = out if out.is_floating_point else torch.int32
    return sec.sum(-1, dtype=acc).sum(-1, dtype=acc).to(out)


def section_sum_steps(n: int, section: int | None = None) -> int:
    return two_phase_steps(n, section)


def section_limit(x: torch.Tensor, section: int | None = None,
                  mode: str = "max") -> torch.Tensor:
    """Paper §7.5: per-row max/min along the last axis, two-phase — every
    M-item section reduces, then the N/M section limits combine.  The pad
    to a whole number of sections takes the reduction's identity."""
    from ..semantics import limit_identity

    n = x.shape[-1]
    m = section or optimal_section(n)
    pad = (-n) % m
    if pad:
        fill = torch.full((*x.shape[:-1], pad),
                          limit_identity(x.dtype, mode), dtype=x.dtype,
                          device=x.device)
        x = torch.cat([x, fill], dim=-1)
    sec = x.reshape(*x.shape[:-1], -1, m)
    op = torch.amax if mode == "max" else torch.amin
    return op(op(sec, dim=-1), dim=-1)


def template_match_1d(data: torch.Tensor, template: torch.Tensor):
    """o[p] = sum_j |data[p+j] - template[j]| (~M steps); positions running
    off the end wrap (callers mask the tail)."""
    m = template.shape[-1]
    dt = torch.float32 if not data.dtype.is_floating_point else data.dtype
    acc = torch.zeros(data.shape, dtype=dt, device=data.device)
    for j in range(m):
        shifted = torch.roll(data, -j, dims=-1)
        acc = acc + torch.abs(shifted - template[j])
    return acc


def stencil_1d(x: torch.Tensor, taps, wrap: bool = True) -> torch.Tensor:
    """Odd-length tap vector by M neighbour-shift accumulations;
    ``taps[center + k]`` weights the neighbour k places to the left.
    ``wrap=False`` zero-pads past the row ends."""
    taps = [float(t) for t in taps]
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    c = len(taps) // 2
    dt = torch.float32 if not x.dtype.is_floating_point else x.dtype
    out = torch.zeros(x.shape, dtype=dt, device=x.device)
    for k in range(-c, c + 1):
        w = taps[c + k]
        if w == 0:
            continue
        shifted = torch.roll(x, k, dims=-1)
        if not wrap:
            if k > 0:
                shifted = torch.where(idx >= k, shifted, 0)
            elif k < 0:
                shifted = torch.where(idx < n + k, shifted, 0)
        out = out + w * shifted.to(dt)
    return out
