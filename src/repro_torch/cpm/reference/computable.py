"""The two §7 row filters the fused stream covers (a port of
``template_match_1d`` and ``stencil_1d`` of
``repro.cpm.reference.computable``; the reductions and sorts wait for
ROADMAP Queue 1 item 2)."""

from __future__ import annotations

import torch


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
