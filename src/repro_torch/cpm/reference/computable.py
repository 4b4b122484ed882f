"""Content computable memory (paper §7-§8), a port of
``repro.cpm.reference.computable``: the row filters the fused stream
covers (template match, stencil), the §7.4/§7.5 two-phase reductions,
the §8 log-depth super ops, and the §7.7 sorts (odd-even exchange,
defect detection, the ~sqrt(N) hybrid).

Every loop trip (a tree level, an exchange cycle) is one concurrent step
and is counted (:mod:`.trips`), so the step counts can be held to the
op table's formulas.  The 2-D and image algorithms (``section_sum_2d``,
``stencil_2d``, the tap algebra, ``template_match_2d``,
``line_segment_value``, ``edge_along_x``) are not ported yet (ROADMAP
Queue 1).
"""

from __future__ import annotations

import torch

from ..optable import _clog2, optimal_section, two_phase_steps
from .trips import trip

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
    M-item section reduces, then the N/M section limits combine, with
    ``jnp.max``'s rule (NaN wins, -0.0 < +0.0).  The pad to a whole
    number of sections takes the reduction's identity."""
    from ..semantics import limit_identity, limit_reduce

    n = x.shape[-1]
    m = section or optimal_section(n)
    pad = (-n) % m
    if pad:
        fill = torch.full((*x.shape[:-1], pad),
                          limit_identity(x.dtype, mode), dtype=x.dtype,
                          device=x.device)
        x = torch.cat([x, fill], dim=-1)
    sec = x.reshape(*x.shape[:-1], -1, m)
    return limit_reduce(limit_reduce(sec, mode), mode)


# ---------------------------------------------------------------------------
# §8 — super-connectivity: log-depth combine instead of the serial march
# ---------------------------------------------------------------------------

def tree_combine(parts: torch.Tensor, combine, identity) -> torch.Tensor:
    """§8 log-depth pairwise combine along the last axis -> ``(...,)``.

    Level ``j`` (one trip) combines lane ``i`` with lane ``i + 2**j``;
    partners at or past ``k`` read ``identity`` (in ``parts``' dtype), so
    ``clog2(k)`` levels leave the full combine in lane 0 (Fig. 16's skip
    links)."""
    k = parts.shape[-1]
    levels = _clog2(k)
    if levels == 0:
        return parts[..., 0]
    idx = torch.arange(k, device=parts.device)
    ident = torch.tensor(identity, device=parts.device).to(parts.dtype)
    x = parts
    for j in range(levels):
        trip()
        stride = 1 << j
        partner = x[..., torch.clamp(idx + stride, 0, k - 1)]
        partner = torch.where(idx + stride < k, partner, ident)
        x = combine(x, partner)
    return x[..., 0]


def _sections(x: torch.Tensor, section, fill) -> torch.Tensor:
    """(..., N) -> (..., N/M, M), the ragged end padded with ``fill``."""
    n = x.shape[-1]
    m = section or optimal_section(n)
    pad = (-n) % m
    if pad:
        x = torch.cat([x, torch.full((*x.shape[:-1], pad), fill,
                                     dtype=x.dtype, device=x.device)], -1)
    return x.reshape(*x.shape[:-1], -1, m)


def super_sum(x: torch.Tensor, section: int | None = None) -> torch.Tensor:
    """§8 super-connected sum along the last axis: a log-depth tree inside
    every M-item section, then one over the N/M partials (~log2(N)
    concurrent steps, against §7.4's ~2·sqrt(N)).  Rows first take
    ``jnp.sum``'s dtype (:func:`sum_dtype`); integer sums wrap in 32 bits
    and equal :func:`section_sum` bit for bit."""
    out = sum_dtype(x.dtype)
    acc = out if out.is_floating_point else torch.int32
    sec = _sections(x.to(acc), section, 0)
    partials = tree_combine(sec, torch.add, 0)          # phase 1
    return tree_combine(partials, torch.add, 0).to(out)  # phase 2


def super_limit(x: torch.Tensor, section: int | None = None,
                mode: str = "max") -> torch.Tensor:
    """§8 super-connected max / min (log-depth in both phases); the pad and
    the tree's missing partners take ``limit_identity(x.dtype, mode)``."""
    from ..semantics import limit_identity, maximum, minimum

    identity = limit_identity(x.dtype, mode)
    combine = maximum if mode == "max" else minimum
    sec = _sections(x, section, identity)
    return tree_combine(tree_combine(sec, combine, identity), combine,
                        identity)


# ---------------------------------------------------------------------------
# §7.7 — sorting
# ---------------------------------------------------------------------------

def count_disorder(x: torch.Tensor, descending: bool = False):
    """Rule 6 applied to sorting: the number of neighbour pairs out of
    order (int32)."""
    a, b = x[..., :-1], x[..., 1:]
    bad = (a < b) if descending else (a > b)
    return bad.to(torch.int32).sum(dim=-1, dtype=torch.int32)


def odd_even_step(x: torch.Tensor, odd_phase) -> torch.Tensor:
    """One concurrent compare-exchange of every (even, odd) pair
    (``odd_phase`` 0) or (odd, even) pair (1), with ``jnp.minimum`` /
    ``jnp.maximum`` semantics (NaN spreads through its pair); lanes with
    no partner keep their value."""
    from ..semantics import maximum, minimum

    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    is_left = (idx % 2) == (int(odd_phase) % 2)
    partner = torch.clamp(torch.where(is_left, idx + 1, idx - 1), 0, n - 1)
    px = x[..., partner]
    out = torch.where(is_left, minimum(x, px), maximum(x, px))
    solo = (partner == idx) | (is_left & (idx == n - 1))
    return torch.where(solo, x, out)


def odd_even_sort(x: torch.Tensor, steps: int | None = None) -> torch.Tensor:
    """Local-exchange sort along the last axis: ``steps`` alternating
    exchange cycles (cycle ``i`` has parity ``i % 2``); ``N`` cycles sort
    fully, the hybrid stops at ~sqrt(N)."""
    n = x.shape[-1]
    steps = n if steps is None else steps
    for i in range(steps):
        trip()
        x = odd_even_step(x, i % 2)
    return x


def _edge_fill(x: torch.Tensor, low: bool) -> float | int:
    """``-inf`` (``low``) or ``+inf`` set into ``x``'s dtype, as XLA's
    conversion saturates it for integer rows."""
    if x.dtype.is_floating_point:
        return -float("inf") if low else float("inf")
    info = torch.iinfo(x.dtype)
    return info.min if low else info.max


def detect_defects(x: torch.Tensor) -> dict[str, torch.Tensor]:
    """Fig. 13 point defects in every neighbourhood (~4 cycles): ``peak``
    (above both neighbours), ``valley`` (below both) and ``fault`` (an
    exchanged adjacent pair inside otherwise sorted context)."""
    lo, hi = _edge_fill(x, True), _edge_fill(x, False)
    left = torch.roll(x, 1, dims=-1)
    left[..., 0] = lo
    right = torch.roll(x, -1, dims=-1)
    right[..., -1] = hi
    r2 = torch.roll(x, -2, dims=-1)
    r2[..., -2:] = hi
    l2 = torch.roll(x, 2, dims=-1)
    l2[..., :2] = lo
    peak = (x > left) & (x > right)
    valley = (x < left) & (x < right)
    fault = (x > right) & (x <= r2) & (right >= left) & (l2 <= right)
    return {"peak": peak & ~fault, "valley": valley & ~fault,
            "fault": fault}


def hybrid_sort(x: torch.Tensor, local_steps: int | None = None):
    """Paper §7.7 ~sqrt(N) strategy on one row: ``local_steps`` (default
    ~sqrt(N)) odd-even cycles, then global moves until the disorder count
    reads zero — each round a pair of exchange steps, defect detection
    (Rule 6), and the first peak or valley deleted and re-inserted at its
    sorted place by range shifts.  The rounds loop on the host."""
    from .movable import delete, insert

    n = x.shape[-1]
    x = odd_even_sort(x, local_steps or optimal_section(n))
    idx = torch.arange(n, device=x.device)
    while int(count_disorder(x)) > 0:
        x = odd_even_step(odd_even_step(x, 0), 1)
        d = detect_defects(x)
        pos = int(torch.where(d["peak"] | d["valley"], idx, n).min())
        if pos >= n:
            continue
        v = x[pos]
        is_peak = bool(d["peak"][pos])
        fill = _edge_fill(x, not is_peak) if x.dtype.is_floating_point \
            else 0
        removed = delete(x, pos, 1, n, fill=torch.tensor(
            fill, dtype=x.dtype, device=x.device))
        dest = (removed[:n - 1] < v).sum(dtype=torch.int32)
        x = insert(removed, dest, v[None], n)
    return x


def hybrid_sort_steps(n: int) -> int:
    """The op table's ``hybrid_sort`` count: the ~sqrt(N) local exchange
    cycles plus the N/M global moves."""
    return two_phase_steps(n)


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
    ``wrap=False`` zero-pads past the row ends.  Every row dtype
    accumulates and returns float32: the JAX reference's weights are
    NumPy float64 scalars (strong types), which lift even float16 and
    bfloat16 rows to float32 with 64-bit types off."""
    taps = [float(t) for t in taps]
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    c = len(taps) // 2
    dt = torch.float32
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
