"""Content movable memory (paper §4): concurrent in-place range moves
(a port of ``repro.cpm.reference.movable``).

Every op lowers to a constant number of full-row vector ops (roll +
select) on the last axis; ``CPMArray``'s insert/delete/truncate build on
them.
"""

from __future__ import annotations

import torch

from .._tensor import asarray, result_type
from .pe_array import activation_mask


def shift_range(x: torch.Tensor, start, end, shift: int = 1,
                fill=None) -> torch.Tensor:
    """Shift elements whose address lies in [start, end] by ``shift``
    places; vacated slots keep their content unless ``fill`` is given,
    content crossing the physical ends is dropped.  A ``fill`` promotes
    the row as ``jnp.where(vacated, fill, out)`` does (an int32 row with
    ``fill=2.5`` becomes float32, a bool row with ``fill=1`` int32); the
    cuda backend casts it to the row's dtype, as the JAX kernel does."""
    n = x.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=x.device)
    src_mask = activation_mask(n, start, end, device=x.device)
    moved = torch.roll(x, shift, dims=-1)
    dst_mask = torch.roll(src_mask, shift, dims=-1)
    if shift > 0:
        dst_mask = dst_mask & (idx >= shift)
    elif shift < 0:
        dst_mask = dst_mask & (idx < n + shift)
    out = torch.where(dst_mask, moved, x)
    if fill is not None:
        vacated = src_mask & ~dst_mask
        rt = result_type(x.dtype, fill)
        f = asarray(fill, device=x.device).to(rt)   # wraps, as jnp.where
        out = torch.where(vacated, f, out.to(rt))
    return out


def write_window(x: torch.Tensor, pos, values: torch.Tensor) -> torch.Tensor:
    """Broadcast-write ``values`` (``(k,)``, or one ``(..., k)`` row per
    row of ``x``) into [pos, pos+k): the write phase of insertion."""
    k = values.shape[-1]
    idx = torch.arange(x.shape[-1], dtype=torch.int32, device=x.device)
    pos = asarray(pos, device=x.device)
    in_window = (idx >= pos) & (idx < pos + k)
    vals = values[..., torch.clamp(idx - pos, 0, k - 1).long()]
    return torch.where(in_window, vals, x)


def fill_deleted_tail(x: torch.Tensor, used_len, k: int,
                      fill=0) -> torch.Tensor:
    """Fill the ``k`` slots vacated at the tail of the used region."""
    idx = torch.arange(x.shape[-1], dtype=torch.int32, device=x.device)
    used_len = asarray(used_len, device=x.device)
    vacated = (idx >= used_len - k) & (idx < used_len)
    return torch.where(vacated, asarray(fill, x.dtype, x.device), x)


def compact(x: torch.Tensor, keep: torch.Tensor, fill=0):
    """Stable §4.2 compaction: kept items move to the front in order,
    vacated tail slots take ``fill``.  Returns ``(compacted, new_len)``
    (one stable argsort pack, as the JAX reference)."""
    n = x.shape[-1]
    new_len = keep.to(torch.int32).sum(dim=-1, dtype=torch.int32)
    order = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)
    out = torch.gather(x, -1, order) if x.ndim == keep.ndim else x[order]
    live = torch.arange(n, dtype=torch.int32, device=x.device) < (
        new_len[..., None] if new_len.ndim else new_len)
    return torch.where(live, out, asarray(fill, x.dtype, x.device)), new_len


def move_object(x: torch.Tensor, src_start, length,
                dst_start) -> torch.Tensor:
    """Relocate ``length`` items from ``src_start`` to ``dst_start`` with
    one gather per element; slots the move does not cover keep their
    content, and overlapping moves read before they write (memmove)."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    dst = asarray(dst_start, device=x.device)
    length = asarray(length, device=x.device)
    in_dst = (idx >= dst) & (idx < dst + length)
    src_idx = torch.clamp(idx - dst + asarray(src_start, device=x.device),
                          0, n - 1).long()
    return torch.where(in_dst, x[..., src_idx], x)


def insert(x: torch.Tensor, pos, values: torch.Tensor, used_len):
    """Insert ``values`` at ``pos``; [pos, used_len) shifts right."""
    out = shift_range(x, pos, asarray(used_len) - 1, values.shape[-1])
    return write_window(out, pos, values)


def delete(x: torch.Tensor, pos, k: int, used_len, fill=0):
    """Delete ``k`` elements at ``pos``; [pos+k, used_len) shifts left."""
    out = shift_range(x, asarray(pos) + k, asarray(used_len) - 1, -k)
    return fill_deleted_tail(out, used_len, k, fill)
