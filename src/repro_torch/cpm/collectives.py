"""Distributed embodiment of CPM at pod scale (a port of
``repro.cpm.collectives``) on ``torch.distributed``.

Ranks are PEs: Rule 7 (neighbour connectivity) is a ring of processes,
realized with ``batch_isend_irecv``; Rule 5 (broadcast instruction) is the
program every rank runs; the paper's §7.4 two-phase sectioned reduction
becomes hierarchical collectives (reduce inside a section of the mesh,
then across sections); the §8 *super-connectivity* extension (log N skip
links) is the butterfly of :func:`tree_allreduce`.

Three gradient-reduction schedules (:func:`grad_sync`):
  * ``ring``       — R7-faithful: N-1 shift-and-add steps, neighbour links
                     only.
  * ``two_phase``  — §7.4: an all-reduce over the inner ("data") axis, then
                     over the outer ("pod") axis.
  * ``xla``        — one all-reduce over both axes at once (JAX leaves its
                     schedule to the XLA collective compiler; here it is
                     the backend's, NCCL's or gloo's).

JAX's functions run inside ``shard_map`` over a named mesh axis; these run
in every rank of the group, each on its own local shard, and return what
JAX's do on that shard.  ``axis_name`` is a mesh dimension name, resolved
against the current sharding context's ``DeviceMesh``
(``repro_torch.distributed.sharding``), a tuple of names (one group over
those dimensions, its ranks in mesh order), or a process group.

Kept from JAX: ``ring_allreduce`` and ``tree_allreduce`` add in the same
order (``acc + moving`` each step), so their float results are JAX's bit
for bit; integer sums stay in 32 bits and wrap, as ``jnp.sum`` with x64
off does; no function modifies its input (``torch.distributed`` reduces in
place, so each works on a copy).  ``pmax`` / ``pmin`` combine with
``jnp.max``'s rule (NaN wins, -0.0 < +0.0) whatever the rank order.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding

from . import semantics
from .reference.computable import sum_dtype

#: resolved groups over several mesh dimensions, by the default group and
#: the ranks of every such group (each is made collectively, once)
_FLAT: dict = {}


def _group(axis_name, mesh=None):
    """The process group of ``axis_name`` (see the module docstring) on
    ``mesh``, default the current sharding context's."""
    if isinstance(axis_name, dist.ProcessGroup):
        return axis_name
    mesh = sharding.current_ctx().mesh if mesh is None else mesh
    if not hasattr(mesh, "get_group"):
        raise ValueError(f"axis {axis_name!r} needs a sharding context "
                         f"whose mesh is a DeviceMesh, or pass a process "
                         f"group")
    if not isinstance(axis_name, tuple):
        return mesh.get_group(axis_name)
    names = sharding.axis_names(mesh)
    dims = sorted(names.index(a) for a in axis_name)
    if len(dims) == 1:
        return mesh.get_group(names[dims[0]])
    rest = [d for d in range(len(names)) if d not in dims]
    layout = mesh.mesh.permute(*rest, *dims).reshape(
        -1, math.prod(mesh.size(d) for d in dims))
    key = (dist.group.WORLD, tuple(map(tuple, layout.tolist())))
    if key not in _FLAT:
        _FLAT[key] = dist.new_subgroups_by_enumeration(layout.tolist())[0]
    return _FLAT[key]


def _size_rank(g) -> tuple[int, int]:
    return dist.get_world_size(g), dist.get_rank(g)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the collectives carry it: bool as uint8 (gloo moves no
    bool), contiguous."""
    return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()


def _unwire(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return y.to(torch.bool) if dtype == torch.bool else y


def _exchange(x: torch.Tensor, g, to: int, frm: int) -> torch.Tensor:
    """Send ``x`` to group rank ``to`` while receiving the same shape
    from group rank ``frm``."""
    send = _wire(x)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(g, to), g),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(g, frm), g)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _unwire(recv, x.dtype)


def psum(x: torch.Tensor, axis_name) -> torch.Tensor:
    """``lax.psum``: the sum of every rank's ``x`` over the axis."""
    out = x.clone()
    dist.all_reduce(out, group=_group(axis_name))
    return out


def _plimit(x: torch.Tensor, axis_name, mode: str) -> torch.Tensor:
    g = _group(axis_name)
    n, _ = _size_rank(g)
    parts = torch.empty((n, x.numel()), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(parts, x.reshape(1, -1).contiguous(),
                                group=g)
    return semantics.limit_reduce(parts, mode, dim=0).reshape(x.shape)


def pmax(x: torch.Tensor, axis_name) -> torch.Tensor:
    """``lax.pmax`` with ``jnp.max``'s rule: every rank's partial gathered,
    then one :func:`semantics.limit_reduce` over them."""
    return _plimit(x, axis_name, "max")


def pmin(x: torch.Tensor, axis_name) -> torch.Tensor:
    """``lax.pmin`` with ``jnp.min``'s rule (see :func:`pmax`)."""
    return _plimit(x, axis_name, "min")


def ring_shift(x: torch.Tensor, axis_name, shift: int = 1) -> torch.Tensor:
    """Rule 7: read a register of the neighbour ``shift`` hops away (ring):
    rank ``i`` sends to ``(i + shift) % n``."""
    g = _group(axis_name)
    n, r = _size_rank(g)
    if shift % n == 0:
        return x.clone()
    return _exchange(x, g, (r + shift) % n, (r - shift) % n)


def ring_allreduce(x: torch.Tensor, axis_name) -> torch.Tensor:
    """Neighbour-only all-reduce: N-1 shift+add steps (R7-faithful).

    Bandwidth-inefficient vs reduce-scatter+all-gather but structurally the
    paper's phase-1 section reduction (a carry marching around the ring).
    """
    g = _group(axis_name)
    n, _ = _size_rank(g)
    acc, moving = x.clone(), x
    for _ in range(n - 1):
        moving = ring_shift(moving, g, 1)
        acc = acc + moving
    return acc


def ring_reduce_scatter(x: torch.Tensor, axis_name,
                        axis: int = 0) -> torch.Tensor:
    """``lax.psum_scatter(..., tiled=True)``: the sum over the ranks of the
    ``i``-th of ``n`` equal chunks of ``x`` along ``axis``, on rank ``i``."""
    g = _group(axis_name)
    n, _ = _size_rank(g)
    xm = x.movedim(axis, 0).contiguous()
    if xm.shape[0] % n:
        raise ValueError(f"dim {axis} of {tuple(x.shape)} does not split "
                         f"into {n} chunks")
    out = torch.empty((xm.shape[0] // n, *xm.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, xm, group=g)
    return out.movedim(0, axis)


def ring_allgather(x: torch.Tensor, axis_name,
                   axis: int = 0) -> torch.Tensor:
    """``lax.all_gather(..., tiled=True)``: every rank's ``x`` concatenated
    along ``axis`` in rank order."""
    g = _group(axis_name)
    n, _ = _size_rank(g)
    xm = _wire(x.movedim(axis, 0))
    out = torch.empty((n * xm.shape[0], *xm.shape[1:]), dtype=xm.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, xm, group=g)
    return _unwire(out, x.dtype).movedim(0, axis)


def hierarchical_psum(x: torch.Tensor, inner_axis, outer_axis=None,
                      mode: str = "two_phase") -> torch.Tensor:
    """§7.4 two-phase sum generalized to the mesh.

    Phase 1: concurrent reduction inside each section (= inner mesh axis,
    e.g. the "data" ring of one pod).  Phase 2: reduction across sections
    (= outer "pod" axis).  ``mode`` picks the phase-1 schedule.
    """
    if mode == "ring":
        out = ring_allreduce(x, inner_axis)
    elif mode == "two_phase":
        out = psum(x, inner_axis)
    elif mode == "xla":
        axes = (inner_axis,) if outer_axis is None else (inner_axis,
                                                         outer_axis)
        return psum(x, axes)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    if outer_axis is not None:
        out = psum(out, outer_axis)
    return out


def tree_allreduce(x: torch.Tensor, axis_name, combine=None) -> torch.Tensor:
    """§8 super-connectivity: log2(N) butterfly exchanges.

    Level j exchanges with the rank 2**j away — exactly Fig. 16's skip
    links.  Needs a power-of-two axis size.  ``combine`` defaults to
    addition; any associative-commutative op (``semantics.maximum`` /
    ``minimum``) gives the same log-depth schedule for the §7.5 limits.
    """
    g = _group(axis_name)
    n, r = _size_rank(g)
    if n & (n - 1):
        raise ValueError(f"tree_allreduce needs a power-of-two axis, got "
                         f"{n} ranks")
    combine = torch.add if combine is None else combine
    acc = x.clone()
    j = 1
    while j < n:
        acc = combine(acc, _exchange(acc, g, r ^ j, r ^ j))
        j <<= 1
    return acc


def grad_sync(grads, mesh_axes: tuple, mode: str = "two_phase"):
    """Synchronize a gradient tree (dicts, lists, tuples of tensors) across
    data-parallel mesh axes.

    ``mesh_axes`` is ("data",) or ("pod", "data"); the inner-most axis is
    the section (phase 1), the outer the cross-section (phase 2).
    """
    inner = mesh_axes[-1]
    outer = mesh_axes[0] if len(mesh_axes) > 1 else None

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return hierarchical_psum(tree, inner, outer, mode=mode)

    return walk(grads)


# ---------------------------------------------------------------------------
# distributed §7.4: the sectioned sum with ranks as sections
# ---------------------------------------------------------------------------

def _local_sum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sum`` over the last axis: 32-bit integer sums that wrap."""
    out = sum_dtype(x.dtype)
    acc = out if out.is_floating_point else torch.int32
    return x.sum(-1, dtype=acc).to(out)


def distributed_section_sum(x_local: torch.Tensor, axis_name,
                            mode: str = "two_phase") -> torch.Tensor:
    """Per-row global sum of a last-axis-sharded array: local section sum
    (phase 1 inside each PE's registers), then cross-PE combine (phase 2
    over the ring).  ``(..., N/ranks)`` local shards -> replicated
    ``(...,)`` — batch rows reduce concurrently in the one collective."""
    local = _local_sum(x_local)
    if mode == "ring":
        return ring_allreduce(local, axis_name)
    return psum(local, axis_name)


def distributed_section_limit(x_local: torch.Tensor, axis_name,
                              mode: str = "max") -> torch.Tensor:
    local = semantics.limit_reduce(x_local, mode)
    return pmax(local, axis_name) if mode == "max" else pmin(local,
                                                             axis_name)


def _is_pow2(axis_name) -> bool:
    n, _ = _size_rank(_group(axis_name))
    return n & (n - 1) == 0


def distributed_super_sum(x_local: torch.Tensor, axis_name) -> torch.Tensor:
    """§8 on the mesh: local partial, then the log-depth butterfly combine
    (Fig. 16 skip links).  Non-power-of-two axes fall back to the plain
    all-reduce."""
    local = _local_sum(x_local)
    if _is_pow2(axis_name):
        return tree_allreduce(local, axis_name)
    return psum(local, axis_name)


def distributed_super_limit(x_local: torch.Tensor, axis_name,
                            mode: str = "max") -> torch.Tensor:
    local = semantics.limit_reduce(x_local, mode)
    if _is_pow2(axis_name):
        combine = semantics.maximum if mode == "max" else semantics.minimum
        return tree_allreduce(local, axis_name, combine=combine)
    return pmax(local, axis_name) if mode == "max" else pmin(local,
                                                             axis_name)
