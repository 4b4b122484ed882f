"""`CPMArray` — one memory device over a physical buffer (a port of
``repro.cpm.array``).

A frozen value holding

  * ``data``     — the physical buffer ``(*batch, n)``; the last axis is
                   the PE address axis,
  * ``used_len`` — the §4.2 logical-length register, a scalar or per-batch
                   int32 tensor ("memory managing itself"),
  * ``backend``  — a routing hint: ``"auto"``, ``"reference"``, ``"cuda"``
                   or ``"mesh"`` (the §7-§8 reductions and ``compare``
                   over ranks; see ``backends.mesh``).

Every method is a recordable instruction (``repro_torch.cpm.program``):
inside ``with record() as prog:`` the call is appended to the program
and still returns its eager value.  The in-place move ops (shift,
insert, delete) take a scalar ``used_len`` per call; batched devices
with per-row lengths run them through the program executor, which on
``cuda`` moves every row in one ``shift_range`` call (per-row bounds)
and on the reference replays row by row.  Every op runs on either
backend: on ``cuda`` one kernel call each, a batched ``(*batch, n)``
layout included
(``activate``; ``shift`` / ``insert`` / ``delete`` on ``shift_range``;
``compare`` / ``count``; ``substring_match`` / ``find_all``;
``histogram``; ``template_match``; ``stencil``; the §7-§8 reductions;
``sort``; ``compact``), and ``truncate`` moves only the length register.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from . import backends, semantics
from ._tensor import asarray
from .optable import OP_TABLE, op_steps
from .program.ir import recordable
from .reference import movable, pe_array


@dataclass(frozen=True)
class CPMArray:
    data: torch.Tensor                 # (*batch, n) physical buffer
    used_len: torch.Tensor             # () or (*batch,) logical length
    backend: str = "auto"              # "auto" | "reference" | "cuda" | "mesh"

    @property
    def n(self) -> int:
        return self.data.shape[-1]

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return tuple(self.data.shape[:-1])

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def _with(self, **kw) -> "CPMArray":
        return dataclasses.replace(self, **kw)

    def _b(self, op: str):
        return backends.resolve(self.backend, op, self.data)

    def _ul(self) -> torch.Tensor:
        return asarray(self.used_len, torch.int32, self.device)

    def _live(self) -> torch.Tensor:
        ul = self._ul()
        addr = torch.arange(self.n, dtype=torch.int32, device=self.device)
        return addr < (ul[..., None] if ul.ndim else ul)

    # -- activate (Rule 4) ----------------------------------------------
    @recordable("activate")
    def activate(self, start, end, carry=1) -> torch.Tensor:
        """General-decoder activation mask over the PE address axis."""
        return self._b("activate").activate(self.n, start, end, carry,
                                            device=self.device)

    # -- move (§4) ------------------------------------------------------
    @recordable("shift")
    def shift(self, start, end, shift: int = 1, fill=None) -> "CPMArray":
        """Concurrent range move; ``used_len`` is unchanged."""
        return self._with(data=self._b("shift").shift_range(
            self.data, start, end, shift, fill))

    @recordable("insert")
    def insert(self, pos, values) -> "CPMArray":
        """Range shift + broadcast write; ``used_len`` grows (clipped to
        ``n``)."""
        values = asarray(values, self.dtype, self.device)
        k = values.shape[-1]
        ul = self._ul()
        shifted = self._b("insert").shift_range(self.data, pos, ul - 1, k,
                                                None)
        return self._with(data=movable.write_window(shifted, pos, values),
                          used_len=torch.clamp(ul + k, max=self.n))

    @recordable("delete")
    def delete(self, pos, k: int, fill=0) -> "CPMArray":
        """Delete ``k`` items at ``pos``: the tail shifts left, vacated
        slots take ``fill``, ``used_len`` shrinks."""
        ul = self._ul()
        shifted = self._b("delete").shift_range(
            self.data, asarray(pos, device=self.device) + k, ul - 1, -k,
            None)
        data = movable.fill_deleted_tail(shifted, ul, k,
                                         asarray(fill, self.dtype))
        return self._with(data=data, used_len=torch.clamp(ul - k, min=0))

    @recordable("truncate")
    def truncate(self, new_len) -> "CPMArray":
        """Range delete at the tail: lengths only, O(1)."""
        new_len = asarray(new_len, torch.int32, self.device)
        return self._with(used_len=torch.minimum(self._ul(), new_len))

    # -- search (§5) ----------------------------------------------------
    @recordable("substring_match")
    def substring_match(self, needle, where: str = "start") -> torch.Tensor:
        """Match-start (canonical) or match-end flags of ``needle`` in the
        used region (~M steps)."""
        needle = asarray(needle, self.dtype, self.device)
        ends = self._b("substring_match").substring_match(self.data, needle)
        ends = ends & self._live()
        if where == "end":
            return ends
        if where != "start":
            raise ValueError(f"where must be 'start' or 'end', got {where!r}")
        return semantics.ends_to_starts(ends, needle.shape[-1])

    @recordable("find_all")
    def find_all(self, needle, max_out: int):
        """Start addresses of every occurrence in the used region
        (ascending), via Rule 6: ``(indices, valid)`` of shape
        ``(*batch, max_out)``; unused slots hold ``n``."""
        starts = self.substring_match(needle, where="start")
        return pe_array.enumerate_matches(starts, max_out)

    # -- compare (§6) ---------------------------------------------------
    @recordable("compare")
    def compare(self, datum, op: str = "eq", mask=None) -> torch.Tensor:
        """One concurrent compare against a broadcast datum, tail masked;
        mixed dtypes promote, never truncate."""
        if mask is not None:
            x = self.data & mask
            d = asarray(datum, self.dtype, self.device) & mask
        else:
            d = asarray(datum, device=self.device)
            ct = torch.promote_types(self.dtype, d.dtype)
            x, d = self.data.to(ct), d.to(ct)
        return self._b("compare").compare(x, d, op) & self._live()

    @recordable("count")
    def count(self, datum, op: str = "eq", mask=None) -> torch.Tensor:
        """Rule-6 parallel count of matching PEs."""
        return pe_array.count_matches(self.compare(datum, op, mask))

    @recordable("histogram")
    def histogram(self, edges) -> torch.Tensor:
        """Per-row M-bin histogram of the used region (~M+1 compare+count
        steps) -> ``(*batch, M)`` int32; rows and edges promote to one
        dtype, tail lanes take the top edge (counted in no bin).  Batched
        layouts are one backend call."""
        edges = asarray(edges, device=self.device)
        ct = torch.promote_types(self.dtype, edges.dtype)
        x, e = self.data.to(ct), edges.to(ct)
        x = torch.where(self._live(), x, e[-1])
        return self._b("histogram").histogram(x, e)

    # -- compute (§7) ---------------------------------------------------
    def _masked(self, fill) -> torch.Tensor:
        return torch.where(self._live(), self.data,
                           asarray(fill, self.dtype, self.device))

    @recordable("section_sum")
    def section_sum(self, section: int | None = None) -> torch.Tensor:
        """Two-phase per-row sum of the used region (§7.4, ~2·sqrt(N)
        steps); batched layouts reduce in ONE backend call."""
        return self._b("section_sum").section_sum(self._masked(0), section)

    @recordable("global_limit")
    def global_limit(self, mode: str = "max",
                     section: int | None = None) -> torch.Tensor:
        """Two-phase per-row max/min of the used region (§7.5); the tail
        takes the reduction's identity."""
        fill = semantics.limit_identity(self.dtype, mode)
        return self._b("global_limit").global_limit(self._masked(fill),
                                                    mode, section)

    @recordable("super_sum")
    def super_sum(self, section: int | None = None) -> torch.Tensor:
        """§8 super-connected per-row sum: log-depth trees in both phases
        (~2·log2(n)+1 steps); the value of :meth:`section_sum`, bit for
        bit for integer rows."""
        return self._b("super_sum").super_sum(self._masked(0), section)

    @recordable("super_limit")
    def super_limit(self, mode: str = "max",
                    section: int | None = None) -> torch.Tensor:
        """§8 super-connected per-row max / min (log-depth phases)."""
        fill = semantics.limit_identity(self.dtype, mode)
        return self._b("super_limit").super_limit(self._masked(fill),
                                                  mode, section)

    @recordable("sort")
    def sort(self, steps: int | None = None, fill=0) -> "CPMArray":
        """Ascending sort of the used prefix of every row; tail slots take
        ``fill``.  ``steps`` bounds the odd-even exchange cycles (``None``
        sorts fully); dead lanes enter the sort as the dtype's max (``inf``
        for floats and bool)."""
        big = (float("inf") if self.dtype.is_floating_point
               or self.dtype == torch.bool else torch.iinfo(self.dtype).max)
        live = self._live()
        x = torch.where(live, self.data, asarray(big, self.dtype,
                                                 self.device))
        out = self._b("sort").sort(x, steps)
        return self._with(data=torch.where(
            live, out, asarray(fill, self.dtype, self.device)))

    @recordable("template_match")
    def template_match(self, template, mask_tail: bool = True):
        """SAD of an M-item template at every start address; with
        ``mask_tail`` starts whose window runs past ``used_len`` are +inf."""
        template = asarray(template, device=self.device)
        out = self._b("template_match").template_match(self.data, template)
        if mask_tail:
            out = semantics.mask_window_tail(out, template.shape[-1],
                                             self._ul())
        return out

    @recordable("stencil")
    def stencil(self, taps, wrap: bool = False) -> torch.Tensor:
        """§7.3 tap stencil: zero-padded used region, or with ``wrap`` the
        ring over the whole physical buffer."""
        if wrap:
            return self._b("stencil").stencil(self.data, taps, wrap=True)
        x = torch.where(self._live(), self.data,
                        torch.zeros((), dtype=self.dtype, device=self.device))
        return self._b("stencil").stencil(x, taps, wrap=False)

    # -- pack (§4.2) ----------------------------------------------------
    @recordable("compact")
    def compact(self, keep, fill=0) -> "CPMArray":
        """Stable §4.2 pack: flagged items inside the used region move to
        the front in order, vacated slots take ``fill``, ``used_len``
        becomes the survivor count."""
        keep = asarray(keep, torch.bool, self.device) & self._live()
        data, new_len = self._b("compact").compact(
            self.data, keep, asarray(fill, self.dtype, self.device))
        return self._with(data=data, used_len=new_len)

    # -- introspection --------------------------------------------------
    def steps_report(self, *, needle_len: int = 8, bins: int = 8,
                     template_len: int = 8, taps_len: int = 3,
                     section: int | None = None) -> dict[str, int]:
        """Concurrent-step count of every registered op at this array's
        size, from the op table (each checked against its paper bound)."""
        m_of = {"substring_match": needle_len, "histogram": bins,
                "template_match": template_len, "stencil": taps_len}
        return {name: op_steps(name, n=self.n, m=m_of.get(name, 0),
                               section=section)
                for name in OP_TABLE}


def cpm_array(data, used_len=None, backend: str = "auto",
              device=None) -> CPMArray:
    """Canonical constructor: ``used_len`` defaults to the physical
    length; Python and NumPy data land on ``device`` (``cuda`` unless
    asked otherwise)."""
    if not isinstance(data, torch.Tensor):
        from repro_torch import resolve_device
        data = asarray(data, device=resolve_device(device))
    if used_len is None:
        used_len = data.shape[-1]
    return CPMArray(data, asarray(used_len, torch.int32, data.device),
                    backend)
