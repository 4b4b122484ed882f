"""`CPMBank` — one fixed-shape array of CPM sub-pages (a port of
``repro.cpm.pool.bank``).

A bank is the pool's unit of physical residency: a batched ``(slots,
width)`` :class:`~repro_torch.cpm.array.CPMArray` whose rows are
*sub-pages* handed out by the allocator and whose per-row ``used_len``
registers are the §4.2 length state.  Under the serving pool's paged
layout the rows are ``(pages_per_bank, page_size)`` sub-pages: a
session's logical token row is its ordered page list's rows
concatenated.  The bank owns the buffers; callers take transient
``CPMArray`` views (:meth:`device`) and write results back with
:meth:`update`.

Sub-pages move through the paged-row kernels
(:func:`repro_torch.kernels.cpm_kernels.gather_rows` / ``scatter_rows``,
``csrc/rows.cu``) on a ``cuda`` bank — the place of the JAX package's
``pallas`` bank — and through their plain twins on ``reference``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cpm_kernels as K

from ..array import CPMArray


class CPMBank:
    """A ``(slots, width)`` bank of pages with per-page length registers."""

    def __init__(self, slots: int, width: int, dtype=torch.int32,
                 backend: str = "reference", device="cpu"):
        if slots <= 0 or width <= 0:
            raise ValueError(f"bank needs slots>0, width>0; got "
                             f"({slots}, {width})")
        if backend not in ("reference", "cuda"):
            raise ValueError(f"bank backend must be 'reference' or 'cuda', "
                             f"got {backend!r}")
        self.slots = slots
        self.width = width
        self.backend = backend
        self.data = torch.zeros((slots, width), dtype=dtype, device=device)
        self.lens = torch.zeros((slots,), dtype=torch.int32, device=device)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    # -- CPMArray views -----------------------------------------------------
    def device(self) -> CPMArray:
        """The bank as a batched CPM device (for program execution)."""
        return CPMArray(self.data, self.lens, self.backend)

    def update(self, arr: CPMArray) -> None:
        """Adopt the state a program run left behind."""
        if tuple(arr.data.shape) != (self.slots, self.width):
            raise ValueError(f"bank is {(self.slots, self.width)}, "
                             f"got {tuple(arr.data.shape)}")
        self.data = arr.data
        self.lens = torch.as_tensor(arr.used_len, dtype=torch.int32,
                                    device=self.data.device) \
            .expand(self.slots).contiguous()

    # -- single-page access ---------------------------------------------------
    def write_row(self, slot: int, values, length=None) -> None:
        """Place a page: ``values`` (padded to ``width``) becomes row
        ``slot`` and its length register ``length`` (default: the value
        count).  The whole row is replaced, so a previous tenant's content
        cannot leak past the new ``used_len``."""
        values = torch.as_tensor(values).to(self.data.device,
                                            self.dtype).reshape(-1)
        k = values.shape[0]
        if k > self.width:
            raise ValueError(f"row of {k} items exceeds bank width "
                             f"{self.width}")
        row = torch.zeros((1, self.width), dtype=self.dtype,
                          device=self.data.device)
        row[0, :k] = values
        dev = self.data.device
        self.scatter(torch.tensor([slot], dtype=torch.int32, device=dev), row,
                     torch.tensor([k if length is None else length],
                                  dtype=torch.int32, device=dev))

    def read_row(self, slot: int):
        """One page out (host copy): ``(row (width,) numpy, used length)``."""
        idx = torch.tensor([slot], dtype=torch.int32, device=self.data.device)
        return self.gather(idx)[0].cpu().numpy(), int(self.lens[slot])

    def clear_row(self, slot: int) -> None:
        self.write_row(slot, torch.zeros((0,), dtype=self.dtype), 0)

    # -- paged movement -------------------------------------------------------
    def gather(self, idx):
        """Rows at ``idx`` (K,) int32 -> (K, width): one ``gather_rows``
        launch on a cuda bank, its plain twin on reference."""
        if self.backend == "cuda":
            return K.gather_rows(self.data, idx.to(torch.int32).contiguous())
        return K.gather_rows_plain(self.data, idx)

    def scatter(self, idx, rows, lens) -> None:
        """Write ``rows`` (K, width) into pages ``idx`` (K unique ids) and
        set their length registers to ``lens`` (K,); ids ``>= slots``
        drop."""
        idx = idx.to(torch.int32).contiguous()
        rows = rows.to(self.dtype).contiguous()
        if self.backend == "cuda":
            self.data = K.scatter_rows(self.data, idx, rows)
        else:
            self.data = K.scatter_rows_plain(self.data, idx, rows)
        self.lens = K.scatter_rows_plain(
            self.lens[:, None], idx, lens.to(torch.int32)[:, None])[:, 0]
