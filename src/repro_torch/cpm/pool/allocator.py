"""The self-managing page-table allocator: CPM bookkeeping for CPM banks
(a port of ``repro.cpm.pool.allocator``).

Slot metadata (state code, last-use tick) and the sub-page state file
live in ``CPMArray`` devices, and every query is a paper op —

  * free-slot lookup   = §6.1 broadcast ``compare(FREE)`` + Rule-6
                         priority-encoder drain (``enumerate_matches``);
  * LRU victim lookup  = §7.5 ``global_limit("min")`` over the masked tick
                         file, then one more compare to address the holder;
  * occupancy counters = §6 compare + Rule-6 ``count``;
  * reclamation        = §4.2 ``compact`` packing the used slot ids.

Writes (alloc/free/touch) are single-address writes into the metadata
tensors.  The host only ever sees slot and page *numbers*.

``backend`` routes the queries like any other ``CPMArray``, and
``device`` holds the metadata: by default the ``reference`` backend on
the CPU — what the session pool uses, as in the JAX package, since every
answer is a host decision (admission control) and metadata on the card
would cost a device round trip per query and stall behind the decode
chunk in flight — or ``backend="cuda"`` with the metadata on the card,
where every query is a ``compare``, ``section_limit`` or ``compact``
kernel launch (the LRU victim's compare reads the limit on the device).
``device="cpu"`` with ``backend="cuda"`` runs the kernels' plain twins.
:class:`OracleAllocator` is a pure-Python allocator with identical
semantics for the tests.
"""

from __future__ import annotations

import torch

from ..array import CPMArray
from ..reference import pe_array

FREE = 0
USED = 1

_NO_TICK = torch.iinfo(torch.int32).max


class SlotAllocator:
    """Page-table allocator over ``n_slots`` sessions of one pool, plus an
    optional file of ``n_pages`` *sub-pages* with per-session page lists.

    :meth:`alloc_pages` claims the ``k`` lowest free pages of a bank's
    range in ONE §6.1 broadcast compare + Rule-6 drain
    (``enumerate_matches(max_out=k)``), all-or-nothing; the ordered page
    list rides on the owning slot and :meth:`free` releases slot and
    pages together, so a retire or cancel can never leak a sub-page.
    """

    def __init__(self, n_slots: int, backend: str = "reference",
                 n_pages: int = 0, device=None):
        if n_slots <= 0:
            raise ValueError(f"n_slots must be positive, got {n_slots}")
        if n_pages < 0:
            raise ValueError(f"n_pages must be >= 0, got {n_pages}")
        self.n_slots = n_slots
        self.n_pages = n_pages
        self._backend = backend
        if device is None:                     # see the module docstring
            device = "cuda" if backend == "cuda" else "cpu"
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"SlotAllocator(backend={backend!r}) puts "
                               f"its metadata on {self.device}, and no "
                               f"CUDA device is available; pass "
                               f"device='cpu' for the plain twins")
        i32 = dict(dtype=torch.int32, device=self.device)
        self._state = torch.full((n_slots,), FREE, **i32)
        self._tick = torch.zeros((n_slots,), **i32)
        self._clock = 0
        # sub-page metadata file + host mirror of the ordered page lists
        self._pstate = torch.full((max(n_pages, 1),), FREE, **i32)
        self._pids = torch.arange(max(n_pages, 1), **i32)
        # the used_len registers of the two files (whole files, made once)
        self._slots_len = torch.tensor(n_slots, **i32)
        self._pages_len = torch.tensor(n_pages, **i32)
        self._pages: dict[int, list[int]] = {}

    # -- CPMArray views of the metadata file --------------------------------
    def _dev(self, data) -> CPMArray:
        return CPMArray(data, self._slots_len, self._backend)

    def _pdev(self, data) -> CPMArray:
        return CPMArray(data, self._pages_len, self._backend)

    # -- queries (all CPM ops) ----------------------------------------------
    def free_count(self) -> int:
        return int(self._dev(self._state).count(FREE))

    def used_count(self) -> int:
        return int(self._dev(self._state).count(USED))

    def is_free(self, slot: int) -> bool:
        self._check(slot)
        return int(self._state[slot]) == FREE

    def alloc(self) -> int | None:
        """Claim the lowest free slot, or ``None`` when the pool is full:
        one §6.1 broadcast compare, then the Rule-6 drain of the lowest
        asserted address."""
        flags = self._dev(self._state).compare(FREE)
        addrs, valid = pe_array.enumerate_matches(flags, max_out=1)
        if not bool(valid[0]):
            return None
        slot = int(addrs[0])
        self._state[slot] = USED
        self._pages[slot] = []
        self.touch(slot)
        return slot

    # -- sub-page file (CPM ops on the page metadata device) ----------------
    def _prange(self, lo: int, hi: int | None) -> tuple[int, int]:
        hi = self.n_pages if hi is None else hi
        if not 0 <= lo <= hi <= self.n_pages:
            raise IndexError(f"page range [{lo}, {hi}) outside "
                             f"[0, {self.n_pages})")
        return lo, hi

    def _free_in(self, lo: int, hi: int):
        flags = self._pdev(self._pstate).compare(FREE)
        return flags & (self._pids >= lo) & (self._pids < hi)

    def page_free_count(self, lo: int = 0, hi: int | None = None) -> int:
        """Free sub-pages within ``[lo, hi)`` (a bank's range): one §6
        broadcast compare, Rule-6 count of the masked match lines."""
        if not self.n_pages:
            return 0
        lo, hi = self._prange(lo, hi)
        return int(pe_array.count_matches(self._free_in(lo, hi)))

    def alloc_pages(self, slot: int, k: int, lo: int = 0,
                    hi: int | None = None) -> list[int] | None:
        """Grow ``slot``'s page list by the ``k`` lowest free sub-pages in
        ``[lo, hi)``, or ``None`` (nothing claimed) when fewer than ``k``
        are free — all-or-nothing, so a top-up either covers the next
        chunk or parks the session.  One range-masked §6.1
        ``compare(FREE)``, one Rule-6 drain (``enumerate_matches``)."""
        self._check(slot)
        if int(self._state[slot]) != USED:
            raise ValueError(f"slot {slot} is free; pages need an owner")
        if k <= 0:
            raise ValueError(f"page count must be positive, got {k}")
        lo, hi = self._prange(lo, hi)
        addrs, valid = pe_array.enumerate_matches(self._free_in(lo, hi),
                                                  max_out=k)
        if not bool(valid.all()):
            return None
        got = [int(a) for a in addrs.tolist()]
        self._pstate[addrs.long()] = USED
        self._pages.setdefault(slot, []).extend(got)
        return got

    def pages(self, slot: int) -> list[int]:
        """``slot``'s ordered page list (logical rank -> sub-page id)."""
        self._check(slot)
        return list(self._pages.get(slot, []))

    def victim(self) -> int | None:
        """The least-recently-used *used* slot (LRU eviction candidate):
        §7.5 ``global_limit("min")`` over the tick file (free slots masked
        to the identity), then one compare to address the minimum's
        holder.  ``None`` when nothing is allocated."""
        used = self._dev(self._state).compare(USED)
        if not bool(pe_array.any_match(used)):
            return None
        masked = torch.where(used, self._tick, _NO_TICK)
        oldest = self._dev(masked).global_limit("min")
        hits = self._dev(masked).compare(oldest)
        addrs, _ = pe_array.enumerate_matches(hits & used, max_out=1)
        return int(addrs[0])

    def used_slots(self) -> list[int]:
        """Used slot ids packed to the front — the §4.2 ``compact`` of the
        slot-id file under the used flags."""
        used = self._dev(self._state).compare(USED)
        ids = self._dev(torch.arange(self.n_slots, dtype=torch.int32,
                                     device=self.device))
        packed = ids.compact(used, fill=-1)
        k = int(packed.used_len)
        return [int(v) for v in packed.data[:k].tolist()]

    # -- transitions (single-address writes) --------------------------------
    def free(self, slot: int) -> None:
        """Release ``slot`` AND its whole page list — retire, cancel and
        park all come through here, so sub-pages cannot leak."""
        self._check(slot)
        if int(self._state[slot]) != USED:
            raise ValueError(f"double free of slot {slot}")
        self._state[slot] = FREE
        held = self._pages.pop(slot, [])
        if held:
            self._pstate[torch.tensor(held, dtype=torch.long,
                                      device=self.device)] = FREE

    def touch(self, slot: int) -> None:
        """Stamp ``slot`` as most recently used (LRU bookkeeping)."""
        self._check(slot)
        self._clock += 1
        self._tick[slot] = self._clock

    def _check(self, slot: int) -> None:
        if not 0 <= slot < self.n_slots:
            raise IndexError(f"slot {slot} out of range [0, {self.n_slots})")

    # -- test hooks ---------------------------------------------------------
    def state_vector(self):
        return self._state.cpu().numpy()

    def page_state_vector(self):
        return self._pstate[:self.n_pages].cpu().numpy()


class OracleAllocator:
    """Naive host-side allocator with identical semantics — the tests'
    differential oracle (no CPM ops, just Python)."""

    def __init__(self, n_slots: int, n_pages: int = 0):
        self.n_slots = n_slots
        self.n_pages = n_pages
        self.used: dict[int, int] = {}               # slot -> last-use tick
        self.page_lists: dict[int, list[int]] = {}   # slot -> ordered pages
        self.page_owner: dict[int, int] = {}         # page -> slot
        self._clock = 0

    def alloc(self) -> int | None:
        for s in range(self.n_slots):
            if s not in self.used:
                self._clock += 1
                self.used[s] = self._clock
                self.page_lists[s] = []
                return s
        return None

    def free(self, slot: int) -> None:
        del self.used[slot]
        for p in self.page_lists.pop(slot, []):
            del self.page_owner[p]

    def touch(self, slot: int) -> None:
        self._clock += 1
        self.used[slot] = self._clock

    def victim(self) -> int | None:
        if not self.used:
            return None
        oldest = min(self.used.values())
        return min(s for s, t in self.used.items() if t == oldest)

    def free_count(self) -> int:
        return self.n_slots - len(self.used)

    def used_slots(self) -> list[int]:
        return sorted(self.used)

    def alloc_pages(self, slot: int, k: int, lo: int = 0,
                    hi: int | None = None) -> list[int] | None:
        hi = self.n_pages if hi is None else hi
        got = [p for p in range(lo, hi) if p not in self.page_owner][:k]
        if len(got) < k:
            return None
        for p in got:
            self.page_owner[p] = slot
        self.page_lists.setdefault(slot, []).extend(got)
        return got

    def pages(self, slot: int) -> list[int]:
        return list(self.page_lists.get(slot, []))

    def page_free_count(self, lo: int = 0, hi: int | None = None) -> int:
        hi = self.n_pages if hi is None else hi
        return sum(1 for p in range(lo, hi) if p not in self.page_owner)
