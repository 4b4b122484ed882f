"""repro_torch.cpm.pool — paged multi-tenant CPM banks (a port of
``repro.cpm.pool``).

Fixed-shape banks of sub-pages (:class:`CPMBank`), a page-table
allocator whose free-list and victim searches are CPM ops on a metadata
device (:class:`SlotAllocator`), and a MASIM-style scheduler
(:class:`MultiBankScheduler`) that packs per-session instruction streams
into ONE batched fused launch per bank.  Host-side session lifecycle
lives in :class:`SessionTable`.  The serving integration is
``repro_torch.serve.session_pool``.
"""

from .allocator import FREE, USED, OracleAllocator, SlotAllocator
from .bank import CPMBank
from .scheduler import MultiBankScheduler, packed_commit
from .sessions import ACTIVE, DONE, PARKED, WAITING, Session, SessionTable

__all__ = [
    "CPMBank",
    "SlotAllocator", "OracleAllocator", "FREE", "USED",
    "MultiBankScheduler", "packed_commit",
    "SessionTable", "Session", "WAITING", "ACTIVE", "PARKED", "DONE",
]
