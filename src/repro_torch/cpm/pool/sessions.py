"""Host-side session registry for the pool: lifecycle, placement, FIFO
(a port of ``repro.cpm.pool.sessions``; plain Python in both packages).

Sessions are the pool's unit of admission: a prompt plus a token budget,
moving ``WAITING -> ACTIVE -> DONE`` — with a ``PARKED`` detour when the
serving gateway preempts an active session (its pages are saved to a
host-side parking buffer and the session re-queues FIFO for a later
restore; see ``repro_torch.serve.gateway.preempt``).  The table is
deliberately plain Python — placement decisions are host decisions —
while everything the sessions *own* (token pages, KV rows, slot metadata) lives device-side
in the banks and the allocator.  The table never touches device memory
(a parked session's page image is held by the session object, not the
table).
"""

from __future__ import annotations

import dataclasses
from typing import Any

WAITING = "waiting"
ACTIVE = "active"
PARKED = "parked"
DONE = "done"


@dataclasses.dataclass
class Session:
    sid: int
    prompt: Any                        # (s,) int32 tokens (device or host)
    prompt_len: int
    budget: int                        # max new tokens (incl. the prefill one)
    phase: str = WAITING
    bank: int = -1                     # placement, valid while ACTIVE
    slot: int = -1                     # global slot id
    emitted: int = 0
    tokens: Any = None                 # final (s + emitted,) output when DONE
    gen: Any = None                    # per-request GenConfig (sampling params)
    parked: Any = None                 # host PageState while PARKED
    parks: int = 0                     # times preempted
    admit_step: int = -1               # pool.decode_steps at last (re-)admission
    first_admit_step: int = -1         # ... at FIRST admission (TTFT anchor)

    @property
    def finished(self) -> bool:
        return self.emitted >= self.budget


class SessionTable:
    """FIFO admission queue + slot-indexed lookup of active sessions."""

    def __init__(self):
        self._sessions: dict[int, Session] = {}
        self._queue: list[int] = []               # WAITING, arrival order
        self._by_slot: dict[int, int] = {}        # global slot -> sid
        self._next = 0

    def __len__(self):
        return len(self._sessions)

    def add(self, prompt, prompt_len: int, budget: int) -> Session:
        s = Session(self._next, prompt, prompt_len, budget)
        self._next += 1
        self._sessions[s.sid] = s
        self._queue.append(s.sid)
        return s

    def get(self, sid: int) -> Session:
        return self._sessions[sid]

    def next_waiting(self) -> Session | None:
        return self._sessions[self._queue[0]] if self._queue else None

    def peek_waiting(self, k: int) -> list[Session]:
        """First ``k`` queued sessions in FIFO order (WAITING and PARKED
        interleaved as they arrived / were parked) — the admission
        planner's window."""
        return [self._sessions[sid] for sid in self._queue[:k]]

    def activate(self, sid: int, bank: int, slot: int) -> Session:
        s = self._sessions[sid]
        assert s.phase in (WAITING, PARKED), \
            f"session {sid} is {s.phase}, not admissible"
        assert sid in self._queue, f"session {sid} is not queued"
        self._queue.remove(sid)
        s.phase, s.bank, s.slot = ACTIVE, bank, slot
        self._by_slot[slot] = sid
        return s

    def park(self, sid: int) -> Session:
        """ACTIVE -> PARKED: the session loses its slot and re-queues at
        the tail (so fresh arrivals admit first — the natural anti-thrash
        ordering).  The caller owns the page save/free."""
        s = self._sessions[sid]
        assert s.phase == ACTIVE, f"session {sid} is {s.phase}, not active"
        del self._by_slot[s.slot]
        s.phase, s.bank, s.slot = PARKED, -1, -1
        self._queue.append(sid)
        return s

    def at_slot(self, slot: int) -> Session | None:
        sid = self._by_slot.get(slot)
        return self._sessions[sid] if sid is not None else None

    def finish(self, sid: int, tokens) -> Session:
        s = self._sessions[sid]
        if s.phase == ACTIVE:
            del self._by_slot[s.slot]
        elif s.phase in (WAITING, PARKED):        # cancellation path
            self._queue.remove(sid)
        s.phase, s.tokens = DONE, tokens
        s.parked = None
        return s

    def active(self) -> list[Session]:
        return [self._sessions[sid] for sid in sorted(self._by_slot.values())]

    def waiting_count(self) -> int:
        return len(self._queue)

    def active_count(self) -> int:
        return len(self._by_slot)

    def all_done(self) -> bool:
        return not self._queue and not self._by_slot

    def outputs(self) -> dict[int, Any]:
        """Non-destructive view of every DONE session's tokens."""
        return {sid: s.tokens for sid, s in self._sessions.items()
                if s.phase == DONE}

    def collect_finished(self) -> dict[int, Any]:
        """Outputs of sessions finished since the last collection; the
        collected sessions are evicted from the table, so a long-running
        service's memory stays bounded and a later collection never
        re-delivers an old result."""
        return {sid: s.tokens
                for sid, s in self.collect_finished_sessions().items()}

    def collect_finished_sessions(self) -> dict[int, Session]:
        """Like :meth:`collect_finished` but hands back the whole popped
        Session — the gateway needs the admission/preemption history
        (``first_admit_step``, ``parks``) for its SLO accounting, not just
        the tokens."""
        done = [sid for sid, s in self._sessions.items() if s.phase == DONE]
        return {sid: self._sessions.pop(sid) for sid in done}

    def parked_count(self) -> int:
        return sum(1 for sid in self._queue
                   if self._sessions[sid].phase == PARKED)
