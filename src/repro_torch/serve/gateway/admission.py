"""Batched admission planning: arrivals -> prefill buckets (a port of
``repro.serve.gateway.admission``; plain Python in both packages).

Admission is the pool's only per-session-cost path — every fresh session
pays a prefill launch.  Under bursty traffic that cost is the difference
between an O(arrivals) and an O(arrival-batches) front door (MASIM's
point about keeping the banks saturated from the host loop,
arXiv:2412.02218).  The planner groups one step's FIFO admission window:

  * **fresh** sessions bucket by prompt length — each bucket prefills as
    ONE stacked launch and scatters with ONE program;
  * **parked** sessions (preempted earlier, sub-pages saved host-side)
    form restore groups — no prefill at all, just a batched page re-seat.
    Groups bucket by *saved page count*: the restore program stacks the
    whole group's page images, so only sessions with the same number of
    live sub-pages can share one launch (under the degenerate whole-row
    layout every parked session saves one page, so this reduces to the
    old single restore group).

Pure host-side planning over Session objects; the pool executes the plan
(``SessionPool._admit_bucket`` / ``_restore_group``).  With
``batching=False`` every group has exactly one member — the strict
one-at-a-time FIFO baseline.
"""

from __future__ import annotations

import dataclasses

from repro_torch.cpm.pool.sessions import PARKED, Session


@dataclasses.dataclass(frozen=True)
class AdmissionPlan:
    """One step's admission work, grouped for batched execution."""
    buckets: tuple[tuple[Session, ...], ...]   # fresh, same prompt_len each
    restores: tuple[tuple[Session, ...], ...]  # parked, no prefill needed

    @property
    def sessions(self) -> int:
        return (sum(len(b) for b in self.buckets)
                + sum(len(g) for g in self.restores))

    @property
    def launches(self) -> int:
        """Prefill launches this plan pays (restores pay none)."""
        return len(self.buckets)


def plan(sessions: list[Session], batching: bool = True) -> AdmissionPlan:
    """Group an admission window (FIFO order preserved inside every
    group).  Every planned session is admitted in the same ``step``, so
    inter-group order carries no fairness weight."""
    fresh_by_len: dict[int, list[Session]] = {}
    parked_by_pages: dict[int, list[Session]] = {}
    parked: list[Session] = []
    for s in sessions:
        if s.phase == PARKED:
            parked.append(s)
            n_pages = s.parked.n_pages if s.parked is not None else 0
            parked_by_pages.setdefault(n_pages, []).append(s)
        else:
            fresh_by_len.setdefault(s.prompt_len, []).append(s)
    if batching:
        buckets = tuple(tuple(b) for b in fresh_by_len.values())
        restores = tuple(tuple(g) for g in parked_by_pages.values())
    else:                                   # strict arrival order, one each
        buckets = tuple((s,) for s in sessions if s.phase != PARKED)
        restores = tuple((s,) for s in parked)
    return AdmissionPlan(buckets=buckets, restores=restores)
