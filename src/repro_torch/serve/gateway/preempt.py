"""LRU preemption policy over one SessionPool (a port of
``repro.serve.gateway.preempt``).

When a burst arrives beyond ``slots``, the choice is FIFO queueing (fresh
requests wait out the longest incumbent — p99 TTFT explodes) or
preemption: park the least-recently-admitted incumbent's pages host-side
(``SessionPool.park``) and give its slot to the burst.  The victim comes
from the already-proven CPM machinery — ``SlotAllocator.victim()`` runs
§7.5 ``global_limit("min")`` over allocation ticks on the metadata
device — so "who is LRU" is itself a concurrent-memory query, not a host
scan.

This module is the *policy*; the mechanism (page save/restore, FIFO
re-queue, token-identical continuation) is the pool's.  Guards keep the
policy from thrashing:

  * only **fresh** WAITING arrivals justify eviction — a parked session
    never evicts anyone (it re-queues at the FIFO tail instead);
  * a victim must have been resident ``min_resident`` decode steps since
    its last (re-)admission;
  * sessions within ``min_remaining`` tokens of finishing are cheaper to
    let drain than to park;
  * ``max_parks`` bounds how often one session can be preempted
    (starvation guard).

The loop is conservative: the allocator names exactly one LRU candidate
per query, and if that candidate is protected the whole round stops —
better to queue a burst briefly than to churn pages.
"""

from __future__ import annotations

import dataclasses

from repro_torch.cpm.pool.sessions import WAITING
from repro_torch.obs import metrics as obs_metrics

# policy-level accounting, labeled by the pool the policy governs (the
# mechanism's parks are the pool's own repro_pool_preemptions_total)
_PREEMPT_FAMILIES = {
    "preempted": obs_metrics.counter(
        "repro_preempt_evicted_total",
        "LRU victims parked by the policy", ("pool",)),
    "denied": obs_metrics.counter(
        "repro_preempt_denied_total",
        "preemption rounds stopped by a protected LRU candidate",
        ("pool",)),
}


@dataclasses.dataclass(frozen=True)
class PreemptConfig:
    min_resident: int = 2      # decode steps between (re-)admission and eviction
    min_remaining: int = 2     # don't park sessions about to finish
    max_parks: int = 3         # per-session preemption cap


class Preemptor:
    preempted = obs_metrics.series_property("preempted")
    denied = obs_metrics.series_property("denied")

    def __init__(self, pool, cfg: PreemptConfig | None = None):
        self.pool = pool
        self.cfg = cfg if cfg is not None else PreemptConfig()
        self._obs_series = {
            k: fam.labels(pool=pool._pool_label)
            for k, fam in _PREEMPT_FAMILIES.items()}

    def _protected(self, sess) -> bool:
        cfg, pool = self.cfg, self.pool
        return (pool.decode_steps - sess.admit_step < cfg.min_resident
                or sess.budget - sess.emitted <= cfg.min_remaining
                or sess.parks >= cfg.max_parks)

    def maybe_preempt(self) -> int:
        """Park LRU victims until every fresh arrival could be seated (or
        the LRU candidate is protected).  Returns how many were parked.

        Seating is two-resource under the paged layout: a fresh session
        needs a slot AND its admission page grant.  Pressure on *either*
        resource justifies eviction — a parked victim frees both its slot
        and its whole page list at once (under the degenerate whole-row
        layout pages and slots are one-to-one, so the two deficits
        coincide and this reduces to the old slot-only policy)."""
        pool = self.pool
        window = pool.table.peek_waiting(pool.table.waiting_count())
        fresh = [s for s in window if s.phase == WAITING]
        want = len(fresh) - pool._free_hint
        want_pages = (sum(pool._grant0(s.prompt_len) for s in fresh)
                      - pool.alloc.page_free_count())
        parked = 0
        while want > 0 or want_pages > 0:
            sess = pool.victim_session()
            if sess is None or sess.finished:
                break                       # nothing evictable right now
            if self._protected(sess):
                self.denied += 1
                break                       # LRU is protected: stop, don't churn
            held = len(pool.alloc.pages(sess.slot))
            pool.park(sess.sid)
            self.preempted += 1
            parked += 1
            want -= 1
            want_pages -= held
        return parked
