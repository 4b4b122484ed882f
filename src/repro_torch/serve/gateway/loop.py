"""The continuous engine step loop (a port of
``repro.serve.gateway.loop``).

One ``tick`` is the gateway's heartbeat over the session pool:

  1. **preempt** — the policy (``Preemptor``) parks LRU incumbents if a
     fresh burst is queued beyond the free slots or pages;
  2. **step** — ``SessionPool.step()``: batched admission (restores +
     prompt-length buckets), one decode chunk across every live page,
     retirement;
  3. **collect** — finished Sessions (with their ``first_admit_step`` and
     ``parks`` history, which the gateway's SLO accounting reads) move
     into the delivery buffer.

Each heartbeat returns a :class:`TickReport`: what the tick *did*
(per-tick deltas) next to where the pool *is* (the stats snapshot);
``report["key"]`` falls through to the snapshot.  The loop is
synchronous and deterministic — virtual time is the pool's
``decode_steps`` — so tests drive it tick by tick; the asyncio front door
(``gateway.api``) wraps it.  Every tick records a ``gateway.tick`` span
(wall + virtual clock) through :mod:`repro_torch.obs.tracing`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

from repro_torch.obs import tracing as obs_tracing


@dataclasses.dataclass(frozen=True)
class TickReport:
    """What one heartbeat did, and where the pool stands after it.

    Schema (all counts are sessions unless noted):

    ==============  =========================================================
    field           meaning
    ==============  =========================================================
    tick            0-based index of this heartbeat
    step            pool virtual decode-step clock AFTER the tick
    admitted        fresh sessions seated this tick (stacked prefill)
    restored        parked sessions re-seated this tick (no prefill)
    preempted       sessions parked this tick (policy + page stalls)
    finished        sessions retired into the delivery buffer this tick
    emitted         tokens emitted this tick (prefill + decode), all rows
    chunk_wall_s    wall seconds dispatching this tick's decode chunk
                    (0.0 when no chunk ran; dispatch only — the loop
                    never forces a device sync)
    wall_s          wall seconds of the whole tick (preempt+step+collect)
    active          sessions decoding after the tick
    waiting         fresh sessions still queued after the tick
    parked          preempted sessions queued after the tick
    pages_free      free sub-pages across all banks after the tick
    stats           the full :meth:`SessionPool.stats` snapshot (dict)
    ==============  =========================================================

    ``report[key]`` reads any field by name and falls through to
    ``stats`` for every other pool-stats key (``report["preemptions"]``).
    """

    tick: int
    step: int
    admitted: int
    restored: int
    preempted: int
    finished: int
    emitted: int
    chunk_wall_s: float
    wall_s: float
    active: int
    waiting: int
    parked: int
    pages_free: int
    stats: dict = dataclasses.field(default_factory=dict, repr=False)

    def __getitem__(self, key: str):
        if key != "stats" and key in self.__dataclass_fields__:
            return getattr(self, key)
        return self.stats[key]

    def get(self, key: str, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


class EngineLoop:
    def __init__(self, pool, preemptor=None):
        self.pool = pool
        self.preemptor = preemptor
        self.ticks = 0
        self._finished: dict[int, Any] = {}   # sid -> Session, undelivered

    def tick(self) -> TickReport:
        """One heartbeat: preempt -> step -> collect.  Returns the
        :class:`TickReport` (deltas + snapshot) for this tick."""
        pool = self.pool
        before = {k: getattr(pool, k)
                  for k in ("admits", "restores", "preemptions",
                            "total_emitted")}
        done_before = len(self._finished)
        t0 = time.perf_counter()
        with obs_tracing.span("gateway.tick", cat="gateway",
                              vclock=pool._vclock,
                              args={"tick": self.ticks}):
            if self.preemptor is not None:
                self.preemptor.maybe_preempt()
            stats = pool.step()
            self._finished.update(
                pool.table.collect_finished_sessions())
        report = TickReport(
            tick=self.ticks,
            step=pool.decode_steps,
            admitted=pool.admits - before["admits"],
            restored=pool.restores - before["restores"],
            preempted=pool.preemptions - before["preemptions"],
            finished=len(self._finished) - done_before,
            emitted=pool.total_emitted - before["total_emitted"],
            chunk_wall_s=pool.last_chunk_s,
            wall_s=time.perf_counter() - t0,
            active=stats["active"],
            waiting=stats["waiting"],
            parked=stats["parked"],
            pages_free=stats["pages_free"],
            stats=stats,
        )
        self.ticks += 1
        return report

    def pending(self) -> bool:
        """True while any submitted session still needs ticks."""
        return not self.pool.table.all_done()

    def take_finished(self) -> dict[int, Any]:
        """Finished Sessions since the last take (delivery is
        exactly-once; the buffer empties)."""
        done, self._finished = self._finished, {}
        return done

    def run_until_idle(self, max_ticks: int = 100_000) -> dict[int, Any]:
        """Drive ticks until every session is done (tests/benchmarks);
        returns every finished Session collected along the way."""
        out: dict[int, Any] = {}
        for _ in range(max_ticks):
            if not self.pending():
                break
            self.tick()
            out.update(self.take_finished())
        else:
            raise RuntimeError(f"no convergence in {max_ticks} ticks")
        out.update(self.take_finished())
        return out
